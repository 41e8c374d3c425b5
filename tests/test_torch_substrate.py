"""Substrate of the PyTorch port against the JAX package's: the mirrored
buffer and the engine registry.  Tolerance: none — exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysimpleraytracing_tpu.core.buffer import DataBuffer as JDataBuffer
from unitysimpleraytracing_tpu.ops import registry as jregistry
from unitysimpleraytracing_tpu_torch.core.buffer import DataBuffer
from unitysimpleraytracing_tpu_torch.ops import registry

from _torch_common import CPU, assert_same_bits, both_scenes, n_, t_


def test_databuffer_fill_and_roundtrip():
    # Sentinel pre-fill (MeshBufferContainer.cs:108: keys = uint.MaxValue).
    buf, jbuf = DataBuffer(16, np.uint32, initial_value=0xFFFFFFFF, device=CPU), \
        JDataBuffer(16, np.uint32, initial_value=0xFFFFFFFF)
    assert buf[3] == jbuf[3] == 0xFFFFFFFF
    buf[0:4] = [1, 2, 3, 4]
    jbuf[0:4] = [1, 2, 3, 4]
    dev = buf.device_array  # sync() upload
    assert isinstance(dev, torch.Tensor) and dev.device.type == CPU
    np.testing.assert_array_equal(n_(dev), np.asarray(jbuf.device_array))
    assert (buf.count, buf.shape, buf.dtype, len(buf)) == (16, (16,), np.uint32, 16)
    assert repr(buf) == repr(jbuf)


def test_databuffer_mirror_and_tensor_never_share_memory():
    buf = DataBuffer(8, np.int64, shape_suffix=(3,), device=CPU)
    dev = buf.device_array
    buf[2] = 7  # a host write must not reach the uploaded tensor
    assert int(dev[2, 0]) == 0
    assert int(buf.device_array[2, 0]) == 7  # until the next sync
    out = torch.arange(24, dtype=torch.int64).reshape(8, 3)
    buf.assign_device(out)
    buf[0] = -1  # folds the download in first, then writes the mirror only
    assert int(out[0, 0]) == 0 and buf[7, 2] == 23


def test_databuffer_lazy_download_after_device_assign():
    buf, jbuf = DataBuffer(8, np.float32, device=CPU), JDataBuffer(8, np.float32)
    buf.assign_device(torch.arange(8, dtype=torch.float32) * 2)
    jbuf.assign_device(jnp.arange(8, dtype=jnp.float32) * 2)
    assert "device-dirty" in repr(buf)
    # Indexer triggers the lazy download (DataBuffer.cs:32-48 semantics).
    assert buf[3] == jbuf[3] == 6.0
    buf[3] = -1.0
    jbuf[3] = -1.0
    assert_same_bits(buf.device_array, jbuf.device_array)


def test_databuffer_shape_guard():
    buf = DataBuffer(8, np.float32, device=CPU)
    with pytest.raises(ValueError):
        buf.assign_device(torch.zeros(4))


def test_databuffer_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise here")
    with pytest.raises(RuntimeError, match="CUDA"):
        DataBuffer(8)


def test_registry_lists_what_the_port_runs():
    assert registry.stages() == ["scan", "sort", "topology", "traverse"]
    assert registry.engines("sort") == ["cuda", "radix", "torch"]
    assert registry.engines("scan") == ["cuda", "torch"]
    assert registry.engines("traverse") == [
        "cuda2", "cuda4", "packet", "perray", "plain2", "plain4"]
    assert registry.engines("topology") == ["karras", "sah"]
    with pytest.raises(KeyError, match="available"):
        registry.get("sort", "nope")


def test_registry_register_as_decorator_and_directly():
    @registry.register("test_stage", "a")
    def a():
        return "a"

    registry.register("test_stage", "b", lambda: "b")
    try:
        assert registry.engines("test_stage") == ["a", "b"]
        assert registry.get("test_stage", "a")() == "a" and registry.get("test_stage", "b")() == "b"
    finally:
        del registry._REGISTRY["test_stage"]


@pytest.mark.parametrize("name", ["torch", "radix", "cuda"])
def test_registry_sort_engines_agree_with_jax(name):
    rng = np.random.default_rng(0)
    k = rng.integers(0, 1 << 30, size=2048).astype(np.uint32)
    v = np.arange(2048, dtype=np.int32)
    want = jregistry.get("sort", "xla")(jnp.asarray(k), jnp.asarray(v))
    got = registry.get("sort", name)(t_(k.astype(np.int64)), t_(v))
    assert_same_bits(got[0], want[0], "keys")
    assert_same_bits(got[1], want[1], "values")


@pytest.mark.parametrize("name", ["torch", "cuda"])
def test_registry_scan_engines_agree_with_jax(name):
    x = np.random.default_rng(1).integers(0, 1024, size=3000).astype(np.int32)
    want = jregistry.get("scan", "xla")(jnp.asarray(x))
    assert_same_bits(registry.get("scan", name)(t_(x)), want, "scan")


def test_registry_topology_and_traverse_engines_are_the_pipeline_s():
    from unitysimpleraytracing_tpu_torch.ops import lbvh, trace, trace_bvh4

    assert registry.get("topology", "karras") is lbvh.build_bvh_from_sorted
    assert registry.get("traverse", "perray") is trace.traverse
    assert registry.get("traverse", "plain4") is trace_bvh4.traverse_bvh4_plain
    assert registry.get("traverse", "cuda4") is trace_bvh4.traverse_bvh4
    _, ps = both_scenes("cube")
    assert ps.count == 12
