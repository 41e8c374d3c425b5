"""Debug print/probe helpers.

Counterpart of ``unitysimpleraytracing_tpu/utils/debug.py``, same names.
Analog of the reference's ``Utils.ArrayToString`` dump helper
(``Assets/_Scripts/_utils/Utils.cs:8-31``, capped at 4096 elements) and its
throwaway probe harnesses (``_debugComputeShaderTester.cs:16-27``): small
tools for eyeballing device tensors and probing kernels during development.
Tensors on any device and numpy arrays print alike: a tensor is read back to
the host first, so the text is what the JAX package prints for the same
values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def array_to_string(arr, limit: int = 4096) -> str:
    """Space-joined dump of up to ``limit`` elements (Utils.cs:13's cap)."""
    a = _host(arr).ravel()
    body = " ".join(str(x) for x in a[:limit])
    return body + (" …" if a.size > limit else "")


def dump(name: str, arr, limit: int = 64) -> None:
    a = _host(arr)
    print(f"{name}: shape={a.shape} dtype={a.dtype} [{array_to_string(a, limit)}]")


def _to_numpy(x, in_dataclass: bool = False):
    """Tensors become numpy arrays through dataclass fields, tuples, lists and
    dicts (the port's containers are dataclasses, not pytrees), each after
    its device has finished.  A dataclass keeps its type and its plain fields
    (``count``); any other leaf becomes an array, as
    ``jax.tree_util.tree_map(np.asarray, ...)`` makes it."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _to_numpy(getattr(x, f.name), in_dataclass=True)
            for f in dataclasses.fields(x) if f.init
        })
    if isinstance(x, (tuple, list)):
        return type(x)(_to_numpy(item) for item in x)
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x if in_dataclass else np.asarray(x)


def probe_kernel(fn, *args):
    """Dispatch-and-read-back probe (the _debugComputeShaderTester pattern):
    run ``fn`` (an op or a kernel wrapper), wait for every device its
    outputs live on, and return the outputs as numpy."""
    return _to_numpy(fn(*args))
