"""The binary-record walk of ``csrc/trace_bvh2.cu`` as the kernel runs it, on
the CPU.

The kernel cannot run here, so its loop is mirrored by a scalar numpy walk,
one ray at a time, with the kernel's float32 operations in the kernel's
order: both slab tests at the running t of the pop, the leaf children tested
in place, left then right, and the internal children pushed far then near,
with the near one kept in a register as the record popped next instead of
going through the stack.  The mirror is
held to `traverse_bvh2_plain` (the push-all walk the card's kernel is held
to) bit for bit in t, tri, u, v and in the records popped per ray; its stack
overflows exactly where the push-all walk's does.  Small scenes only.
"""
import os

import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu_torch.core.camera import generate_rays
from unitysimpleraytracing_tpu_torch.ops import dispatch
from unitysimpleraytracing_tpu_torch.ops import trace_bvh2 as pt2

F32 = np.float32
STACK_DEPTH = 64
IDX_BITS = 20
IDX_MASK = (1 << IDX_BITS) - 1


def decode_metas(lmeta, rmeta):
    """The kernel's meta decode: the float32 metas are exact integers below
    2^23.  Returns (left id, right id, left is a leaf, right is a leaf, split
    axis)."""
    lm, rm = int(lmeta), int(rmeta)
    return (lm & IDX_MASK, rm & IDX_MASK, (lm >> IDX_BITS) == 1,
            (rm >> IDX_BITS) & 1 == 1, rm >> (IDX_BITS + 1))


def slab(b, o, inv, t):
    t1 = [(b[a] - o[a]) * inv[a] for a in range(3)]
    t2 = [(b[3 + a] - o[a]) * inv[a] for a in range(3)]
    lo = [np.fmin(t1[a], t2[a]) for a in range(3)]
    hi = [np.fmax(t1[a], t2[a]) for a in range(3)]
    tmin = np.fmax(lo[0], np.fmax(lo[1], lo[2]))
    tmax = np.fmin(hi[0], np.fmin(hi[1], hi[2]))
    return bool((tmax > tmin) and (tmax > 0) and (tmin < t))


def leaf_test(vt, o, d, tid, best):
    """Moller-Trumbore on one leaf child's nine vertex floats; ``best`` =
    [t, tri, u, v] is updated when the hit is accepted and nearer."""
    ax, ay, az = vt[0], vt[1], vt[2]
    e1x, e1y, e1z = vt[3] - ax, vt[4] - ay, vt[5] - az
    e2x, e2y, e2z = vt[6] - ax, vt[7] - ay, vt[8] - az
    ox, oy, oz = o
    dx, dy, dz = d
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = F32(1.0) / det
    tvx, tvy, tvz = ox - ax, oy - ay, oz - az
    uu = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    tn = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    reject = ((det < F32(1e-8)) and (det > F32(-1e-8))) or (uu < 0 or uu > 1) \
        or (vv < 0 or uu + vv > 1)
    if not reject and tn < best[0]:
        best[:] = [tn, tid, uu, vv]


def walk_one_ray(table, o, d, t_init, thr):
    """One ray through the kernel's loop.  Returns (t, tri, u, v, records
    popped); raises OverflowError where the kernel traps."""
    inv = [F32(1.0) / d[a] for a in range(3)]
    near = [bool(d[a] > 0) for a in range(3)]   # "left is near" on an axis
    best = [F32(t_init), 0, F32(0.0), F32(0.0)]
    stack = []
    k, steps = 0, 0
    while True:
        steps += 1
        rec = table[k]
        li, ri, lleaf, rleaf, axis = decode_metas(rec[12], rec[13])
        hit_l = slab(rec[0:6], o, inv, best[0])
        hit_r = slab(rec[6:12], o, inv, best[0])
        if hit_l and lleaf:
            leaf_test(rec[14:23], o, d, li, best)
        if hit_r and rleaf:
            leaf_test(rec[23:32], o, d, ri, best)
        if thr > 0 and best[0] < thr:
            best[0] = F32(0.0)
            break
        push_l, push_r = hit_l and not lleaf, hit_r and not rleaf
        if len(stack) + push_l + push_r > STACK_DEPTH:   # the push-all walk's test
            raise OverflowError("traversal stack overflow")
        l_near = near[axis]
        if push_l and push_r:
            stack.append(ri if l_near else li)
            k = li if l_near else ri
        elif push_l:
            k = li
        elif push_r:
            k = ri
        elif stack:
            k = stack.pop()
        else:
            break
    return best[0], best[1], best[2], best[3], steps


def walk(table, o, d, t_init=None, thr=None):
    tab = table.numpy()
    o, d = o.numpy(), d.numpy()
    n = o.shape[0]
    t0 = np.full(n, np.finfo(np.float32).max, np.float32) if t_init is None else t_init.numpy()
    th = np.zeros(n, np.float32) if thr is None else thr.numpy()
    out = {f: np.zeros(n, dt) for f, dt in (("t", np.float32), ("tri", np.int32),
                                             ("u", np.float32), ("v", np.float32),
                                             ("steps", np.int32))}
    with np.errstate(all="ignore"):
        for r in range(n):
            res = walk_one_ray(tab, o[r], d[r], t0[r], th[r])
            for f, x in zip(("t", "tri", "u", "v", "steps"), res):
                out[f][r] = x
    return out


def _scene(name):
    if name == "terrain":
        scene = pt.build_scene(pt.terrain_mesh(res=14, size=12.0, amplitude=2.5, seed=3),
                               device="cpu")
        cam = pt.make_camera(eye=(9.0, 7.0, 11.0), target=(0.0, 0.0, 0.0), width=32,
                             height=32, device="cpu")
        o, d = generate_rays(cam)
        o = dispatch._tile_major(o, 32, 32, 32).contiguous()
        d = dispatch._tile_major(d, 32, 32, 32).contiguous()
    else:
        scene = pt.build_scene(pt.random_triangle_soup(160, seed=5, bound=4.0, tri_size=1.2),
                               device="cpu")
        rng = np.random.default_rng(11)
        o = rng.uniform(-6.0, 6.0, size=(384, 3)).astype(np.float32)
        dn = rng.normal(size=(384, 3)).astype(np.float32)
        dn /= np.linalg.norm(dn, axis=1, keepdims=True)
        o, d = torch.from_numpy(o), torch.from_numpy(dn)
    return scene, o, d


@pytest.mark.parametrize("mode", ["nearest", "t_init_above", "t_init_below", "anyhit"])
@pytest.mark.parametrize("scene_name, builder", [("terrain", None), ("soup", "karras")])
def test_mirror_of_the_kernel_loop_equals_the_plain_walk(scene_name, builder, mode):
    """Bit for bit in t, tri, u, v and in records popped per ray."""
    scene, o, d = _scene(scene_name)
    table = pt2.prepare_tables(scene, pt.build_bvh(scene, builder=builder))
    first = pt2.traverse_bvh2_plain(table, o, d)
    assert bool(first.hit.any()) and not bool(first.hit.all())
    t_init = thr = None
    if mode.startswith("t_init"):
        eps = 0.01 * torch.clamp(first.t.abs(), min=1.0)
        sign = 1.0 if mode == "t_init_above" else -1.0
        t_init = torch.where(first.hit, first.t + sign * eps, torch.finfo(torch.float32).max)
    elif mode == "anyhit":
        # Thresholds on either side of the first hits, and 0 (off) on a third.
        rng = np.random.default_rng(2)
        thr = torch.from_numpy(rng.uniform(0.5, 20.0, size=o.shape[0]).astype(np.float32))
        thr[::3] = 0.0
    want, steps = pt2.traverse_bvh2_plain(table, o, d, t_init=t_init, anyhit_thresh=thr,
                                          count_steps=True)
    got = walk(table, o, d, t_init, thr)
    for f in ("t", "u", "v"):
        np.testing.assert_array_equal(got[f].view(np.uint32),
                                      getattr(want, f).numpy().view(np.uint32), err_msg=f)
    np.testing.assert_array_equal(got["tri"], want.tri.numpy())
    np.testing.assert_array_equal(got["steps"], steps.numpy())
    if mode == "anyhit":
        assert 0 < int((want.t == 0).sum()) < o.shape[0]
    if mode == "t_init_below":
        assert bool((want.t <= t_init).all())   # never undercut


def _chain_table(n):
    """Records 0..n-1 each with two internal children that every ray below
    enters: the left one is the next record of the chain, the right one
    record n, whose two boxes no ray enters.  Split axis x, so a ray going
    +x takes the left child first and leaves record n on the stack."""
    table = np.zeros((n + 1, 32), np.float32)
    box = [-10.0, -10.0, -10.0, 10.0, 10.0, 10.0]
    for i in range(n):
        table[i, 0:6] = box
        table[i, 6:12] = box
        table[i, 12] = i + 1
        table[i, 13] = n
    table[n, 0:6] = [50.0, -51.0, 50.0, 51.0, -50.0, 51.0]
    table[n, 6:12] = [50.0, -51.0, 50.0, 51.0, -50.0, 51.0]
    return torch.from_numpy(table)


@pytest.mark.parametrize("chain, overflows", [(63, False), (64, True)])
def test_register_held_record_overflows_where_the_push_all_walk_does(chain, overflows):
    """With the near child kept in a register the stack holds one entry less
    than the push-all walk's, so the overflow test stays that walk's: a chain
    of 64 records, each pushing two, needs 65 entries there, and traps."""
    table = _chain_table(chain)
    d = np.asarray([[1.0, 0.1, 0.1]], np.float32)
    d /= np.linalg.norm(d)
    o = torch.zeros((1, 3))
    if overflows:
        with pytest.raises(OverflowError):
            walk(table, o, torch.from_numpy(d))
        deep = _chain_table(80)   # the plain walk checks its depth every few steps
        with pytest.raises(RuntimeError, match="overflow"):
            pt2.traverse_bvh2_plain(deep, o, torch.from_numpy(d))
    else:
        got = walk(table, o, torch.from_numpy(d))
        want, steps = pt2.traverse_bvh2_plain(table, o, torch.from_numpy(d), count_steps=True)
        assert got["steps"][0] == int(steps[0]) == 2 * chain + 1
        assert got["t"][0] == want.t[0] and want.t[0] == np.finfo(np.float32).max


def test_kernel_ab_times_k2_and_reports_its_registers():
    from unitysimpleraytracing_tpu_torch.benchmarks import kernel_ab

    assert "k2" in kernel_ab.CASES and "k2_vs_k1" in kernel_ab.CASES
    assert set(kernel_ab.PTXAS) == {"trace_bvh4", "trace_bvh2", "scan"}
    with pytest.raises(ValueError, match="unknown cases"):
        kernel_ab.main(["--cases", "k2,k9"])


def test_kernel2_note_states_what_bounds_it():
    from unitysimpleraytracing_tpu_torch.utils import kernel_build

    text = open(os.path.join(kernel_build.CSRC_DIR, "trace_bvh2.cu"), encoding="utf-8").read()
    head = " ".join(text[:text.index("#include")].replace("//", "").split())
    assert "Replaces the TPU kernel ops/trace_pallas.py::_make_kernel" in head
    assert "What bounds it" in head and "chain of dependent steps" in head
    assert "latency bound on the L2/HBM path" not in head
    # The register-held next record, the push-all walk's overflow test, the
    # four 16-byte leaf loads of slots 16-31.
    for needed in ("__trap()", "k = stack[--sp]", "sp + (int)push_l + (int)push_r > STACK_DEPTH",
                   "__ldg(rec + 4)", "__ldg(rec + 7)"):
        assert needed in text, needed
    assert "#if" not in text
    note = pt2.__doc__
    assert "benchmarks/kernel_ab.py" in note and "0.30 ms" not in note
