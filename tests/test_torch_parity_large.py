"""The port held to the JAX package at its three largest sizes, under the
crack, occlusion and frame rules of ``utils/parity`` (bounds unchanged):

- **1m**: the 1,048,352-triangle single tree (chip_smoke.py's
  ``main_path_1m``: terrain res=725, size 300, amplitude 30, seed 0; camera
  at (210, 170, 260), 512x512; each package's default tree, shadows).  No
  binary records here: 1,048,352 triangles padded to 1024 is one past their
  20-bit triangle ids, so only K1's plain version (``plain4``) is held.
- **config5_chunked**: the bench's config-5 chunked row (``benchmarks/bench.py``:
  terrain res=708, size 300, amplitude 30, seed 0; 999,698 triangles in 7
  ``"sah"`` chunks; the 1m camera): partition, chunk trees and tables
  bit-identical, ``render_hits_chunked`` and the chunked frame with shadows.
- **4m_chunked**: chip_smoke.py's ``chunked_path`` (terrain res=1449, size
  600, amplitude 60, seed 3; 4,193,408 triangles in 26 chunks; camera at
  (420, 340, 520), 1920x1056): SHA-256s of the partition and the tables,
  and every 4th row and column of the frame (126,720 of its 2,027,520
  rays, `parity.frame_subset`) through ``trace_chunked`` and their shadow
  rays through ``occluded_chunked``, both packages on the same rays.
- **config5_dist**: ``benchmarks/dist_path.py``'s config 5 (terrain res=708,
  size 80, amplitude 9, seed 0; ``config5_rays(4096)``): the JAX engines at
  (dp, tp) = (2, 4) on the 8-device CPU mesh and JAX's single Karras tree,
  against the port's engines on an 8-rank gloo group
  (``tests/_torch_dist_worker.py``, suite ``vs_jax_large``) and its single
  tree; JAX's single tree also on the first 65,536 rays of the
  1,048,576-ray batch.

JAX's answers are stored in ``tests/golden/torch_{name}_jax.npz`` with the
SHA-256 of each scene's mesh positions.  Tier-1 runs the cheap part: each
fixture decodes with its ray counts, and each mesh digest equals the port's
``terrain_mesh``.  The rest builds trees of a million triangles or more on
the CPU and is ``slow`` (``-m slow``; about 40 minutes on 8 cores).  JAX runs
its own CPU engine, the port its plain versions on every CPU thread.

The pinned lists below were measured on an 8-core x86 CPU (numpy 2.0.2,
torch 2.13.0+cpu, jax 0.9.0).  Chunks are traced near-first in both
packages, so an id flip between two chunks at an exact-t tie is a tie of
the crack rule (``tie_rays``), not a divergent ray.

``XLA_FLAGS=--xla_force_host_platform_device_count=8 PYTHONPATH=.
JAX_PLATFORMS=cpu python tests/test_torch_parity_large.py [1m
config5_chunked 4m_chunked config5_dist]`` writes the fixtures anew from the
JAX package.
"""
import contextlib
import functools
import os
import sys
import time
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
import unitysimpleraytracing_tpu_torch as pt
from unitysimpleraytracing_tpu.ops import dispatch as jdispatch
from unitysimpleraytracing_tpu.ops import trace_pallas4 as jt4
from unitysimpleraytracing_tpu.parallel import dist as jdist
from unitysimpleraytracing_tpu.pipeline import chunked as jchunked
from unitysimpleraytracing_tpu_torch.benchmarks.dist_path import config5_rays
from unitysimpleraytracing_tpu_torch.core.camera import generate_rays
from unitysimpleraytracing_tpu_torch.ops import dispatch as pdispatch
from unitysimpleraytracing_tpu_torch.ops import trace_bvh4 as pt4
from unitysimpleraytracing_tpu_torch.pipeline import chunked as pchunked
from unitysimpleraytracing_tpu_torch.utils import parity
from unitysimpleraytracing_tpu_torch.utils.parity import (
    MAX_FLOAT, assert_hit_parity_at_scale, assert_occlusion_parity_at_scale, bits_digest,
    encode_hits, frame_subset, frame_to_uint8, load_hit_fixture, partition_digest,
)

import test_torch_parity_frame as pf
from _torch_common import CPU, assert_fields_same_bits, assert_same_bits, n_, t_
from _torch_dist_worker import assemble, run_ranks
from test_torch_parity_scale import _BVH_FIELDS, CONFIG_1M

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
NAMES = ("1m", "config5_chunked", "4m_chunked", "config5_dist")
FIXTURES = {name: os.path.join(GOLDEN, f"torch_{name}_jax.npz") for name in NAMES}

_CAM_1M = CONFIG_1M[1]
# name -> (terrain_mesh kwargs, make_camera kwargs, chunks, every step-th row
# and column of the frame (None: the whole frame, with its shadowed frame))
CHUNKED = {
    "config5_chunked": ({"res": 708, "size": 300.0, "amplitude": 30.0, "seed": 0}, _CAM_1M,
                        7, None),
    "4m_chunked": ({"res": 1449, "size": 600.0, "amplitude": 60.0, "seed": 3},
                   {"eye": (420.0, 340.0, 520.0), "target": (0.0, 0.0, 0.0), "width": 1920,
                    "height": 1056, "fov_deg": 60.0}, 26, 4),
}
DIST_MESH = {"res": 708, "size": 80.0, "amplitude": 9.0, "seed": 0}
DIST_RAYS, BATCH, BATCH_HEAD = 4096, 1 << 20, 65536
ENGINES = ("sharded", "ring", "shuffle")
MESHES = {"1m": CONFIG_1M[0], **{k: v[0] for k, v in CHUNKED.items()},
          "config5_dist": DIST_MESH}
TRIANGLES = {"1m": 1048352, "config5_chunked": 999698, "4m_chunked": 4193408,
             "config5_dist": 999698}
# Each fixture's answers: prefix -> rays.
ANSWERS = {
    "1m": {"": 512 * 512},
    "config5_chunked": {"": 512 * 512},
    "4m_chunked": {"": 264 * 480},
    "config5_dist": {**{f"{k}.": DIST_RAYS for k in ("single",) + ENGINES},
                     "batch_head.": BATCH_HEAD},
}


@contextlib.contextmanager
def _cpu_threads():
    """The port's plain walks on every CPU thread (the suite runs one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count())
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def all_threads():
    with _cpu_threads():
        yield


# ---- Tier-1: the fixtures decode, and describe the port's geometry ----------

@pytest.mark.parametrize("name", NAMES)
def test_fixture_decodes_with_its_ray_counts(name):
    for prefix, rays in ANSWERS[name].items():
        mask, tri, shadow = load_hit_fixture(FIXTURES[name], prefix)
        assert mask.shape == tri.shape == (rays,), (prefix, mask.shape)
        assert 0 < mask.sum() < rays and tri.min() >= 0 and tri.max() < TRIANGLES[name]
        assert (tri[~mask] == 0).all()
        if name != "config5_dist":
            assert shadow is not None and not (shadow & ~mask).any()
    with np.load(FIXTURES[name]) as z:
        if name in ("1m", "config5_chunked"):
            assert z["frame_u8"].shape == (512, 512, 4)
        if name in CHUNKED:
            assert len(str(z["partition_sha256"])) == len(str(z["tables_sha256"])) == 64


@pytest.mark.parametrize("name", NAMES)
def test_mesh_digest_equals_the_ports(name):
    mesh = pt.terrain_mesh(**MESHES[name])
    assert mesh.num_triangles == TRIANGLES[name]
    with np.load(FIXTURES[name]) as z:
        assert bits_digest(mesh.positions) == str(z["mesh_sha256"])


def test_frame_subset_is_every_fourth_row_and_column():
    rows = frame_subset(1920, 1056, 4)
    assert rows.size == 126720 and rows[:2].tolist() == [0, 4]
    assert rows[480] == 4 * 1920 and rows[-1] == 1052 * 1920 + 1916


def test_fixtures_stay_under_one_megabyte():
    assert sum(os.path.getsize(FIXTURES[n]) for n in NAMES) < 1 << 20


# ---- shared pieces ------------------------------------------------------------

def _hits_np(h):
    return SimpleNamespace(**{f: n_(getattr(h, f)) for f in ("t", "tri", "u", "v")})


def _real_triangles(scene):
    t = scene.triangles
    return tuple(n_(x)[:scene.count] for x in (t.a, t.b, t.c))


def _fixture_equals_jax(name, want):
    with np.load(FIXTURES[name]) as z:
        assert sorted(z.files) == sorted(want), (sorted(z.files), sorted(want))
        for k, v in want.items():
            parity.assert_bits_equal(z[k], v, k)


def _mesh_digest(name):
    return np.str_(bits_digest(rt.terrain_mesh(**MESHES[name]).positions))


# ---- A: the 1,048,352-triangle single tree -------------------------------------

# Through test_torch_parity_frame's helpers on its config "1m": `_jax`
# (render_hits, JAX's own shadow mask and rays, render_frame with shadows),
# `_port` (plain4), `_shared_rule` and `frame_rules`.
# Six cracks, each within its edge bound of an edge two triangles share:
# float64 with the port on five (106,308 through the triangle across the
# edge), with JAX on 142,748; six exact-t tie flips.  Shadow flags on each
# side's own rays: five at the segment's end, two (114,694, 128,483) where
# each side equals float64 on its own ray; on shared rays five, all at the
# segment's end.  The default trees: four nodes whose two splits cost the
# same within 1e-5, 36 more rows of the tree arrays inside their subtrees,
# and 19 BVH4 records.
PINS_1M = {"divergent": [64180, 92992, 106308, 109476, 139177, 142748], "tie_rays": 6,
           "shared_shadow": [114694, 118851, 127972, 129505, 149372],
           "own_shadow": [114694, 115724, 118851, 122922, 127972, 128483, 147429],
           "beyond_1": [64180, 92992, 106308, 109476, 122953, 139177, 142748, 153827],
           "default_tree_rows": [85106, 85110, 85111, 85112, 85113, 85115, *range(865474, 865488),
                                 888226, 888230, *range(888232, 888236), *range(952068, 952082)],
           "default_table_rows": [40713, 40724, 40725, 40726, 429122, 429123, 429126, 440496,
                                  440498, 440499, *range(473308, 473317)],
           "split_flips": [85106, 865474, 888226, 952081]}


def _split_costs(bvh, scene, nodes):
    """Float64 SAH cost of each internal node's split in ``bvh``: the half
    area of each child's box (its refit box, or a leaf's triangle box)
    times its leaf count, summed over the two children."""
    f = {k: n_(getattr(bvh, k)) for k in ("left", "right", "left_is_leaf", "right_is_leaf",
                                          "range_first", "range_last", "sorted_tri",
                                          "node_aabb_min", "node_aabb_max")}
    amin, amax = n_(scene.aabb_min), n_(scene.aabb_max)

    def side(child, leaf):
        tri = f["sorted_tri"][child]
        lo = np.where(leaf[:, None], amin[tri], f["node_aabb_min"][child]).astype(np.float64)
        hi = np.where(leaf[:, None], amax[tri], f["node_aabb_max"][child]).astype(np.float64)
        e = hi - lo
        n = np.where(leaf, 1, f["range_last"][child] - f["range_first"][child] + 1)
        return (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]) * n

    return (side(f["left"][nodes], f["left_is_leaf"][nodes])
            + side(f["right"][nodes], f["right_is_leaf"][nodes]))


def assert_near_equal_splits(pb, ps, jb, js):
    """Two SAH trees (sweep or free-order) over the same leaves that differ
    only where a node's two candidate splits cost the same within 1e-5 (the
    SAH costs are float32 operations: `ops/sah.py`).  Every internal node whose split
    differs over the same leaf range is such a node, and every other
    differing internal node lies inside one.  Returns those nodes."""
    keys = ("left", "right", "range_first", "range_last")
    p, j = ({k: n_(getattr(b, k)).astype(np.int64) for k in keys} for b in (pb, jb))
    differ = np.flatnonzero(np.any([p[k] != j[k] for k in keys], axis=0)[:pb.count - 1])
    same_range = (p["range_first"][differ] == j["range_first"][differ]) & (
        p["range_last"][differ] == j["range_last"][differ])
    flips = differ[same_range & (p["left"][differ] != j["left"][differ])]
    cost_p, cost_j = _split_costs(pb, ps, flips), _split_costs(jb, js, flips)
    rel = np.abs(cost_p - cost_j) / cost_j
    assert (rel <= 1e-5).all(), dict(zip(flips.tolist(), rel.tolist()))
    inside = [any(j["range_first"][f] <= j["range_first"][x] and j["range_last"][x]
                  <= j["range_last"][f] for f in flips) for x in differ]
    assert all(inside), differ[~np.asarray(inside)].tolist()
    return flips.tolist()


def _fixture_1m():
    return {**pf._frame_fixture("1m"), "mesh_sha256": _mesh_digest("1m")}


@pytest.mark.slow
@pytest.mark.usefixtures("all_threads")
class TestOneMillionTriangles:
    def test_trees_and_tables(self):
        """Karras trees and tables bit-identical; the default (free-order
        SAH) trees differ only in the rows pinned here."""
        j, p = pf._jax("1m"), pf._port("1m")
        assert p.scene.count == 1048352
        assert_same_bits(p.scene.morton, j.scene.morton, "morton")
        pk, jk = pt.build_bvh(p.scene, builder="karras"), rt.build_bvh(j.scene, builder="karras")
        for f in _BVH_FIELDS:
            assert_same_bits(getattr(pk, f), getattr(jk, f), f"karras {f}")
        assert_same_bits(pt4.prepare_tables4(p.scene, pk),
                         jt4.prepare_tables4(j.scene, jk, pack=1), "karras BVH4 table")
        rows = set()
        for f in _BVH_FIELDS:
            g = n_(getattr(p.bvh, f))
            w = n_(getattr(j.bvh, f)).astype(g.dtype)
            rows |= set(np.flatnonzero((g != w).reshape(len(g), -1).any(axis=1)).tolist())
        assert sorted(rows) == PINS_1M["default_tree_rows"], sorted(rows)
        assert assert_near_equal_splits(p.bvh, p.scene, j.bvh, j.scene) == PINS_1M["split_flips"]
        t4 = n_(pt4.prepare_tables4(p.scene, p.bvh))
        j4 = n_(jt4.prepare_tables4(j.scene, j.bvh, pack=1))
        assert t4.shape == j4.shape
        assert np.flatnonzero((t4 != j4).any(axis=1)).tolist() == PINS_1M["default_table_rows"]

    def test_shadow_masks_on_shared_rays(self):
        st = pf._shared_rule("1m")
        assert st["rays"] == 512 * 512
        assert st["divergent"] == PINS_1M["shared_shadow"], st

    def test_frames_under_the_frame_rule(self):
        st = pf.frame_rules(pf._jax("1m"), pf._port("1m"))
        assert st.hits["divergent"] == PINS_1M["divergent"], st.hits
        assert len(st.hits["tie_rays"]) == PINS_1M["tie_rays"], st.hits
        assert st.shadow_rays == PINS_1M["own_shadow"], st.occ
        assert st.frame["beyond_1"] == PINS_1M["beyond_1"], st.frame

    def test_fixture_equals_jax(self):
        _fixture_equals_jax("1m", _fixture_1m())


# ---- B: the chunked scenes ------------------------------------------------------

def _row_major_np(x, cam):
    return n_(pdispatch._row_major(t_(n_(x)), cam.height, cam.width, 32))


def _own_frame(mod, scene, cb, cam, tex, bg):
    """``mod.render_frame_chunked(..., shadows=True)`` with its primary hits
    and its shadow rays, flags and origin bound caught on their way
    (``mod``: either package's ``pipeline.chunked``; it calls both through
    its module names).  Returns row-major numpy."""
    seen = {}
    real_hits, real_occ = mod.render_hits_chunked, mod.occluded_chunked

    def hits_spy(*args, **kwargs):
        seen["hits"] = real_hits(*args, **kwargs)
        return seen["hits"]

    def occ_spy(cbvh, origins, dirs, **kwargs):
        seen.update(o=origins, d=dirs, origin_bound=kwargs["origin_bound"])
        seen["occ"] = real_occ(cbvh, origins, dirs, **kwargs)
        return seen["occ"]

    with mock.patch.object(mod, "render_hits_chunked", hits_spy), \
            mock.patch.object(mod, "occluded_chunked", occ_spy):
        frame = mod.render_frame_chunked(scene, cb, cam, tex, bg, shadows=True)
    hits = _hits_np(seen["hits"])
    occ = _row_major_np(seen["occ"], cam)
    return SimpleNamespace(
        hits=hits, shadow=occ & (hits.t != MAX_FLOAT), occ=occ,
        so=_row_major_np(seen["o"], cam), sd=_row_major_np(seen["d"], cam),
        origin_bound=float(n_(seen["origin_bound"])), frame=frame_to_uint8(n_(frame)))


def _port_rays(cam_kw, step):
    o, d = (n_(x) for x in generate_rays(pt.make_camera(**cam_kw, device=CPU)))
    if step is None:
        return o, d
    rows = frame_subset(cam_kw["width"], cam_kw["height"], step)
    return o[rows], d[rows]


@functools.lru_cache(maxsize=None)
def _jax_build(name):
    """JAX's scene, chunked build (``"sah"``) and its digests."""
    scene = rt.build_scene(rt.terrain_mesh(**CHUNKED[name][0]))
    cb = rt.build_bvh_chunked(scene)
    return SimpleNamespace(scene=scene, cb=cb, partition_sha256=partition_digest(cb.sscene),
                           tables_sha256=bits_digest(cb.tables))


@functools.lru_cache(maxsize=None)
def _port_build(name):
    scene = pt.build_scene(pt.terrain_mesh(**CHUNKED[name][0]), device=CPU)
    return SimpleNamespace(scene=scene, cb=pt.build_bvh_chunked(scene))


@functools.lru_cache(maxsize=None)
def _jax_chunked(name):
    """JAX's chunked answers: the whole frame through `render_frame_chunked`
    (`_own_frame`), or, with a step, the subset of the port's primary rays
    through `trace_chunked` and their shadow rays (made by JAX's
    `_shadow_rays_chunked`, outside any jit) through `occluded_chunked`."""
    _, cam_kw, _, step = CHUNKED[name]
    out = SimpleNamespace(**vars(_jax_build(name)))
    scene, cb = out.scene, out.cb
    if step is None:
        cam = rt.make_camera(**cam_kw)
        out.__dict__.update(vars(_own_frame(jchunked, scene, cb, cam, rt.solid_texture(pf.TEX),
                                            pf.BG)))
    else:
        o, d = (jnp.asarray(x) for x in _port_rays(cam_kw, step))
        hits = rt.trace_chunked(cb, o, d)
        so, sd, ob = jchunked._shadow_rays_chunked(cb, hits, o, d)
        occ = n_(rt.occluded_chunked(cb, so, sd, origin_bound=ob))
        out.hits = _hits_np(hits)
        out.so, out.sd, out.origin_bound, out.occ = n_(so), n_(sd), float(ob), occ
        out.shadow = occ & (out.hits.t != MAX_FLOAT)
    return out


@functools.lru_cache(maxsize=None)
def _port_chunked(name):
    """The port's side of `_jax_chunked`, on the CPU (``plain4``): with a
    step, its primary rays and JAX's shadow rays, as JAX traced them."""
    _, cam_kw, _, step = CHUNKED[name]
    out = SimpleNamespace(**vars(_port_build(name)))
    scene, cb = out.scene, out.cb
    out.a, out.b, out.c = _real_triangles(scene)
    out.on, out.dn = _port_rays(cam_kw, step)
    if step is None:
        cam = pt.make_camera(**cam_kw, device=CPU)
        out.__dict__.update(vars(_own_frame(pchunked, scene, cb, cam,
                                            pt.solid_texture(pf.TEX, device=CPU), pf.BG)))
    else:
        j = _jax_chunked(name)
        out.hits = _hits_np(pt.trace_chunked(cb, t_(out.on), t_(out.dn)))
        out.occ = n_(pt.occluded_chunked(cb, t_(j.so), t_(j.sd),
                                         origin_bound=torch.tensor(j.origin_bound)))
    return out


def _chunked_fixture(name):
    j = _jax_chunked(name)
    out = {**encode_hits(j.hits.t != MAX_FLOAT, j.hits.tri, j.shadow),
           "mesh_sha256": _mesh_digest(name), "partition_sha256": np.str_(j.partition_sha256),
           "tables_sha256": np.str_(j.tables_sha256)}
    if CHUNKED[name][3] is None:
        out["frame_u8"] = j.frame
    return out


def _shared_chunked_shadow(name):
    """Both packages' `occluded_chunked` on JAX's own shadow rays (tile-major,
    as the frame traces them) under the occlusion rule."""
    j, p = _jax_chunked(name), _port_chunked(name)
    cam = pt.make_camera(**CHUNKED[name][1], device=CPU)

    def tiled(x):
        return pdispatch._tile_major(t_(x), cam.height, cam.width, 32).contiguous()

    occ = _row_major_np(pt.occluded_chunked(p.cb, tiled(j.so), tiled(j.sd),
                                            origin_bound=torch.tensor(j.origin_bound)), cam)
    return assert_occlusion_parity_at_scale(occ, j.occ, p.a, p.b, p.c, j.so, j.sd,
                                            j.origin_bound)


def _chunk_trees_vs_jax(name):
    """Partition bit-identical; chunk by chunk, the trees differ only at
    near-equal SAH splits (`assert_near_equal_splits`), and the BVH4
    records that differ are listed.  Returns ({chunk: split flips},
    {chunk: table rows that differ})."""
    j, p = _jax_build(name), _port_build(name)
    assert p.cb.num_chunks == j.cb.num_chunks == CHUNKED[name][2]
    assert_fields_same_bits(p.cb.sscene, j.cb.sscene)
    assert partition_digest(p.cb.sscene) == j.partition_sha256
    cap = p.cb.capacity
    assert tuple(p.cb.tables.shape) == tuple(j.cb.tables.shape)
    flips, rows = {}, {}
    for s in range(p.cb.num_chunks):
        f = assert_near_equal_splits(
            pchunked._chunk_bvh(p.cb.bvhs, s, cap), pchunked._chunk_scene(p.cb.sscene, s, cap),
            jchunked._chunk_bvh(j.cb.bvhs, s, cap), jchunked._chunk_scene(j.cb.sscene, s, cap))
        r = np.flatnonzero((n_(p.cb.tables[s]) != n_(j.cb.tables[s])).any(axis=1)).tolist()
        assert bool(f) == bool(r), (s, f, r)
        if f:
            flips[s], rows[s] = f, r
    assert (bits_digest(p.cb.tables) == j.tables_sha256) == (not flips)
    return flips, rows


# Cracks: each within its edge bound of an edge two triangles share, one side
# equal to float64 (the port on 52,481 (across the edge) and 107,266, JAX on
# 115,030); one exact-t tie flip (158,493).  Shadow flags on JAX's own rays:
# 129,992 and 148,859 at the segment's end, 135,584 a crack 2.4e-3 from a
# shared edge; on each side's own rays also 118,190 (at the segment's end).
PINS_CONFIG5_CHUNKED = {"divergent": [52481, 107266, 115030], "tie_rays": 1,
                        "shared_shadow": [129992, 135584, 148859],
                        "own_shadow": [118190, 129992, 135584, 148859],
                        "beyond_1": [52481, 107266, 115030, 158493],
                        # chunk 6: one node whose two splits cost the same
                        # within 1e-5, and the three BVH4 records over it
                        "split_flips": {6: [120969]}, "table_rows": {6: [60442, 60444, 60445]}}
# Positions in the subset of 126,720 rays.  Four cracks (float64 with the
# port on three, with JAX on 42,053), one exact-t tie flip between chunks;
# six shadow flags, every one at the segment's end.
# The chunk trees: 1,918 nodes whose two splits cost the same within 1e-5,
# in every chunk (count per chunk, and the SHA-256 of their ids in chunk
# order), and the BVH4 records that differ (count per chunk).
PINS_4M = {"divergent": [42053, 52928, 64660, 67371], "tie_rays": 1,
           "shadow": [37249, 37730, 39654, 46363, 48809, 52648],
           "split_flips": {0: 93, 1: 67, 2: 88, 3: 57, 4: 68, 5: 24, 6: 107, 7: 74, 8: 56,
                           9: 74, 10: 77, 11: 32, 12: 70, 13: 57, 14: 140, 15: 38, 16: 69,
                           17: 94, 18: 69, 19: 97, 20: 68, 21: 24, 22: 99, 23: 98, 24: 89,
                           25: 89},
           "split_flips_sha256":
               "88e23e20f898554324f8c65f2dd54295352b3f1845984b6ec05fa96c29443f61",
           "table_rows": {0: 185, 1: 135, 2: 177, 3: 115, 4: 138, 5: 60340, 6: 211, 7: 149,
                          8: 111, 9: 152, 10: 159, 11: 63, 12: 139, 13: 114, 14: 279, 15: 76,
                          16: 139, 17: 189, 18: 137, 19: 196, 20: 137, 21: 48, 22: 201,
                          23: 193, 24: 181, 25: 178}}


@pytest.mark.slow
@pytest.mark.usefixtures("all_threads")
class TestChunkedConfig5:
    def test_partition_bit_identical_and_chunk_trees_flip_only_near_equal_splits(self):
        flips, rows = _chunk_trees_vs_jax("config5_chunked")
        assert flips == PINS_CONFIG5_CHUNKED["split_flips"], flips
        assert rows == PINS_CONFIG5_CHUNKED["table_rows"], rows

    def test_shadow_masks_on_shared_rays(self):
        st = _shared_chunked_shadow("config5_chunked")
        assert st["divergent"] == PINS_CONFIG5_CHUNKED["shared_shadow"], st

    def test_frames_under_the_frame_rule(self):
        j, p = _jax_chunked("config5_chunked"), _port_chunked("config5_chunked")
        st = pf.frame_rules(j, p)
        assert st.hits["divergent"] == PINS_CONFIG5_CHUNKED["divergent"], st.hits
        assert len(st.hits["tie_rays"]) == PINS_CONFIG5_CHUNKED["tie_rays"], st.hits
        assert st.shadow_rays == PINS_CONFIG5_CHUNKED["own_shadow"], st.occ
        assert st.frame["beyond_1"] == PINS_CONFIG5_CHUNKED["beyond_1"], st.frame

    def test_fixture_equals_jax(self):
        _fixture_equals_jax("config5_chunked", _chunked_fixture("config5_chunked"))


@pytest.mark.slow
@pytest.mark.usefixtures("all_threads")
class TestChunked4m:
    def test_partition_bit_identical_and_chunk_trees_flip_only_near_equal_splits(self):
        flips, rows = _chunk_trees_vs_jax("4m_chunked")
        assert {s: len(f) for s, f in flips.items()} == PINS_4M["split_flips"], flips
        assert bits_digest(np.concatenate([np.asarray(flips[s], np.int64) for s in sorted(flips)])
                           ) == PINS_4M["split_flips_sha256"]
        assert {s: len(r) for s, r in rows.items()} == PINS_4M["table_rows"], rows

    def test_subset_hits_under_the_crack_rule(self):
        j, p = _jax_chunked("4m_chunked"), _port_chunked("4m_chunked")
        st = assert_hit_parity_at_scale(p.hits, j.hits, p.a, p.b, p.c, p.on, p.dn)
        assert st["rays"] + len(st["divergent"]) + len(st["grazing_t"]) == 126720
        assert st["divergent"] == PINS_4M["divergent"], st
        assert len(st["tie_rays"]) == PINS_4M["tie_rays"], st

    def test_subset_shadow_masks_on_shared_rays(self):
        j, p = _jax_chunked("4m_chunked"), _port_chunked("4m_chunked")
        # The occlusion rule's segment is the one occluded_chunked traces.
        _, _, _, limit = pchunked.occlusion_rays_chunked(
            p.cb, t_(j.so), t_(j.sd), origin_bound=torch.tensor(j.origin_bound))
        assert float(limit) == float(parity._occlusion_limits(p.a, p.b, p.c,
                                                              j.origin_bound)[1])
        st = assert_occlusion_parity_at_scale(p.occ, j.occ, p.a, p.b, p.c, j.so, j.sd,
                                              j.origin_bound)
        assert st["divergent"] == PINS_4M["shadow"], st

    def test_fixture_equals_jax(self):
        _fixture_equals_jax("4m_chunked", _chunked_fixture("4m_chunked"))


# ---- C: config 5's multi-device engines ----------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_dist():
    """JAX's single Karras tree (`trace_rays`, its CPU engine) and its three
    tp engines at (2, 4) on config 5's 4,096 rays; the single tree also on
    the first 65,536 rays of the 1,048,576-ray batch."""
    assert len(jax.devices()) >= 8, "the JAX engines need 8 devices (XLA_FLAGS)"
    scene = rt.build_scene(rt.terrain_mesh(**DIST_MESH))
    bvh = rt.build_bvh(scene, builder="karras")
    o, d = (n_(x) for x in config5_rays(DIST_RAYS, CPU))
    out = {"single": _hits_np(jdispatch.trace_rays(scene, bvh, jnp.asarray(o), jnp.asarray(d)))}
    mesh = jdist.make_mesh(dp=2, tp=4)
    ss = jdist.partition_scene(scene, 4)
    for name in ENGINES:
        t, tri, u, v = getattr(jdist, f"render_hits_{name}")(ss, jnp.asarray(o), jnp.asarray(d),
                                                             mesh)[:4]
        out[name] = _hits_np(SimpleNamespace(t=t, tri=tri, u=u, v=v))
    bo, bd = (n_(x)[:BATCH_HEAD] for x in config5_rays(BATCH, CPU))
    out["batch_head"] = _hits_np(jdispatch.trace_rays(scene, bvh, jnp.asarray(bo),
                                                      jnp.asarray(bd)))
    return out


def _port_dist(out_dir):
    """The port's engines on the 8-rank gloo group (suite ``vs_jax_large``)
    and its single Karras tree (``plain4``), on the same rays."""
    ranks = run_ranks("vs_jax_large", 8, out_dir, timeout=900.0)
    out = {name: SimpleNamespace(**assemble(ranks, name)) for name in ENGINES}
    scene = pt.build_scene(pt.terrain_mesh(**DIST_MESH), device=CPU)
    o, d = config5_rays(DIST_RAYS, CPU)
    bo, bd = (x[:BATCH_HEAD].contiguous() for x in config5_rays(BATCH, CPU))
    with _cpu_threads():
        bvh = pt.build_bvh(scene, builder="karras")
        out["single"] = _hits_np(pdispatch.trace_rays(scene, bvh, o, d))
        out["batch_head"] = _hits_np(pdispatch.trace_rays(scene, bvh, bo, bd))
    out["triangles"] = _real_triangles(scene)
    out["rays"] = (n_(o), n_(d))
    out["batch_rays"] = (n_(bo), n_(bd))
    return out


def _on_hits(h):
    """A payload row set with misses' shard-local ids zeroed, as a HitRecord
    has them: both packages' engines carry shard-local attributes on a miss."""
    hit = h.t != MAX_FLOAT
    return SimpleNamespace(t=h.t, tri=np.where(hit, h.tri, 0), u=h.u, v=h.v)


def _dist_fixture():
    j = _jax_dist()
    out = {"mesh_sha256": _mesh_digest("config5_dist")}
    for name, h in j.items():
        out.update({f"{name}.{k}": v for k, v in encode_hits(h.t != MAX_FLOAT, h.tri).items()})
    return out


# (port side, JAX side) -> divergent rays under the crack rule.  At 4,096
# rays none (1,249 hits; ray 3,046 grazes its triangle: t within the grazing
# bound); on the batch's first 65,536 rays one crack, 10,655, where the port
# equals float64 and JAX misses.
PINS_DIST = {("single", "single"): [], **{(e, "single"): [] for e in ENGINES},
             **{(e, e): [] for e in ENGINES}, ("batch_head", "batch_head"): [10655]}


@pytest.fixture(scope="module")
def port_dist(tmp_path_factory):
    return _port_dist(str(tmp_path_factory.mktemp("dist_large")))


@pytest.mark.slow
@pytest.mark.usefixtures("all_threads")
@pytest.mark.parametrize("got,want", sorted(PINS_DIST))
def test_config5_engines_under_the_crack_rule(port_dist, got, want):
    p, j = port_dist, _jax_dist()
    o, d = p["batch_rays"] if got == "batch_head" else p["rays"]
    st = assert_hit_parity_at_scale(_on_hits(p[got]), _on_hits(j[want]), *p["triangles"], o, d)
    assert st["divergent"] == PINS_DIST[got, want], st


@pytest.mark.slow
def test_config5_dist_fixture_equals_jax():
    _fixture_equals_jax("config5_dist", _dist_fixture())


def write_fixtures(names=NAMES) -> None:
    """Write the JAX package's answers as the fixtures."""
    make = {"1m": _fixture_1m, "config5_chunked": lambda: _chunked_fixture("config5_chunked"),
            "4m_chunked": lambda: _chunked_fixture("4m_chunked"), "config5_dist": _dist_fixture}
    for name in names:
        t0 = time.perf_counter()
        np.savez_compressed(FIXTURES[name], **make[name]())
        print(f"wrote {FIXTURES[name]} ({os.path.getsize(FIXTURES[name])} bytes, "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    write_fixtures(tuple(sys.argv[1:]) or NAMES)
