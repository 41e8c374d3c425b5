"""The port's multi-device layer (parallel/dist, multihost) on an 8-rank gloo
group on the CPU: the counterparts of tests/test_dist.py's cases.

One module-scoped fixture starts the 8 ranks once (tests/_torch_dist_worker.py,
suite ``cases``; every collective times out after 60 s and every rank after
240 s), and the tests below check what they wrote.  Tolerance: every
engine's t equals the single-tree trace (the port's ``trace_rays(impl=
"plain4")``) bit for bit; tri, u, v equal it bit for bit on hits; hit masks
are identical; against the JAX package's ``trace.traverse`` on the same numpy
inputs the parity contract holds (`utils/parity.assert_hit_parity`: exact-t
ties only).  Misses carry shard-local triangle 0's attributes, so u, v, uv
and normal are compared on hits only, as tests/test_dist.py does.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import unitysimpleraytracing_tpu as rt
from unitysimpleraytracing_tpu.ops import trace as jtrace
from unitysimpleraytracing_tpu_torch.ops import dispatch as pdispatch
from unitysimpleraytracing_tpu_torch.parallel import dist as pdist
from unitysimpleraytracing_tpu_torch.parallel import multihost as pmultihost
from unitysimpleraytracing_tpu_torch.utils.parity import MAX_FLOAT, assert_hit_parity, grazing_factor

import _torch_dist_worker as W
from _torch_common import n_, t_
from _torch_dist_worker import assemble, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("cases", WORLD, str(tmp_path_factory.mktemp("dist_cases")))


def single_tree(scene, o, d):
    """The port's single-tree trace (plain4, Karras tree) and JAX's
    ``trace.traverse`` of the same mesh, rays given as numpy."""
    bvh = W.pt.build_bvh(scene, builder="karras")
    return pdispatch.trace_rays(scene, bvh, t_(o), t_(d), impl="plain4")


def jax_traverse(make_mesh_data, o, d):
    js = rt.build_scene(make_mesh_data(rt))
    return jtrace.traverse(js, rt.build_bvh(js), o, d)


def check_exact(got: dict, ref):
    """Bit for bit against the port's single-tree trace (tri, u, v on hits)."""
    t, tri, u, v = (n_(getattr(ref, f)) for f in ("t", "tri", "u", "v"))
    hit = t != MAX_FLOAT
    np.testing.assert_array_equal(got["t"].view(np.uint32), t.view(np.uint32))
    np.testing.assert_array_equal(got["tri"][hit], tri[hit])
    np.testing.assert_array_equal(got["u"][hit].view(np.uint32), u[hit].view(np.uint32))
    np.testing.assert_array_equal(got["v"][hit].view(np.uint32), v[hit].view(np.uint32))
    return hit


def assert_jax_parity(got: dict, jref, scene, d) -> int:
    """The parity contract against the JAX package's traversal of the same
    numpy inputs: identical hit masks; t within 4e-6 relative plus 1e-5
    times the grazing factor (the bound of test_torch_trace.py::
    test_ray_triangle_random_parity: XLA:CPU fuses multiply-adds that the
    port keeps apart, and t, u, v are quotients by det); another triangle
    only where t agrees within that bound (an exact-t tie); u, v within 1e-5
    times the grazing factor where the triangle agrees.  Returns the ties."""
    jt, jtri = np.asarray(jref.t), np.asarray(jref.tri)
    hit = jt != MAX_FLOAT
    np.testing.assert_array_equal(got["t"] != MAX_FLOAT, hit, err_msg="hit masks differ")
    tr = scene.triangles
    scale = grazing_factor(n_(tr.a), n_(tr.b), n_(tr.c), d, jtri)
    bound = 4e-6 * np.abs(jt) + 1e-5 * scale
    assert np.all((np.abs(got["t"] - jt) <= bound)[hit]), "t outside the bound"
    same = hit & (got["tri"] == jtri)
    for f in ("u", "v"):
        err = np.abs(got[f] - np.asarray(getattr(jref, f)))
        assert np.all((err <= 1e-5 * scale)[same]), f
    return int((hit & ~same).sum())


class _Hits:
    def __init__(self, got):
        self.t, self.tri, self.u, self.v = got["t"], got["tri"], got["u"], got["v"]


def soup_case(n_tris, seed):
    def make(m):
        return m.random_triangle_soup(n_tris, seed=seed, bound=5.0, tri_size=1.0)

    scene = W.soup(n_tris, seed)
    o, d = (x.numpy() for x in W.rays(512, seed))
    return make, scene, o, d


@pytest.fixture(scope="module")
def soup300():
    make, scene, o, d = soup_case(300, 3)
    return scene, d, single_tree(scene, o, d), jax_traverse(make, o, d)


def test_dp_sharding_is_exact(ranks, soup300):
    scene, d, ref, jref = soup300
    got = assemble(ranks, "dp_8x1")
    check_exact(got, ref)
    assert_jax_parity(got, jref, scene, d)


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (1, 8)])
def test_tp_combine_matches_single_device(ranks, soup300, dp, tp):
    scene, d, ref, jref = soup300
    got = assemble(ranks, f"sharded_{dp}x{tp}")
    hit = check_exact(got, ref)
    assert_jax_parity(got, jref, scene, d)
    # uv and normal: the single tree's triangle, interpolated in the same order
    tri = n_(ref.tri).astype(np.int64)
    u, v = n_(ref.u), n_(ref.v)
    w = (np.float32(1.0) - u - v)[:, None]
    tr = scene.triangles
    want_uv = w * n_(tr.a_uv)[tri] + u[:, None] * n_(tr.b_uv)[tri] + v[:, None] * n_(tr.c_uv)[tri]
    np.testing.assert_array_equal(got["uv"][hit], want_uv[hit])
    assert got["normal"].shape == (512, 3) and np.isfinite(got["normal"]).all()
    assert (ranks[0][f"sharded_{dp}x{tp}_reads|host_reads"] == 1)  # the shard's count only


@pytest.mark.parametrize("engine", ["ring", "shuffle"])
@pytest.mark.parametrize("dp,tp", [(2, 4), (1, 8)])
def test_exchange_engines_match_single_device(ranks, soup300, engine, dp, tp):
    scene, d, ref, jref = soup300
    got = assemble(ranks, f"{engine}_{dp}x{tp}")
    check_exact(got, ref)
    assert_jax_parity(got, jref, scene, d)
    # host reads: the shard's count, and for the shuffle the sizes matrix
    assert int(ranks[0][f"{engine}_{dp}x{tp}_reads|host_reads"]) == (2 if engine == "shuffle" else 1)
    # the two payload columns past u, v agree with the all-gather combine
    sh = assemble(ranks, f"sharded_{dp}x{tp}")
    hit = got["t"] != MAX_FLOAT
    for f in ("uv", "normal"):
        np.testing.assert_array_equal(got[f][hit], sh[f][hit])


@pytest.mark.parametrize("tp", [4, 8])
def test_shuffle_sends_each_ray_to_the_shards_it_enters(ranks, tp):
    """copies sent = ray-box overlaps of the rays with the shards' root boxes,
    counted here in numpy with JAX's slab arithmetic."""
    scene = W.soup(300, 3)
    ss = pdist.partition_scene(scene, tp)
    o, d = (n_(x) for x in W.rays(512, 3))
    lo, hi = n_(ss.range_min), n_(ss.range_max)
    inv = np.float32(1.0) / d
    t1 = (lo[None] - o[:, None]) * inv[:, None]
    t2 = (hi[None] - o[:, None]) * inv[:, None]
    tmin = np.minimum(t1, t2).max(axis=2)
    tmax = np.maximum(t1, t2).min(axis=2)
    want = int(((tmax > tmin) & (tmax > 0)).sum())
    dp = 8 // tp
    got = sum(int(r[f"shuffle_{dp}x{tp}_copies|copies_sent"]) for r in ranks)
    assert got == want
    assert 0 < got < 512 * tp


@pytest.mark.parametrize("balance", ["count", "area"])
@pytest.mark.parametrize("engine", ["ring", "shuffle"])
def test_exchange_matches_allgather_combine(ranks, balance, engine):
    make, scene, o, d = soup_case(257, 9)
    a = assemble(ranks, f"soup257_{balance}_sharded")
    b = assemble(ranks, f"soup257_{balance}_{engine}")
    np.testing.assert_array_equal(a["t"].view(np.uint32), b["t"].view(np.uint32))
    hit = a["t"] != MAX_FLOAT
    for f in ("tri", "u", "v", "uv", "normal"):
        np.testing.assert_array_equal(a[f][hit], b[f][hit])
    check_exact(b, single_tree(scene, o, d))


def test_sharded_with_uneven_counts(ranks):
    scene = W.soup(299, 3)
    o, d = (x.numpy() for x in W.rays(512, 3))
    got = assemble(ranks, "soup299_sharded_1x8")
    check_exact(got, single_tree(scene, o, d))


@pytest.mark.parametrize("engine", ["ring", "shuffle", "sharded"])
def test_skewed_area_partition_with_empty_shards(ranks, engine):
    """One huge triangle among 255 tiny ones: the area partition isolates it
    and leaves empty shards (+inf, -inf boxes) that no engine trips on."""
    part = {k.split("|")[1]: v for k, v in ranks[0].items() if k.startswith("skew_partition|")}
    counts = part["counts"]
    assert counts.sum() == 256 and (counts == 0).any()
    assert (part["range_min"][counts == 0] == np.inf).all()
    big = next(s for s in range(4) if 0 in part["global_tri"][s, : counts[s]])
    assert counts[big] < 256 / 4
    sk = W.skew_scene()
    o, d = (x.numpy() for x in W.rays(256, 2))
    got = assemble(ranks, f"skew_{engine}")
    check_exact(got, single_tree(sk, o, d))


def test_entry_distance_of_an_empty_box_is_inf():
    o = torch.tensor([[0.0, 0.0, 0.0], [5.0, -3.0, 1.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.6, 0.8]])
    lo = torch.tensor([[torch.inf] * 3, [-1.0, -1.0, -1.0]])
    hi = torch.tensor([[-torch.inf] * 3, [1.0, 1.0, 1.0]])
    e = pdist._entry_t(o, d, lo, hi)
    assert torch.isinf(e[:, 0]).all()                 # the empty box: +inf
    assert float(e[0, 1]) == 0.0                      # origin inside: 0
    assert torch.isinf(e[1, 1])                       # misses the unit box
    miss_o, miss_d = pdist._miss_ray(hi[0])
    assert torch.isfinite(miss_o).all()
    assert torch.isinf(pdist._entry_t(miss_o[None], miss_d[None], lo[1:], hi[1:])).all()


def test_exact_t_tie_across_two_shards(ranks):
    """The same triangle in both shards: every ray ties at one t.  The
    all-gather and the shuffle give the lowest shard, the ring the shard a
    block visits first (its own tp rank's)."""
    part = {k.split("|")[1]: v for k, v in ranks[0].items() if k.startswith("tie_partition|")}
    np.testing.assert_array_equal(part["counts"], [1, 1])
    low = int(part["global_tri"][0, 0])
    high = int(part["global_tri"][1, 0])
    assert {low, high} == {0, 1}
    sh, ring, shuf = (assemble(ranks, f"tie_{e}") for e in ("sharded", "ring", "shuffle"))
    assert (sh["t"] == np.float32(5.0)).all()
    for got in (ring, shuf):
        np.testing.assert_array_equal(got["t"], sh["t"])
    assert (sh["tri"] == low).all() and (shuf["tri"] == low).all()
    # ring: 64 rays in 8 blocks of 8, block b homed on tp rank b % 2
    first = np.where((np.arange(64) // 8) % 2 == 0, low, high)
    np.testing.assert_array_equal(ring["tri"], first)
    ts = W.tie_scene()
    o, d = (x.numpy() for x in W.tie_rays())
    ref = single_tree(ts, o, d)
    np.testing.assert_array_equal(sh["t"].view(np.uint32), n_(ref.t).view(np.uint32))
    assert_hit_parity(_Hits(sh), ref)


def test_ragged_a2a_layout_is_jax_dense_emulation(ranks):
    """`_ragged_a2a`'s contiguous by-source layout against a numpy model of
    the JAX package's dense emulation (dist.py:516-529) with the offsets the
    shuffle passes it (dist.py:604-634), forward and reverse, zero sizes
    included."""
    rows = [{k.split("|")[1]: v for k, v in r.items() if k.startswith("ragged|")} for r in ranks]
    sizes = rows[0]["sizes"]
    S = sizes.shape[0]
    assert (sizes == 0).any() and (sizes.sum(axis=0) > 0).all()
    ops = [r["op"] for r in rows]

    def jax_dense(ops, out_init, in_off, send, out_off):
        """out_j[out_off[i][j] + p] = op_i[in_off[i][j] + p], p < send[i][j]."""
        outs = [o.copy() for o in out_init]
        for i in range(S):
            for j in range(S):
                for p in range(send[i][j]):
                    outs[j][out_off[i][j] + p] = ops[i][in_off[i][j] + p]
        return outs

    zero_col = np.zeros((S, 1), np.int64)
    # forward: in_off = exclusive row-cumsum of my sizes; out_off[i][j] =
    # exclusive column-cumsum over sources
    in_off = np.concatenate([zero_col, np.cumsum(sizes, axis=1)[:, :-1]], axis=1)
    out_off = np.concatenate([np.zeros((1, S), np.int64), np.cumsum(sizes, axis=0)[:-1]])
    fill = [np.full_like(o, -1) for o in ops]
    want_fwd = jax_dense(ops, fill, in_off, sizes, out_off)
    for j in range(S):
        np.testing.assert_array_equal(rows[j]["fwd"], want_fwd[j])
    # reverse: rank j sends back col_me[i] = sizes[i][j] rows from my_in_offs
    # to i at rev_out_off[j][i] = exclusive row-cumsum of sizes at [i, j]
    send_rev = sizes.T
    my_in_offs = np.concatenate([zero_col, np.cumsum(sizes.T, axis=1)[:, :-1]], axis=1)
    rev_out_off = np.concatenate([zero_col, np.cumsum(sizes, axis=1)[:, :-1]], axis=1).T
    want_rev = jax_dense(want_fwd, fill, my_in_offs, send_rev, rev_out_off)
    for i in range(S):
        np.testing.assert_array_equal(rows[i]["rev"], want_rev[i])
        sent = sizes[i].sum()
        np.testing.assert_array_equal(rows[i]["rev"][:sent], ops[i][:sent])  # round trip


def test_make_host_mesh_keeps_tp_rows_within_a_host(ranks):
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["host_mesh|shape"], [2, 4])
        np.testing.assert_array_equal(res["host_mesh|coords"], [r // 4, r % 4])
        # torchrun numbers a host's ranks contiguously: host = rank // LOCAL_WORLD_SIZE
        assert {int(x) // 4 for x in res["host_mesh|tp_row"]} == {r // 4}


def test_per_host_ingest_matches_full_ingest(ranks):
    m = W.pt.random_triangle_soup(96, seed=5, bound=4.0, tri_size=1.0)
    full = W.pt.build_scene(m, scene_bound=W.pt.constants.PARITY_SCENE_BOUND, device="cpu")
    jfull = rt.build_scene(rt.random_triangle_soup(96, seed=5, bound=4.0, tri_size=1.0),
                           scene_bound=rt.constants.PARITY_SCENE_BOUND)
    for res in ranks:
        got = {k.split("|")[1]: v for k, v in res.items() if k.startswith("ingest|")}
        np.testing.assert_array_equal(got["morton"], n_(full.morton)[:96])
        np.testing.assert_array_equal(got["morton"], np.asarray(jfull.morton)[:96].astype(np.int64))
        for f in ("aabb_min", "aabb_max"):
            np.testing.assert_array_equal(got[f].view(np.uint32), n_(getattr(full, f))[:96].view(np.uint32))
            np.testing.assert_array_equal(got[f].view(np.uint32),
                                          np.asarray(getattr(jfull, f))[:96].view(np.uint32))
        np.testing.assert_array_equal(got["tri_global"], np.arange(96))


def test_mesh_and_ray_block_on_one_process():
    """Without a launcher a (1, 1) mesh starts a one-process gloo group, as
    JAX's mesh needs no initialise; the engines then run on it."""
    code = (
        "import torch, numpy as np\n"
        "from unitysimpleraytracing_tpu_torch.parallel import dist, multihost\n"
        "import unitysimpleraytracing_tpu_torch as pt\n"
        "assert multihost.initialize(num_processes=1) is False\n"
        "mesh = dist.make_mesh(1, 1, device='cpu')\n"
        "assert mesh.shape == {'dp': 1, 'tp': 1} and mesh.coords == {'dp': 0, 'tp': 0}\n"
        "assert dist.ray_block(mesh, 64, ('dp', 'tp')) == slice(0, 64)\n"
        "s = pt.build_scene(pt.random_triangle_soup(50, seed=2, bound=3.0), device='cpu')\n"
        "ss = dist.partition_scene(s, 1)\n"
        "rng = np.random.default_rng(2)\n"
        "o = torch.from_numpy(rng.uniform(-5, 5, (64, 3)).astype(np.float32))\n"
        "d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32)), dim=1)\n"
        "from unitysimpleraytracing_tpu_torch.ops.dispatch import trace_rays\n"
        "ref = trace_rays(s, pt.build_bvh(s, builder='karras'), o, d, impl='plain4')\n"
        "for f in (dist.render_hits_sharded, dist.render_hits_ring, dist.render_hits_shuffle):\n"
        "    assert torch.equal(f(ss, o, d, mesh)[0], ref.t), f\n"
        "try:\n"
        "    dist.make_mesh(2, 1, device='cpu')\n"
        "except ValueError:\n"
        "    print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_ray_block_layouts():
    mesh = pdist.Mesh(shape={"dp": 2, "tp": 4}, rank=6, device=torch.device("cpu"),
                      groups={}, ranks={}, coords={"dp": 1, "tp": 2})
    assert pdist.ray_block(mesh, 64, "dp") == slice(32, 64)
    assert pdist.ray_block(mesh, 64, ("dp", "tp")) == slice(48, 56)
    assert pdist.ray_block(mesh, 64, None) == slice(0, 64)
    with pytest.raises(ValueError):
        pdist.ray_block(mesh, 60, ("dp", "tp"))
    assert pmultihost.host_shard_bounds(10, 4, 0) == (0, 3)
    assert pmultihost.host_shard_bounds(10, 4, 3) == (9, 10)


@pytest.mark.parametrize("module", ["dist", "multihost", "pipeline_pp"])
def test_port_has_every_top_level_name_of_the_jax_module(module):
    src = os.path.join(ROOT, "unitysimpleraytracing_tpu", "parallel", module + ".py")
    tree = ast.parse(open(src, encoding="utf-8").read())
    names = {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    assert names
    import importlib

    port = importlib.import_module(f"unitysimpleraytracing_tpu_torch.parallel.{module}")
    assert names <= set(dir(port)), names - set(dir(port))
    if module == "dist":
        assert "Mesh" in dir(port)  # JAX's jax.sharding.Mesh


def test_no_host_copy_in_parallel_but_the_counted_reads():
    """No ray or payload goes to the host in parallel/: the engines', the
    mesh's and the pipeline's only way there is `dist._host_read`, which
    ``Mesh.host_reads`` counts.  `partition_scene`'s area balance reads the
    scene's arrays on the host, as the JAX package's does."""
    for module in ("dist", "multihost", "pipeline_pp"):
        src = open(os.path.join(ROOT, "unitysimpleraytracing_tpu_torch", "parallel",
                                module + ".py"), encoding="utf-8").read()
        for node in ast.parse(src).body:
            if not isinstance(node, ast.FunctionDef) or node.name in (
                    "_host_read", "partition_scene"):
                continue
            body = ast.get_source_segment(src, node)
            for call in (".cpu(", ".numpy(", ".item(", ".tolist(", "np.asarray("):
                assert call not in body, (module, node.name, call)
