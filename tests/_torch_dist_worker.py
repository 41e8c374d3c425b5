"""One rank of the port's multi-process tests (one gloo group), run by
tests/test_torch_dist.py and tests/test_torch_dist_vs_jax.py (suites
``cases`` and ``vs_jax``, on the CPU) and tests/test_torch_kernel_gpu.py
(``gpu_pair``, on cuda:0):

    python tests/_torch_dist_worker.py <suite> <rank> <world> <port> <out_dir>

Joins a gloo group through `multihost.initialize` on 127.0.0.1:<port> (every
collective times out after 60 s), runs every case of the suite once, and
writes this rank's rows of each result to ``<out_dir>/rank<rank>.npz`` as
``<case>|<field>`` arrays with the case's first row in ``<case>|start``.
Imports nothing of JAX; inputs are made from seeds with numpy, as the tests
make theirs.  Exit code 0 on success.  `run_ranks` and `assemble` are the
launcher's side.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402

import unitysimpleraytracing_tpu_torch as pt  # noqa: E402
from unitysimpleraytracing_tpu_torch.parallel import dist, multihost, pipeline_pp  # noqa: E402

CPU = "cpu"
PAYLOAD = ("t", "tri", "u", "v", "uv", "normal")


def soup(n_tris, seed, bound=5.0, tri_size=1.0):
    return pt.build_scene(
        pt.random_triangle_soup(n_tris, seed=seed, bound=bound, tri_size=tri_size), device=CPU)


def rays(n, seed, lo=-8.0, hi=8.0):
    """tests/test_dist.py's `_setup` rays: uniform origins, unit normal dirs."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def skew_scene():
    """One huge triangle and 255 tiny ones (tests/test_dist.py's area case)."""
    tiny = pt.random_triangle_soup(255, seed=1, bound=5.0, tri_size=0.1)
    big = np.array([[[-50, -50, -8], [50, -50, -8], [0, 60, -8]]], np.float32)
    m = pt.MeshData(
        positions=np.concatenate([big, tiny.positions]),
        uvs=np.concatenate([np.zeros((1, 3, 2), np.float32), tiny.uvs]),
        normals=np.concatenate([np.zeros((1, 3, 3), np.float32), tiny.normals]))
    return pt.build_scene(m, device=CPU)


def tie_scene():
    """The same triangle twice: one copy per shard of a 2-way partition."""
    tri = np.array([[[-2, -2, 0], [2, -2, 0], [0, 2, 0]]], np.float32)
    m = pt.MeshData(positions=np.concatenate([tri, tri]),
                    uvs=np.zeros((2, 3, 2), np.float32),
                    normals=np.tile(np.float32([0, 0, 1]), (2, 3, 1)))
    return pt.build_scene(m, device=CPU)


def tie_rays(n=64):
    """Rays straight down onto the tie scene's triangle."""
    rng = np.random.default_rng(4)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = rng.uniform(-0.5, 0.5, n)
    o[:, 1] = rng.uniform(-0.5, 0.5, n)
    o[:, 2] = 5.0
    d = np.tile(np.float32([0, 0, -1]), (n, 1))
    return torch.from_numpy(o), torch.from_numpy(d)


def pipeline_input():
    """tests/test_pipeline_pp.py's frames: 160 triangles, 4 deformations,
    256 rays; positions computed in numpy float32."""
    scene = soup(160, seed=11, bound=4.0)
    t = scene.triangles
    base = torch.stack([t.a, t.b, t.c], dim=1).numpy()          # (cap, 3, 3)
    positions = np.stack([base.copy() for _ in range(4)])
    for i, p in enumerate(np.linspace(0.0, 2.0, 4, dtype=np.float32)):
        positions[i, ..., 1] += np.float32(0.3) * np.sin(base[..., 0] + p)
    o, d = rays(256, seed=11, lo=-6.0, hi=6.0)
    return scene, torch.from_numpy(positions), o, d


class Results:
    def __init__(self):
        self.arrays = {}

    def put(self, case, start, **fields):
        self.arrays[f"{case}|start"] = np.int64(start)
        for k, x in fields.items():
            self.arrays[f"{case}|{k}"] = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def engine(self, case, fn, ss, o, d, mesh, layout):
        mesh.host_reads = 0
        out = fn(ss, o, d, mesh)
        self.put(case, dist.ray_block(mesh, o.shape[0], layout).start,
                 **dict(zip(PAYLOAD, out)))
        self.put(case + "_reads", 0, host_reads=mesh.host_reads)


def suite_cases(res: Results, rank: int) -> None:
    """Every case of tests/test_torch_dist.py."""
    scene = soup(300, seed=3)
    o, d = rays(512, seed=3)
    bvh = pt.build_bvh(scene, builder="karras")

    mesh = dist.make_mesh(8, 1, device=CPU)
    h = dist.render_hits_dp(scene, bvh, o, d, mesh)
    res.put("dp_8x1", dist.ray_block(mesh, 512, "dp").start,
            t=h.t, tri=h.tri, u=h.u, v=h.v)

    for dp, tp in ((4, 2), (2, 4), (1, 8)):
        mesh = dist.make_mesh(dp, tp, device=CPU)
        ss = dist.partition_scene(scene, tp)
        res.engine(f"sharded_{dp}x{tp}", dist.render_hits_sharded, ss, o, d, mesh, "dp")
        if tp >= 4:
            res.engine(f"ring_{dp}x{tp}", dist.render_hits_ring, ss, o, d, mesh, ("dp", "tp"))
            mesh.copies_sent = 0
            res.engine(f"shuffle_{dp}x{tp}", dist.render_hits_shuffle, ss, o, d, mesh,
                       ("dp", "tp"))
            res.put(f"shuffle_{dp}x{tp}_copies", 0, copies_sent=mesh.copies_sent)

    # 257 triangles, seed 9: ring and shuffle against the all-gather combine,
    # on a count and on an area partition
    scene9 = soup(257, seed=9)
    o9, d9 = rays(512, seed=9)
    mesh = dist.make_mesh(2, 4, device=CPU)
    for balance in ("count", "area"):
        ss = dist.partition_scene(scene9, 4, balance=balance)
        res.engine(f"soup257_{balance}_sharded", dist.render_hits_sharded, ss, o9, d9, mesh,
                   "dp")
        res.engine(f"soup257_{balance}_ring", dist.render_hits_ring, ss, o9, d9, mesh,
                   ("dp", "tp"))
        res.engine(f"soup257_{balance}_shuffle", dist.render_hits_shuffle, ss, o9, d9, mesh,
                   ("dp", "tp"))

    # 299 triangles on 8 shards: a ragged last shard
    scene299 = soup(299, seed=3)
    mesh = dist.make_mesh(1, 8, device=CPU)
    res.engine("soup299_sharded_1x8", dist.render_hits_sharded,
               dist.partition_scene(scene299, 8), o, d, mesh, "dp")

    # one huge triangle among tiny ones, area partition: empty shards
    sk = skew_scene()
    ss = dist.partition_scene(sk, 4, balance="area")
    ok, dk = rays(256, seed=2)
    mesh = dist.make_mesh(2, 4, device=CPU)
    res.put("skew_partition", 0, counts=ss.counts, global_tri=ss.global_tri,
            range_min=ss.range_min, range_max=ss.range_max)
    for name, fn in (("ring", dist.render_hits_ring), ("shuffle", dist.render_hits_shuffle),
                     ("sharded", dist.render_hits_sharded)):
        res.engine(f"skew_{name}", fn, ss, ok, dk, mesh, "dp" if name == "sharded" else ("dp", "tp"))

    # an exact t tie across two shards
    ts = tie_scene()
    ss = dist.partition_scene(ts, 2)
    ot, dt = tie_rays()
    mesh = dist.make_mesh(4, 2, device=CPU)
    res.put("tie_partition", 0, global_tri=ss.global_tri, counts=ss.counts)
    for name, fn in (("sharded", dist.render_hits_sharded), ("ring", dist.render_hits_ring),
                     ("shuffle", dist.render_hits_shuffle)):
        res.engine(f"tie_{name}", fn, ss, ot, dt, mesh, "dp" if name == "sharded" else ("dp", "tp"))

    # _ragged_a2a's layout, both directions, zero sizes included: rank i
    # sends sizes[i][j] rows to rank j, row r of its operand holding
    # (1000 * i + r, r)
    S = tdist.get_world_size()
    mesh = dist.make_mesh(1, S, device=CPU)
    sizes = [[(i * 5 + j * 3) % 4 for j in range(S)] for i in range(S)]
    K = 4 * S
    op = torch.stack([torch.arange(K) + 1000 * rank, torch.arange(K)], dim=1).to(torch.int32)
    send, recv = sizes[rank], [sizes[i][rank] for i in range(S)]
    fwd = dist._ragged_a2a(op, torch.full((K, 2), -1, dtype=torch.int32), send, recv,
                           mesh.get_group("tp"))
    rev = dist._ragged_a2a(fwd, torch.full((K, 2), -1, dtype=torch.int32), recv, send,
                           mesh.get_group("tp"))
    res.put("ragged", 0, sizes=np.asarray(sizes), op=op, fwd=fwd, rev=rev)

    # make_host_mesh with LOCAL_WORLD_SIZE=4: (2, 4), each tp row one host
    mesh = multihost.make_host_mesh(device=CPU)
    res.put("host_mesh", 0, shape=[mesh.shape["dp"], mesh.shape["tp"]],
            coords=[mesh.coords["dp"], mesh.coords["tp"]], tp_row=mesh.ranks["tp"])

    # per-host ingest: each host builds its range of a 96-triangle soup
    # against the fixed parity box; gathered across hosts it is the full ingest
    mesh_obj = pt.random_triangle_soup(96, seed=5, bound=4.0, tri_size=1.0)
    hosts = mesh.shape["dp"]
    lo, hi = multihost.host_shard_bounds(96, hosts, mesh.coords["dp"])
    local = pt.build_scene(
        pt.MeshData(positions=mesh_obj.positions[lo:hi], uvs=mesh_obj.uvs[lo:hi],
                    normals=mesh_obj.normals[lo:hi]),
        scene_bound=pt.constants.PARITY_SCENE_BOUND, device=CPU)
    m = hi - lo
    pieces = {"morton": local.morton[:m], "aabb_min": local.aabb_min[:m],
              "aabb_max": local.aabb_max[:m], "tri_global": local.tri_index[:m] + lo}
    res.put("ingest", 0, **{k: dist._all_gather(v, mesh, "dp").reshape(hosts * m, *v.shape[1:])
                            for k, v in pieces.items()})


def suite_vs_jax(res: Results, rank: int) -> None:
    """The three tp engines at (2, 4) on 220 triangles and 512 rays, and the
    pipeline on ranks 0 and 1 (tests/test_torch_dist_vs_jax.py)."""
    scene = soup(220, seed=3)
    o, d = rays(512, seed=3)
    mesh = dist.make_mesh(2, 4, device=CPU)
    ss = dist.partition_scene(scene, 4)
    res.engine("sharded", dist.render_hits_sharded, ss, o, d, mesh, "dp")
    res.engine("ring", dist.render_hits_ring, ss, o, d, mesh, ("dp", "tp"))
    res.engine("shuffle", dist.render_hits_shuffle, ss, o, d, mesh, ("dp", "tp"))

    pp = pipeline_pp.make_pp_mesh(device=CPU)
    if pp.coords["pp"] is not None:
        scene_p, positions, po, pd = pipeline_input()
        h = pipeline_pp.render_frames_pipelined(scene_p, positions, po, pd, pp)
        res.put("pipeline", 0, t=h.t, tri=h.tri, u=h.u, v=h.v, positions=positions)


def suite_gpu_pair(res: Results, rank: int) -> None:
    """Two ranks of one gloo group on cuda:0 (tests/test_torch_kernel_gpu.py):
    the ring and the shuffle at (1, 2) on tests/test_dist.py's scene, K1
    traversing every shard."""
    from unitysimpleraytracing_tpu_torch.ops import trace_bvh4

    dev = torch.device("cuda", 0)
    scene = pt.build_scene(
        pt.random_triangle_soup(300, seed=3, bound=5.0, tri_size=1.0), device=dev)
    o, d = (x.to(dev) for x in rays(512, seed=3))
    mesh = dist.make_mesh(1, 2, device=dev)
    ss = dist.partition_scene(scene, 2)
    for name, fn in (("ring", dist.render_hits_ring), ("shuffle", dist.render_hits_shuffle)):
        before = trace_bvh4.traverse_bvh4.launches
        mesh.host_reads = 0
        out = [x.cpu() for x in fn(ss, o, d, mesh)]
        res.put(name, dist.ray_block(mesh, 512, ("dp", "tp")).start, **dict(zip(PAYLOAD, out)))
        res.put(name + "_counts", 0, k1_launches=trace_bvh4.traverse_bvh4.launches - before,
                host_reads=mesh.host_reads)


SUITES = {"cases": (suite_cases, CPU), "vs_jax": (suite_vs_jax, CPU),
          "gpu_pair": (suite_gpu_pair, "cuda:0")}


# ---- the launcher's side: start a group, gather what its ranks wrote ------

DIST_WORKER = os.path.abspath(__file__)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(suite: str, world: int, out_dir: str, timeout: float = 240.0) -> list[dict]:
    """Start ``world`` worker processes of one gloo group, wait for all, and
    load each rank's results.  A rank that fails or outlives ``timeout``
    fails the caller (the others are killed)."""
    port = free_port()
    env = dict(os.environ, LOCAL_WORLD_SIZE="4", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen(
            [sys.executable, DIST_WORKER, suite, str(r), str(world), str(port), out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=os.path.dirname(os.path.dirname(DIST_WORKER)), text=True)
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{suite}: ranks did not finish in {timeout} s")
    codes = [p.returncode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}:\n" + "\n".join(outs)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]


def assemble(ranks: list[dict], case: str) -> dict:
    """Every row of a case from the ranks' blocks; blocks that two ranks
    both hold (a dp block replicated over tp) must agree bit for bit."""
    fields = sorted({k.split("|")[1] for k in ranks[0] if k.startswith(case + "|")} - {"start"})
    parts = {}
    for r in ranks:
        start = int(r[f"{case}|start"])
        block = {f: r[f"{case}|{f}"] for f in fields}
        if start in parts:
            for f in fields:
                np.testing.assert_array_equal(block[f].view(np.uint8), parts[start][f].view(np.uint8))
        parts[start] = block
    starts = sorted(parts)
    return {f: np.concatenate([parts[s][f] for s in starts]) for f in fields}


def main() -> int:
    suite, rank, world, port, out_dir = sys.argv[1], *map(int, sys.argv[2:5]), sys.argv[5]
    torch.set_num_threads(1)
    run, device = SUITES[suite]
    ok = multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", device=device,
                              timeout=timedelta(seconds=60))
    assert ok and tdist.get_world_size() == world
    res = Results()
    try:
        run(res, rank)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res.arrays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
