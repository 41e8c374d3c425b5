"""Headless CLI: render an OBJ (+ optional PNG texture) to a PNG image.

    python -m unitysimpleraytracing_tpu_torch.cli scene.obj out.png \\
        --texture tex.png --width 640 --height 480 --eye 3 2 4

Runs on the card by default (``--device cuda``; it fails without one) or on
the CPU with ``--device cpu``.  ``--orbit N`` renders an N-frame camera orbit
around the target — the reference re-dispatches the traversal every
``Update()`` against the Awake-built BVH (RaytracingMeshDrawer.cs:76-84); here
the record table is likewise packed once and reused across frames, and the
steady-state per-frame ms is reported.  ``--orbit-batch`` renders the orbit in
groups of frames, each group ONE primary and ONE shadow traversal
(`render_frames`).  ``--background-image`` composites over a real image
instead of a solid color (ImageComposer.shader:44-53).

A mesh of more than `CHUNKED_ABOVE` triangles (580,000, the JAX CLI's switch
point) is built in chunks of 163,840 triangles, one tree each
(`build_bvh_chunked`), and rendered through `render_frame_chunked` /
`render_frames_chunked`; below it the scene is one tree.  ``--bvh-cache
PATH.npz`` restores the built tree (or chunks) from PATH if it exists, else
builds and saves it there (`io/checkpoint`, the same files as the JAX CLI's).
``--gizmo`` / ``--gizmo-tris`` draw the tree's internal-node boxes (red) and
the triangles' boxes (white) over each frame as wireframes on the host
(`utils/visualize`; ``--gizmo-index`` picks one box); the frame itself is
rendered on the device as without them.
"""
from __future__ import annotations

import argparse
import os
import time

# Above this many triangles the scene is built and traced in chunks; the
# JAX CLI's switch point (its PACKED4_MAX_CAPACITY).  PERF.md section 5 has
# the port's own measurement of one tree against chunks at 1,048,352.
CHUNKED_ABOVE = 580_000


def orbit_eyes(eye, target, n: int):
    """Eye positions of an n-frame full-revolution orbit about the target's
    vertical (y) axis, starting at ``eye`` (frame 0 == the static camera)."""
    import numpy as np

    rel = np.asarray(eye, np.float64) - np.asarray(target, np.float64)
    out = []
    for i in range(n):
        ang = 2.0 * np.pi * i / n
        c, s = np.cos(ang), np.sin(ang)
        out.append(
            np.asarray(target)
            + np.array([rel[0] * c + rel[2] * s, rel[1], -rel[0] * s + rel[2] * c])
        )
    return out


def _resize_nearest(img, h: int, w: int):
    """Nearest-neighbor resample of an (H0, W0, C) image to (h, w, C) —
    background plates only (the raster image the traced layer blends over)."""
    import numpy as np

    h0, w0 = img.shape[:2]
    ys = (np.arange(h) * h0 // h).clip(0, h0 - 1)
    xs = (np.arange(w) * w0 // w).clip(0, w0 - 1)
    return img[ys[:, None], xs[None, :]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="LBVH raytracer (PyTorch/CUDA port)")
    ap.add_argument("obj")
    ap.add_argument("out")
    ap.add_argument("--texture", default=None)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--fov", type=float, default=60.0)
    ap.add_argument("--eye", type=float, nargs=3, default=None)
    ap.add_argument("--target", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    ap.add_argument("--background", type=float, nargs=3, default=(0.12, 0.12, 0.15))
    ap.add_argument(
        "--background-image", default=None,
        help="PNG to composite the traced layer over (the reference's "
        "raster frame; resized to the render resolution)",
    )
    ap.add_argument(
        "--orbit", type=int, default=0, metavar="N",
        help="render an N-frame camera orbit around the target; frame i is "
        "written to OUT with '_NNN' appended; reports steady-state ms/frame",
    )
    ap.add_argument("--flip-x", action="store_true", help="Unity-style OBJ import")
    ap.add_argument(
        "--subdivide", type=int, default=0,
        help="midpoint-subdivide the mesh N times (4x tris per level)",
    )
    ap.add_argument(
        "--displace", type=float, default=0.0,
        help="with --subdivide: crack-free smooth displacement amplitude "
        "along normals (a pure function of position)",
    )
    ap.add_argument(
        "--builder", default=None, choices=["karras", "sah"],
        help="BVH topology: default = build_bvh's default (free-order "
        "sweep SAH; 'sah' per chunk for a chunked scene); 'karras' = the "
        "reference's radix tree (BVH.compute:94-149); 'sah' = sweep SAH "
        "over the Morton order (lower SAH cost → fewer box tests per ray; "
        "ops/sah.py)",
    )
    ap.add_argument("--shadows", action="store_true", help="shadow-ray pass")
    ap.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where to run; 'cuda' (default) fails when no card is present",
    )
    ap.add_argument(
        "--orbit-batch", action="store_true",
        help="with --orbit: render groups of frames as ONE batched ray "
        "dispatch each (render_frames; render_frames_chunked for a chunked "
        "scene) instead of per-frame calls — offline throughput mode; "
        "steady ms/frame excludes the first group",
    )
    ap.add_argument(
        "--bvh-cache", default=None, metavar="PATH.npz",
        help="BVH checkpoint: load the prebuilt BVH (or chunked BVH) from "
        "PATH if it exists, else build it and save it there (io/checkpoint; "
        "the same files as the JAX CLI's)",
    )
    ap.add_argument(
        "--gizmo", action="store_true",
        help="overlay BVH internal-node AABB wireframes in red "
        "(RaytracingMeshDrawer.OnDrawGizmos:108-115; one tree only)",
    )
    ap.add_argument(
        "--gizmo-tris", action="store_true",
        help="overlay per-triangle AABB wireframes in white (:98-105)",
    )
    ap.add_argument(
        "--gizmo-index", type=int, default=-1,
        help="draw only this node/triangle index (the reference's "
        "_indexToCheck inspector slider, RaytracingMeshDrawer.cs:11)",
    )
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import unitysimpleraytracing_tpu_torch as rt
    from unitysimpleraytracing_tpu_torch.io import checkpoint as ckpt
    from unitysimpleraytracing_tpu_torch.io.png import read_png, write_png
    from unitysimpleraytracing_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    mesh = rt.load_obj(args.obj, flip_x=args.flip_x)
    if args.subdivide:
        mesh = rt.subdivide_mesh(
            mesh, levels=args.subdivide, displace=args.displace
        )
    print(f"loaded {mesh.num_triangles} triangles in {time.perf_counter()-t0:.2f}s")

    scene = rt.build_scene(mesh, device=device)
    # Beyond the switch point the scene is built and traced in chunks.
    chunked = mesh.num_triangles > CHUNKED_ABOVE
    cached = args.bvh_cache and os.path.exists(args.bvh_cache)
    t0 = time.perf_counter()
    bvh = None  # one tree's BVH; a chunked scene has none (no --gizmo nodes)
    if chunked:
        if cached:
            cbvh = ckpt.load_chunked_checkpoint(args.bvh_cache, device=device)
            print(f"chunked BVH restored ({cbvh.num_chunks} chunks) from "
                  f"{args.bvh_cache} in {time.perf_counter()-t0:.3f}s")
        else:
            cbvh = rt.build_bvh_chunked(scene, builder=args.builder)
            sync()
            print(f"chunked BVH built ({cbvh.num_chunks} chunks) "
                  f"in {time.perf_counter()-t0:.3f}s")
            if args.bvh_cache:
                ckpt.save_chunked_checkpoint(args.bvh_cache, cbvh)
                print(f"saved {args.bvh_cache}")
    else:
        if cached:
            scene, bvh = ckpt.load_checkpoint(args.bvh_cache, device=device)
            print(f"BVH restored from {args.bvh_cache} "
                  f"in {time.perf_counter()-t0:.3f}s")
        else:
            bvh = rt.build_bvh(scene, builder=args.builder)
            sync()
            print(f"BVH built in {time.perf_counter()-t0:.3f}s")
            if args.bvh_cache:
                ckpt.save_checkpoint(args.bvh_cache, scene, bvh)
                print(f"saved {args.bvh_cache}")

    lo = mesh.positions.min(axis=(0, 1))
    hi = mesh.positions.max(axis=(0, 1))
    center = (lo + hi) / 2
    diag = float(np.linalg.norm(hi - lo))
    if args.eye is None:
        eye = center + np.array([0.8, 0.6, 1.2]) * diag
        target = center
    else:
        eye, target = np.asarray(args.eye, np.float64), np.asarray(args.target)

    if args.texture:
        tex = rt.load_texture(args.texture, device=device)
    else:
        tex = rt.solid_texture((0.8, 0.8, 0.8, 1.0), device=device)
    if args.background_image:
        bg_img = read_png(args.background_image).astype(np.float32) / 255.0
        background = np.ascontiguousarray(
            _resize_nearest(bg_img[..., :3], args.height, args.width)[::-1]
        )  # file is top-down; frames are bottom-up (UAV orientation)
    else:
        background = np.asarray(args.background, np.float32)
    background = torch.from_numpy(background).to(device)

    def cam_at(eye_pos):
        return rt.make_camera(
            eye=eye_pos, target=target,
            width=args.width, height=args.height, fov_deg=args.fov,
            device=device,
        )

    def do_frame(cam):
        if chunked:
            frame = rt.render_frame_chunked(
                scene, cbvh, cam, tex, background, shadows=args.shadows
            )
        else:
            frame = rt.render_frame(
                scene, bvh, cam, tex, background, shadows=args.shadows
            )
        sync()
        return frame

    def overlay(frame, cam):
        """Top-down image of a frame, with the --gizmo* wireframes drawn
        over it on the host (utils/visualize)."""
        if not (args.gizmo or args.gizmo_tris):
            return rt.frame_to_image(frame)
        from unitysimpleraytracing_tpu_torch.utils.visualize import draw_aabbs

        over = frame
        sel = (
            slice(None)
            if args.gizmo_index < 0
            else slice(args.gizmo_index, args.gizmo_index + 1)
        )
        if args.gizmo_tris:  # per-triangle boxes, white
            over = draw_aabbs(
                over, cam,
                scene.aabb_min[: scene.count][sel],
                scene.aabb_max[: scene.count][sel],
                color=(1.0, 1.0, 1.0),
            )
        if args.gizmo and bvh is not None:  # internal nodes, red
            over = draw_aabbs(
                over, cam,
                bvh.node_aabb_min[: bvh.num_internal][sel],
                bvh.node_aabb_max[: bvh.num_internal][sel],
                color=(1.0, 0.0, 0.0),
            )
        return over[::-1]  # bottom-up frame → top-down image

    if args.orbit <= 0:
        cam = cam_at(eye)
        t0 = time.perf_counter()
        frame = do_frame(cam)
        dt = time.perf_counter() - t0
        mrays = args.width * args.height / dt / 1e6
        print(
            f"rendered {args.width}x{args.height} in {dt:.3f}s "
            f"({mrays:.2f} Mrays/s, first frame: includes the table pack "
            "and, on the card, the kernel build)"
        )
        write_png(args.out, overlay(frame, cam))
        print(f"wrote {args.out}")
        return

    # Camera orbit: rotate the eye about the target's vertical axis, one
    # full revolution over N frames — the reference's per-frame Update loop.
    stem, dot, ext = args.out.rpartition(".")
    stem = stem or args.out
    times = []
    batchable = (
        args.orbit_batch and args.width % 32 == 0 and args.height % 32 == 0
    )
    if args.orbit_batch and not batchable:
        print("orbit-batch needs 32-divisible dims; "
              "falling back to the per-frame loop")
    if batchable:
        # Batched throughput mode: groups of frames flatten into ONE ray
        # dispatch each (pipeline/render.render_frames; past the switch
        # point render_frames_chunked, every frame's rays sharing one fold
        # over the chunks), so the per-frame host and launch overhead is
        # paid once per group.  Solid-color or image plate both work ((3,)
        # or (H,W,3) background).
        eyes = orbit_eyes(eye, target, args.orbit)
        group = max(1, (1 << 22) // (args.width * args.height))  # ~4M rays
        idx = 0
        for lo in range(0, args.orbit, group):
            cams = [cam_at(e) for e in eyes[lo:lo + group]]
            t0 = time.perf_counter()
            if chunked:
                batch = rt.render_frames_chunked(
                    scene, cbvh, rt.stack_cameras(cams), tex, background,
                    shadows=args.shadows,
                )
            else:
                batch = rt.render_frames(
                    scene, bvh, rt.stack_cameras(cams), tex, background,
                    shadows=args.shadows,
                )
            sync()
            times.append((time.perf_counter() - t0) / len(cams))
            # PNGs written (and frames pulled to host) per group, so device
            # memory holds at most one group of frames beside the table.
            for frame, cam in zip(batch, cams):
                write_png(f"{stem}_{idx:03d}.{ext or 'png'}", overlay(frame, cam))
                idx += 1
        if len(times) == 1:
            print("orbit-batch: single group — steady ms/frame below includes "
                  "the table pack and, on the card, the kernel build (no "
                  "warm group to exclude)")
    else:
        for i, eye_i in enumerate(orbit_eyes(eye, target, args.orbit)):
            cam = cam_at(eye_i)
            t0 = time.perf_counter()
            frame = do_frame(cam)
            times.append(time.perf_counter() - t0)
            write_png(f"{stem}_{i:03d}.{ext or 'png'}", overlay(frame, cam))
    steady = float(np.median(times[1:])) if len(times) > 1 else times[0]
    print(
        f"orbit {args.orbit} frames {args.width}x{args.height}: "
        f"first {times[0]*1e3:.1f} ms, steady {steady*1e3:.1f} ms/frame "
        f"({args.width*args.height/steady/1e6:.2f} Mrays/s)"
    )
    print(f"wrote {stem}_000.{ext or 'png'} .. {stem}_{args.orbit-1:03d}.{ext or 'png'}")


if __name__ == "__main__":
    main()
