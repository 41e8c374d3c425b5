"""How ``correct`` is decided: outputs of the timed window, drawn from the
seed, against the plain reference (`rtbench.reference`) in float64.

During the window a reservoir keeps a uniform sample of the steps' outputs
(`Reservoir`).  Once the window has closed and the program's state is
freed, `check` draws pixels of each kept output from the seed, has the
reference work out each pixel's answer from the benchmark's own inputs, and
counts the wrong ones.  How an output is read and compared is its form's:
`Pixels` (a composited frame) and `Hits` (a hit record) below, which a step
kind (``rtbench/kinds/<kind>.py``) takes as a base; a kind with another
output brings its own form in its file.  Rays and pixels that the reference
finds ambiguous (a crack along a shared edge, a blocker grazing the shadow
segment's start) are left out and counted apart.

The number compared is the share of the sampled pixels or rays that are
wrong; each traffic file gives its limit.  The control (``check(...,
control=torch.bfloat16)``) puts the reference in the program's place in
bfloat16.
"""
from __future__ import annotations

import random

import torch

from rtbench import reference as R
from rtbench.seeds import STREAM_PIXELS, STREAM_RESERVOIR, rng, seed_of

# A pixel is wrong beyond a quarter of one 8-bit display step, plus how far
# its colour may move with float32's u and v (`reference.frame_pixels`).
COLOR_ATOL = 1e-3
# The program writes float32's largest value as the t of a miss.
MISS_T = 3.0e38


class Reservoir:
    """A uniform sample of ``size`` of the window's outputs, drawn from the
    seed (reservoir sampling; one draw a step on the host)."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.kept = size, 0, []
        self.rand = random.Random(seed_of(seed) * 8 + STREAM_RESERVOIR)

    def offer(self, index: int, output):
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((index, output))
        else:
            j = self.rand.randrange(self.seen)
            if j < self.size:
                self.kept[j] = (index, output)


def sample_pixels(kind, seed: int, index: int, count: int) -> torch.Tensor:
    """``count`` distinct pixels (column, row) of step ``index``'s image."""
    g = rng(seed_of(seed) + index, STREAM_PIXELS)
    n = kind.width * kind.height
    flat = torch.from_numpy(g.choice(n, size=min(count, n), replace=False))
    return torch.stack([flat % kind.width, flat // kind.width], dim=1)


class Pixels:
    """A composited frame (H, W, 4): each sampled pixel's colour against the
    reference's, within `COLOR_ATOL` plus the reference's ``rgb_slack``."""

    check_name = "bad_pixel_share"

    def program_values(self, output, pixels):
        px, py = pixels[:, 0], pixels[:, 1]
        dev = output.device
        return output[py.to(dev), px.to(dev), :3].to(torch.float64)

    def reference_values(self, index: int, pixels, device, dtype=torch.float64):
        (corners, uvs, normals), cam = self.reference_inputs(index)
        tris = R.Triangles(corners, dtype, device)
        surface = R.Surface(uvs, normals, self.texture_image, dtype, device)
        return R.frame_pixels(tris, surface, cam, pixels.to(device), self.config["background"],
                              self.shadows, judge=dtype == torch.float64)

    @staticmethod
    def ratio(got, ref):
        """Each pixel's largest colour error over the error it is allowed."""
        return (got - ref["rgb"]).abs().amax(dim=1) / (COLOR_ATOL + ref["rgb_slack"])

    @classmethod
    def wrong(cls, got, ref):
        return cls.ratio(got, ref) > 1

    @staticmethod
    def as_program_output(ref_low):
        return ref_low["rgb"].to(torch.float64)


class Hits:
    """A hit record: each sampled ray's hit mask, triangle, t (within the
    reference's ``t_tol``) and barycentrics u and v (within ``uv_tol``)."""

    check_name = "bad_ray_share"

    def program_values(self, output, pixels):
        px, py = pixels[:, 0], pixels[:, 1]
        flat = (py * self.width + px).to(output.t.device)
        t = output.t[flat]
        return {"t": t.to(torch.float64), "tri": output.tri[flat].to(torch.int64),
                "hit": t < MISS_T, "u": output.u[flat].to(torch.float64),
                "v": output.v[flat].to(torch.float64)}

    def reference_values(self, index: int, pixels, device, dtype=torch.float64):
        (corners, _, _), cam = self.reference_inputs(index)
        tris = R.Triangles(corners, dtype, device)
        return R.hit_rays(tris, cam, pixels.to(device), judge=dtype == torch.float64)

    @staticmethod
    def ratio(got, ref):
        """Where both take the same triangle, the largest of t's, u's and v's
        error over its bound; 0 elsewhere."""
        same = got["hit"] & (got["tri"] == ref["tri"])
        tol = {"t": ref["t_tol"], "u": ref["uv_tol"], "v": ref["uv_tol"]}
        r = torch.stack([(got[k] - ref[k]).abs() / tol[k] for k in tol]).amax(dim=0)
        return torch.where(same, r, torch.zeros_like(r))

    @classmethod
    def wrong(cls, got, ref):
        ref_hit = ref["tri"] >= 0
        both = got["hit"] & ref_hit
        off = (got["tri"] != ref["tri"]) | (cls.ratio(got, ref) > 1)
        return (got["hit"] != ref_hit) | (both & off)

    @staticmethod
    def as_program_output(ref_low):
        return {"t": ref_low["t"].to(torch.float64), "tri": ref_low["tri"],
                "hit": ref_low["tri"] >= 0, "u": ref_low["u"].to(torch.float64),
                "v": ref_low["v"].to(torch.float64)}


def _to(got, device):
    if isinstance(got, dict):
        return {k: g.to(device) for k, g in got.items()}
    return got.to(device)


def check(kind, kept, seed: int, device, rays_per_output: int, control=None) -> dict:
    """Judge each kept ``(index, output)``: the share of wrong sampled pixels
    or rays, with the counts and ``worst_ratio``, the largest error over its
    bound among the unambiguous samples (a wrong triangle is not a ratio).
    ``control`` (a dtype) replaces the program's outputs with the
    reference's own in that precision."""
    wrong = ambiguous = sampled = 0
    worst = 0.0
    for index, output in kept:
        pixels = sample_pixels(kind, seed, index, rays_per_output)
        ref = kind.reference_values(index, pixels, device)
        if control is None:
            got = _to(kind.program_values(output, pixels), device)
        else:
            got = kind.as_program_output(kind.reference_values(index, pixels, device, control))
        amb = ref["ambiguous"]
        wrong += int((kind.wrong(got, ref) & ~amb).sum())
        worst = max(worst, float(torch.where(amb, 0.0, kind.ratio(got, ref)).max()))
        ambiguous += int(amb.sum())
        sampled += pixels.shape[0]
    if sampled == 0:
        raise RuntimeError("no output was kept: the window completed no step")
    return {"share": wrong / sampled, "wrong": wrong, "ambiguous": ambiguous,
            "sampled": sampled, "outputs": len(kept), "worst_ratio": worst}
