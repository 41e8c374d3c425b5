"""Device ms a frame of the work launched under the program's ray set-up spans (render.rays, render.shadow_rays: ray generation and the tile reorder)."""
from rtbench.program_spans import total


def read(ctx):
    return total(ctx.trace, ("render.rays", "render.shadow_rays"), "device_ms")
