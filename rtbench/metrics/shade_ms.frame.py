"""Device ms a frame of the work launched under the program's render.shade and render.compose spans (ops.trace shade and compose)."""
from rtbench.program_spans import total


def read(ctx):
    return total(ctx.trace, ("render.shade", "render.compose"), "device_ms")
