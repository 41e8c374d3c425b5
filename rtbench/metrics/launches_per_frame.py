"""Device kernels launched a frame in the traced slice (layer pipeline.render)."""
from rtbench.readers import launches_per_step


def read(ctx):
    return launches_per_step(ctx, "frame")
