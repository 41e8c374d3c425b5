"""Device kernels launched a load in the traced slice (pipeline.render and pipeline.build)."""
from rtbench.readers import launches_per_step


def read(ctx):
    return launches_per_step(ctx, "load")
