"""Mean time of the build_scene call (pad, host to device, sort keys) a load, from the benchmark's span."""
from rtbench.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "core.mesh")
