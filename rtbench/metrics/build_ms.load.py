"""Mean time of the build_bvh call (default sah_free) a load, from the benchmark's span."""
from rtbench.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "pipeline.build")
