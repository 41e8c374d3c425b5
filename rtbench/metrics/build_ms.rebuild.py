"""Mean time of the build_bvh call (Karras: sort, unique, topology) a frame, from the benchmark's span."""
from rtbench.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "pipeline.build")
