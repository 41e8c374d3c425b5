"""K1 (ops.trace_bvh4, csrc/trace_bvh4.cu): its byte bound over its device time in the traced slice, in %."""
from rtbench.readers import roofline_percent

# K1 and its compressed-record form share this kernel name.
PATTERNS = ("trace_bvh4_kernel",)


def read(ctx):
    return roofline_percent(ctx, PATTERNS)
