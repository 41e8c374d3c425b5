"""Host ms a load spent inside the program's readback.* spans: the host waiting on the device for each read."""
from rtbench.program_spans import READBACK, total


def read(ctx):
    return total(ctx.trace, (READBACK,), "host_ms")
