"""Device-to-host reads a load: occurrences of the program's readback.* spans (SAH level loop, depth chase, parent links, table pack)."""
from rtbench.program_spans import READBACK, total


def read(ctx):
    return total(ctx.trace, (READBACK,), "occurrences")
