"""Kernels launched a frame under the animated frame's anim.refit and anim.tables spans (refit and the record table update)."""
from rtbench.program_spans import total


def read(ctx):
    return total(ctx.trace, ("anim.refit", "anim.tables"), "launches")
