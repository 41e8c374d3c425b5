"""Device ms a frame of the work launched under the animated frame's anim.refit and anim.tables spans (refit and the record table update)."""
from rtbench.program_spans import total


def read(ctx):
    return total(ctx.trace, ("anim.refit", "anim.tables"), "device_ms")
