"""Host ms a load spent inside build_scene's ingest.pad and ingest.upload spans (numpy pad and bounds, host-to-device copies)."""
from rtbench.program_spans import total


def read(ctx):
    return total(ctx.trace, ("ingest.pad", "ingest.upload"), "host_ms")
