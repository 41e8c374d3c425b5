"""Share of the traced slice in which no kernel or copy ran on the device, in load cells."""
from rtbench.readers import idle_percent


def read(ctx):
    return idle_percent(ctx, "load")
