"""The device's idle share of a draw: 100 x (1 - busy seconds a profiled
draw / untraced seconds a draw of the same run)."""

from benchmark import readers


def read(ctx):
    return readers.busy_share_idle(ctx, "sample")
