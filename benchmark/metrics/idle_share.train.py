"""The device's idle share of a train step: 100 x (1 - busy seconds a
profiled step / untraced seconds a step of the same run)."""

from benchmark import readers


def read(ctx):
    return readers.busy_share_idle(ctx, "train")
