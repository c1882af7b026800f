"""The whole train step's share of the card's peak: the least time of the
step's math (benchmark.work) over the untraced seconds a step."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, "train")
