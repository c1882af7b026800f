"""The whole draw's share of the card's peak: the least time of the
sampling pass's math (benchmark.work) over the untraced seconds a draw."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, "sample")
