"""Sampling throughput: images of every draw completed in the window, over
the window's time to the last draw's end."""

from benchmark import readers


def read(ctx):
    return readers.rate(ctx, "sample")
