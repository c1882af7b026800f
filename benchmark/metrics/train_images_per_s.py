"""Training throughput: images of every train step completed in the window,
over the window's time to the last step's end."""

from benchmark import readers


def read(ctx):
    return readers.rate(ctx, "train")
