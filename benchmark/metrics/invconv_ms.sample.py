"""Device ms a profiled draw in the masked convolution of the sampling
direction: the spans around InvFlow/InvFlowUnit.inverse_with."""

from benchmark import readers


def read(ctx):
    return readers.kind_ms(ctx, "sample", "solve")
