"""Device ms a profiled train step in the coupling nets: the spans around
Coupling.forward_with (SplitPrior's coupling too) and the backward of
what they ran."""

from benchmark import readers


def read(ctx):
    return readers.kind_ms(ctx, "train", "coupling")
