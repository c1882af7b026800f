"""Device ms a profiled draw in the spans around Coupling.inverse_with
(SplitPrior's coupling too)."""

from benchmark import readers


def read(ctx):
    return readers.kind_ms(ctx, "sample", "coupling")
