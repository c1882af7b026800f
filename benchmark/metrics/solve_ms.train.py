"""Device ms a profiled train step in the masked-conv inverse: the spans
around InvFlow/InvFlowUnit.forward_with (operator build, chain launch,
their bookkeeping; the remat recompute too) and the backward of what
they ran."""

from benchmark import readers


def read(ctx):
    return readers.kind_ms(ctx, "train", "solve")
