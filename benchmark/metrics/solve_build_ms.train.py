"""Device ms a profiled train step in the chain solve's operator build:
the ops launched inside the program's ift.solve.build spans
(fused_chain.chain_inputs, the forward's build and, through
backward_inputs, the backward's)."""

from benchmark import inner


def read(ctx):
    return inner.device_ms(ctx, "train", "ift.solve.build")
