"""Device ms a profiled train step in the chain kernel: the ops launched
inside the program's ift.solve.chain spans (fused_chain.chain_phases,
forward and backward), which on the card are the kernel's launches
alone."""

from benchmark import inner


def read(ctx):
    return inner.device_ms(ctx, "train", "ift.solve.chain")
