"""The masked-conv inverse's share of its roofline in a train step: the
solves' least time from the math (benchmark.work: for each solve layer
the larger of its taps at the float32 peak and its bytes at the memory
bandwidth) over the device time of solve_ms.train."""

from benchmark import readers, work


def read(ctx):
    ms = readers.kind_ms(ctx, "train", "solve")
    if ms is None or ctx.peaks is None:
        return None
    return 100.0 * work.solve_least_time_s(ctx.work, ctx.peaks) / (ms / 1e3)
