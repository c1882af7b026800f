"""Device ms a profiled train step in the coupling nets' recompute: the
ops launched inside the program's ift.coupling.net spans that open while
the step's ift.step.backward is open (the checkpoint's second forward of
each net; its backward is not counted)."""

from benchmark import inner


def read(ctx):
    return inner.device_ms(ctx, "train", inner.RECOMPUTE)
