"""Device ms a profiled draw in the activations: the ops launched inside
the program's ift.act spans (the RQ spline's inverse)."""

from benchmark import inner


def read(ctx):
    return inner.device_ms(ctx, "sample", "ift.act")
