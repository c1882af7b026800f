"""Device ms a profiled train step in the activations: the ops launched
inside the program's ift.act spans (the RQ spline's forward) and the
backward of what they ran."""

from benchmark import inner


def read(ctx):
    return inner.device_ms(ctx, "train", "ift.act")
