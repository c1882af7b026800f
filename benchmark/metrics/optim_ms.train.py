"""Device ms a profiled train step in the optimizer: the ops launched
inside the program's ift.step.optim span (apply_grads: Adam, the
schedule, the weight clamp)."""

from benchmark import inner


def read(ctx):
    return inner.device_ms(ctx, "train", "ift.step.optim")
