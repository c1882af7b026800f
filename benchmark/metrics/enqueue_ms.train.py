"""Host ms a profiled train step inside the program's ift.step span
(Experiment.train_step, whole): the host's time to enqueue a step's
work, under the profiler, which slows the host."""

from benchmark import inner


def read(ctx):
    return inner.enqueue_ms(ctx, "train", "ift.step")
