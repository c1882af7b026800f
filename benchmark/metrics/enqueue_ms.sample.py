"""Host ms a profiled draw inside the program's ift.sample span
(Flow.sample, whole; the draw's synchronisation is outside it): the
host's time to enqueue a draw's work, under the profiler, which slows the
host."""

from benchmark import inner


def read(ctx):
    return inner.enqueue_ms(ctx, "sample", "ift.sample")
