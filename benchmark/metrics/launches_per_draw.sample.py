"""Kernel launch calls (cudaLaunch*, cuLaunch*) a profiled draw, from the
profiler's raw events."""

from benchmark import readers


def read(ctx):
    return readers.launches(ctx, "sample")
