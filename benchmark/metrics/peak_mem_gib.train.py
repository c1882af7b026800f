"""Peak device memory of the train window, GiB (max_memory_allocated after
a reset at the window's start)."""


def read(ctx):
    if ctx.entry != "train" or ctx.peak_window_bytes is None:
        return None
    return ctx.peak_window_bytes / 2 ** 30
