"""Set-up seconds: from the process's start to the window's start (imports,
CUDA init, the kernels loaded or built, model build, weights from the
seed, ActNorm's data init, the warm-up units)."""


def read(ctx):
    return ctx.setup_s
