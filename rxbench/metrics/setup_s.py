"""setup_s: the process's start until the window opens: imports, the CUDA
context, the kernels' build (from the checkout's cache after its first run),
the entry, the input pool and one warm-up capture."""


def read(ctx):
    return ctx["setup_s"]
