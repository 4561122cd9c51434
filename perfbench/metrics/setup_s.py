"""setup_s: seconds from the process's start to the window's: imports, CUDA
start-up, kernels loaded (built on a checkout's first run), the cell's
inputs made and its shapes warmed."""


def read(rec, spec):
    return rec.setup_s
