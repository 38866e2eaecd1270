"""Set-up: from the process's start to the window's first operation
(import, the kernels' build or load, keys, inputs, warm-up)."""


def read(w, name):
    return w.setup_s
