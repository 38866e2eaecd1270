"""The program's kernel launches over the window
(tpufhe_torch.kernels.LAUNCHES, reset at its start), divided by the
operations: a count that repeats exactly."""


def read(w, name):
    return sum(w.launches.values()) / w.ops if w.ops and w.launches else None
