"""The program's elementwise glue calls over the window (its counters
``glue.*``: each call of an elementwise entry point of ops/zq.py and
ops/zq32.py, and each rq.substitute gather; a kernel's plain version is
not glue), divided by the operations: a count that repeats exactly."""

from fhebench.metrics._spans import recording


def read(w, name):
    rec = recording()
    if rec is None or not w.ops:
        return None
    return sum(n for k, n in rec.counters.items()
               if k.startswith("glue.")) / w.ops
