"""What the readers of the program's own spans and counters share: the
recording that tpufhe_torch.utils.obs makes of a traced window (the
program records while the window's torch.profiler session is active).
A program without that tracer has no recording, and its readers return
None."""

from fhebench.metrics._stats import median


def recording():
    """The program's recording of the traced window, closed, or None."""
    try:
        from tpufhe_torch.utils import obs
    except ImportError:
        return None
    latest = getattr(obs, "latest", None)
    rec = latest() if latest is not None else None
    if rec is None or not getattr(rec, "by_profiler", False) or not rec.spans:
        return None
    return rec


def top_ms(rec, names) -> float:
    """Host milliseconds inside the top-level spans named `names`."""
    return sum(s.end_ns - s.start_ns for s in rec.spans
               if s.parent is None and s.name in names) / 1e6


def stage_ms(top: str, stage: str):
    """The median, over the window's top-level spans `top`, of the device
    milliseconds of their descendant spans named `stage`, summed per top
    span. None without a recording, or where the spans have no device
    bounds (on the CPU)."""
    rec = recording()
    if rec is None:
        return None
    rec.resolve()
    by_id = {s.id: s for s in rec.spans}
    per_top: dict = {}
    for s in rec.spans:
        if s.name != stage:
            continue
        if s.device is None:
            return None
        up = s
        while up.parent is not None:
            up = by_id[up.parent]
        if up.name == top:
            per_top[up.id] = per_top.get(up.id, 0) + s.device[1] - s.device[0]
    return median([ns / 1e6 for ns in per_top.values()])
