"""Readings of the program's own spans and counters
(``sibrar_tpu_torch.utils.trace``) inside the benchmark's units.

The program stamps its events with ``time.time_ns()``; the anchor pair of
its snapshot, ``(time.time_ns(), time.perf_counter())``, places them on the
clock of the benchmark's unit spans (``record["spans"]``). Only the units
outside the profiler slice count, as for ``host_ms_per_step.train``. An
event belongs to the unit that holds its midpoint (a span) or its stamp (a
count). A span's name stands for itself and the names under it:
``host_wait`` for every ``host_wait.<site>``, the program's span of one call
that makes the host wait for the card.

Every reading is None where the program keeps no recorder (a checkout from
before it), where the recorder's ring dropped events inside the window, or
where the units hold none of the events asked for.
"""
from __future__ import annotations

import bisect


def snapshot():
    """The program's snapshot, or None where the program has no
    recorder."""
    try:
        from sibrar_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def _under(name: str, key: str) -> bool:
    return key == name or key.startswith(name + ".")


def in_units(record: dict, unit: str, snap: dict | None = None):
    """The program's events inside the units ``unit`` outside the slice:
    ``{"units": n, "seconds": {span: s}, "spans": {span: n}, "counts":
    {counter: total}, "kept": [(span, start_s, end_s)]}``, or None (no
    units, no recorder, or a ring that dropped events inside the window).
    ``snap`` is the program's snapshot (taken here if not given)."""
    units = sorted((t0, t1) for name, t0, t1, inside in record.get("spans", ())
                   if name == unit and not inside)
    snap = snapshot() if snap is None else snap
    if not units or snap is None:
        return None
    ns0, perf0 = snap["anchor"]
    events, counters = snap["events"], snap["counters"]

    def perf(ns):
        return perf0 + (ns - ns0) / 1e9

    if snap["dropped"] and (not events or perf(events[0][1]) > units[0][0]):
        return None
    starts = [t0 for t0, _ in units]
    seconds: dict = {}
    spans: dict = {}
    counts: dict = {}
    kept: list = []
    for name, a, b in events:
        counter = name in counters
        t = perf(a) if counter else perf(a + (b - a) / 2)
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t > units[i][1]:
            continue
        if counter:
            counts[name] = counts.get(name, 0) + b
        else:
            seconds[name] = seconds.get(name, 0.0) + (b - a) / 1e9
            spans[name] = spans.get(name, 0) + 1
            kept.append((name, perf(a), perf(b)))
    return {"units": len(units), "seconds": seconds, "spans": spans,
            "counts": counts, "kept": kept}


def _enclosed_s(kept: list, outer: str, inner: str) -> float:
    """Seconds of the spans ``inner`` that lie inside a span ``outer``."""
    outs = sorted((a, b) for n, a, b in kept if _under(outer, n))
    starts = [a for a, _ in outs]
    s = 0.0
    for n, a, b in kept:
        if not _under(inner, n) or _under(outer, n):
            continue
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and b <= outs[i][1]:
            s += b - a
    return s


def span_ms(record: dict, unit: str, name: str, per_unit: int = 1,
            less: str | None = None, snap: dict | None = None):
    """Milliseconds of the program's spans ``name`` (less the time of the
    spans ``less`` they enclose) per unit, or per ``per_unit``-th of
    one."""
    got = in_units(record, unit, snap)
    if got is None or not per_unit:
        return None
    found = [n for n in got["spans"] if _under(name, n)]
    if not found:
        return None
    s = sum(got["seconds"][n] for n in found)
    if less:
        s -= _enclosed_s(got["kept"], name, less)
    return 1e3 * s / (got["units"] * per_unit)


def spans_per(record: dict, unit: str, name: str, marker: str,
              per_unit: int = 1, snap: dict | None = None):
    """The program's spans ``name`` per unit, or per ``per_unit``-th of
    one, in the units that hold the program's span ``marker`` (none of
    them there reads 0)."""
    got = in_units(record, unit, snap)
    if got is None or marker not in got["spans"] or not per_unit:
        return None
    n = sum(c for s, c in got["spans"].items() if _under(name, s))
    return n / (got["units"] * per_unit)


def batches(record: dict) -> int:
    """User batches a validation pass (0 outside validation)."""
    return record.get("batches_per_pass") or 0
