"""The program's spans and counters: where its host time goes, and how
often and how long the host waits on the card.

``span(name)`` times a block of host code. It stores ``(name, start_ns,
end_ns)`` in a ring of `CAPACITY` events; the oldest are overwritten and
counted as dropped. ``count(name, n)`` adds ``n`` to an integer counter and
stores ``(name, stamp_ns, n)`` in the same ring, so a reader windows counts
as it windows spans. ``host_wait(site)`` is the span of one call that makes
the host wait for the card, named ``host_wait.<site>``; it also adds one to
the counters ``host_reads`` and ``host_reads.<site>``, which stay out of the
ring. `snapshot` hands all of it to a reader.

Stamps are ``time.time_ns()``, the clock of ``torch.profiler``'s raw
records (``kineto_results.events()``): a span lies over the runtime calls
and kernels it issued with no conversion. ``snapshot``'s anchor pair
``(time.time_ns(), time.perf_counter())`` places the events against spans
taken on ``perf_counter``.

The recorder is always on. A span costs two clock reads and a store: no
work on the card, no read from it, and no call into the profiler, whose
sessions it neither opens nor queries. Inside `mirrored` (a profiled epoch,
whose session records the host) each span is also a
``torch.profiler.record_function`` range, so the Chrome trace shows the
program's phases over its kernels. The program records from the one
thread that runs its training and evaluation loops; the recorder takes no
lock.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

CAPACITY = 65536


class Recorder:
    """A ring of the last ``capacity`` events, and the counters' totals."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.ring: list = [None] * capacity
        self.written = 0
        self.counters: dict = {}  # counter name -> int
        self.mirror = False

    def store(self, event: tuple) -> None:
        self.ring[self.written % self.capacity] = event
        self.written += 1

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        self.store((name, time.time_ns(), n))

    def snapshot(self) -> dict:
        """``events`` oldest first (spans ``(name, start_ns, end_ns)``,
        counts ``(name, stamp_ns, n)``), ``counters``, ``dropped`` (events
        the ring overwrote) and ``anchor`` ``(time.time_ns(),
        time.perf_counter())``."""
        n, cap = self.written, self.capacity
        head = n % cap
        events = (self.ring[:n] if n <= cap
                  else self.ring[head:] + self.ring[:head])
        return {"events": events,
                "counters": dict(self.counters),
                "dropped": max(0, n - cap),
                "anchor": (time.time_ns(), time.perf_counter())}


class Span:
    """``with span(name) as s:`` times the block; ``s.ns`` is its length
    once the block has ended."""

    __slots__ = ("recorder", "name", "start", "ns", "_range")

    def __init__(self, recorder: Recorder, name: str):
        self.recorder = recorder
        self.name = name
        self.ns = None
        self._range = None

    def __enter__(self) -> Span:
        if self.recorder.mirror:
            import torch

            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self.ns = end - self.start
        self.recorder.store((self.name, self.start, end))
        if self._range is not None:
            self._range.__exit__(*exc)


class HostWait(Span):
    """The span ``host_wait.<site>`` of one call that makes the host wait
    for the card, counted as ``host_reads`` and ``host_reads.<site>``."""

    __slots__ = ("key",)

    def __init__(self, recorder: Recorder, site: str):
        Span.__init__(self, recorder, "host_wait." + site)
        self.key = "host_reads." + site

    def __exit__(self, *exc) -> None:
        Span.__exit__(self, *exc)
        counters = self.recorder.counters
        counters["host_reads"] = counters.get("host_reads", 0) + 1
        counters[self.key] = counters.get(self.key, 0) + 1


RECORDER = Recorder()


def span(name: str) -> Span:
    return Span(RECORDER, name)


def host_wait(site: str) -> HostWait:
    """The span of one call at ``site`` that makes the host wait for the
    card: a read of the card's memory (``int``, ``bool``, ``.item()``,
    ``.cpu()``, ``.tolist()``, ``nonzero``) or a copy from pageable host
    memory to the card, which waits as a read does."""
    return HostWait(RECORDER, site)


def count(name: str, n: int = 1) -> None:
    RECORDER.count(name, n)


def counter(name: str) -> int:
    """The counter's total so far."""
    return RECORDER.counters.get(name, 0)


def snapshot() -> dict:
    return RECORDER.snapshot()


@contextmanager
def mirrored():
    """Mirror every span into ``torch.profiler.record_function`` inside
    the block (a profiled epoch, whose session records the host)."""
    RECORDER.mirror = True
    try:
        yield
    finally:
        RECORDER.mirror = False
