"""Host-time spans of the port: a module-level registry, as
:data:`..ops.kernels.LAUNCHES` is for kernel launches.

``with span("renderer.batch") as s:`` takes the host clock
(``time.perf_counter``) at entry and exit and adds to the name's
aggregates: ``count``, ``total_s`` and ``self_s`` (total minus the time of
the spans opened directly inside it), and ``parent``, the name of the span
that enclosed it (None at the top).  ``s.seconds`` is the span's duration.
The stack of open spans is popped on any exception, ``KeyboardInterrupt``
included.

While ``torch.profiler`` records, a span also opens a record function of
its name (``torch._C._profiler._RecordFunctionFast``), so it lands in the
profiler's trace, among the host ops, on the clock of the device
activity; otherwise it costs two clock reads and one check of the
profiler's state.  ``torch.profiler.record_function`` is not used: it
records a user annotation, which the profiler also projects onto the
device's timeline as an interval from the first to the last kernel
launched inside it, so a trace's device intervals would cover the idle
gaps the spans are there to name.

:func:`snapshot` returns the aggregates as a plain dict; :func:`reset`
clears them.  The port renders from one thread; spans opened from several
threads at once would share one stack.

Beside the spans, ``count(name, n)`` adds ``n`` to a named counter (work
the host already holds, such as the wave loop's counters read back once a
batch, or ``wavefront.pool_from_card``, the batches whose pool the
renderer sized from the card's resident lanes); :func:`counters` returns
``{name: total}``, and :func:`reset` clears them with the spans.
"""
from __future__ import annotations

import time

import torch

_now = time.perf_counter
_profiling = torch._C._autograd._profiler_enabled
_record = torch._C._profiler._RecordFunctionFast

SPANS: dict = {}      # name -> [count, total_s, self_s, parent]
COUNTERS: dict = {}   # name -> total
_STACK: list = []     # the open spans, innermost last


class span:
    """Time the block under ``name`` (see the module's docstring)."""

    __slots__ = ("name", "seconds", "_t0", "_child_s", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = None
        if _profiling():
            self._rf = _record(self.name)
            self._rf.__enter__()
        self._child_s = 0.0
        _STACK.append(self)
        self._t0 = _now()
        return self

    def __exit__(self, et, ev, tb):
        dt = self.seconds = _now() - self._t0
        _STACK.pop()
        agg = SPANS.get(self.name)
        if agg is None:
            agg = SPANS[self.name] = [0, 0.0, 0.0, None]
        agg[0] += 1
        agg[1] += dt
        agg[2] += dt - self._child_s
        if _STACK:
            parent = _STACK[-1]
            parent._child_s += dt
            agg[3] = parent.name
        else:
            agg[3] = None
        if self._rf is not None:
            self._rf.__exit__(et, ev, tb)
        return False


def snapshot() -> dict:
    """The aggregates so far: ``{name: {"count", "total_s", "self_s",
    "parent"}}``, a copy."""
    return {name: dict(count=c, total_s=t, self_s=s, parent=p)
            for name, (c, t, s, p) in SPANS.items()}


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``."""
    COUNTERS[name] = COUNTERS.get(name, 0) + n


def counters() -> dict:
    """The counters so far: ``{name: total}``, a copy."""
    return dict(COUNTERS)


def reset() -> None:
    """Clear the aggregates and the counters (spans still open keep
    timing)."""
    SPANS.clear()
    COUNTERS.clear()
