"""The port's host-time spans (``path_tracer_tpu_torch.utils.spans``), as
the per-layer readers of ``metrics/`` take them: the registry's snapshot at
the end of a traced run, covering the warm-up batch, the window and the
traced slice.  A program without the registry (an older checkout), or a
span that never ran, reads None; nothing here raises for it."""
from __future__ import annotations

import sys

MODULE = "path_tracer_tpu_torch.utils.spans"


def snapshot():
    """The registry's aggregates ({name: {"count", "total_s", ...}}), or
    None where the program has no registry."""
    snap = getattr(sys.modules.get(MODULE), "snapshot", None)
    return snap() if callable(snap) else None


def total_s(snap: dict, name: str) -> float:
    return snap.get(name, {}).get("total_s", 0.0)


def ms_per_batch(needs: str, plus=(), minus=()):
    """Milliseconds a batch (a ``renderer.batch`` span) of the spans
    ``plus`` less the spans ``minus``; None where no batch ran or the span
    ``needs`` never did."""
    snap = snapshot()
    if not snap:
        return None
    batches = snap.get("renderer.batch", {}).get("count", 0)
    if not batches or not snap.get(needs, {}).get("count"):
        return None
    s = sum(total_s(snap, n) for n in plus) - sum(total_s(snap, n)
                                                  for n in minus)
    return 1e3 * s / batches
