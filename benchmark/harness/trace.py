"""The traced slice: a fixed number of steady batches under torch.profiler.

The profiler's device records give each port kernel's runs and device
time, the union of every device interval (busy time), the operations that
took most time, and the idle gaps with what the host was doing.  The runs
it saw of each port kernel must equal the program's launch counter
(``kernels.LAUNCHES``) over the same slice; where they differ, a record
was lost, and the kernel and idle readings are withheld (``consistent``
False, with the reason), never understated.  The trace stays in memory.
"""
from __future__ import annotations

import time


def is_kernel(key: str, name: str) -> bool:
    """Whether a profiler event is a run of the port's kernel ``name``
    (symbol ``<name>_kernel``, demangled or not, any instantiation)."""
    base = f"{name}_kernel"
    if key.startswith("_Z"):
        head = f"_Z{len(base)}{base}"
        return key.startswith(head) and key[len(head):len(head) + 1] in "I8"
    k = key[5:] if key.startswith("void ") else key
    return k.startswith(base + "(") or k.startswith(base + "<")


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, host_spans, top: int = 10):
    """The longest gaps between device intervals (us), each named by the
    innermost host span covering its middle → [[name, seconds], ...]."""
    iv = sorted(intervals)
    gaps, end = [], None
    for s, e in iv:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    out = []
    for length, s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        covering = [(he - hs, name) for hs, he, name in host_spans
                    if hs <= mid <= he]
        name = min(covering)[1] if covering else "host Python (no op recorded)"
        out.append([name, length / 1e6])
    return out


def profile_slice(run_batches, kernel_names, launches, reset_launches):
    """Run ``run_batches()`` under the profiler (CPU and CUDA activity) →
    dict: ``window_s`` (host seconds of the slice), ``busy_s`` (union of
    device intervals), ``kernel_s`` (device seconds of the port's kernels),
    ``runs`` / ``launches`` by kernel, ``consistent``, ``reason``,
    ``device_ops`` and ``idle_gaps`` (the breakdown), or the same with
    no device records (CPU)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    reset_launches()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_batches()
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    counted = {n: launches[n] for n in kernel_names}
    dev, host, by_name = [], [], {}
    runs = dict.fromkeys(kernel_names, 0)
    kernel_us = 0.0
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type.name == "CUDA":
            dev.append((tr.start, tr.end))
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (tr.end - tr.start)
            for n in kernel_names:
                if is_kernel(ev.name, n):
                    runs[n] += 1
                    kernel_us += tr.end - tr.start
        else:
            host.append((tr.start, tr.end, ev.name))
    res = dict(window_s=window, runs=runs, launches=counted,
               busy_s=union_s(dev) / 1e6 if dev else None,
               kernel_s=kernel_us / 1e6 if dev else None,
               device_ops=sorted(([k, v / 1e6] for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:10],
               idle_gaps=idle_gaps(dev, host) if dev else [])
    if not dev:
        res.update(consistent=False, reason="no device records")
    elif runs != counted:
        res.update(consistent=False,
                   reason=f"the profiler saw kernel runs {runs}, the program "
                          f"counted launches {counted}")
    else:
        res.update(consistent=True, reason="")
    return res
