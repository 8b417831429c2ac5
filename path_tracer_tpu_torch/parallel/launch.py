"""Start the ranks of a job on this host: one process per rank, a free port.

``run_ranks(world, command, log_dir, timeout)`` runs ``command(rank, port)``
(an argv list) for every rank, each writing its output to
``log_dir/rank<world>_<rank>.log``, and polls the ranks together: as soon as
one exits non-zero, or the timeout passes, it kills the others and raises
with the failing ranks' logs.
"""
from __future__ import annotations

import os
import socket
import subprocess
import time


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(world: int, command, log_dir: str, timeout: float,
              env: dict | None = None, cwd: str | None = None) -> float:
    """Run ``command(rank, port)`` as ``world`` processes → the seconds until
    every rank exited 0.  Raises ``RuntimeError`` naming the first rank
    that failed (or the ranks still running at the timeout) with the end of
    its log; every other rank is killed first."""
    port = free_port()
    paths = [os.path.join(log_dir, f"rank{world}_{r}.log")
             for r in range(world)]
    logs = [open(p, "w") for p in paths]
    procs, why = [], ""
    t0 = time.perf_counter()
    try:
        for r in range(world):
            procs.append(subprocess.Popen(command(r, port), stdout=logs[r],
                                          stderr=subprocess.STDOUT, env=env,
                                          cwd=cwd))
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                why = ", ".join(f"rank {r} exited {codes[r]}" for r in bad)
                break
            if all(c == 0 for c in codes):
                break
            if time.perf_counter() - t0 > timeout:
                bad = [r for r, c in enumerate(codes) if c is None]
                why = f"ranks {bad} still running after {timeout:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if why:
        tails = []
        for r in bad:
            with open(paths[r]) as f:
                tails.append(f"rank {r}:\n" + f.read()[-4000:])
        raise RuntimeError(f"{world}-rank run failed: {why}\n"
                           + "\n".join(tails))
    return time.perf_counter() - t0
