"""Headless render watcher: checkpoint → PNG whenever it changes.

    python path_tracer_tpu_torch/scripts/watch_render.py CKPT.npz OUT.png
        [interval_s]

The port of ``tools/watch_render.py``: polls the modification time of a
checkpoint that ``Renderer.render(checkpoint_path=...)`` writes and, on
each change, reads its ``accum`` and ``samples_done`` and writes the PNG
with the port's ``write_png``, so an image viewer can follow a long render
on a machine without a display.  A read that meets a file in the middle of
a write is retried at the next poll.  Host code only; runs until killed.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 2
    ckpt, out = argv[0], argv[1]
    interval = float(argv[2]) if len(argv) > 2 else 2.0

    import numpy as np

    from path_tracer_tpu_torch.utils.image import write_png

    last_mtime = 0.0
    while True:
        try:
            mtime = os.path.getmtime(ckpt)
        except OSError:
            time.sleep(interval)
            continue
        if mtime != last_mtime:
            last_mtime = mtime
            try:
                with np.load(ckpt) as z:
                    accum = z["accum"]
                    n = int(z["samples_done"])
                write_png(out, accum, max(n, 1))
                print(f"{time.strftime('%H:%M:%S')} {out}: {n} samples",
                      flush=True)
            except Exception as e:  # a read in the middle of a write
                last_mtime = 0.0
                print(f"retry: {e}", flush=True)
        time.sleep(interval)


if __name__ == "__main__":
    sys.exit(main())
