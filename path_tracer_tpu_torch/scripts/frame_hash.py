"""sha256 of the main configuration's frames, to show two checkouts agree.

    PYTHONPATH=<checkout> python path_tracer_tpu_torch/scripts/frame_hash.py

Renders vol2_final_scene(sphere_cluster=1000) at 800x450, 10 spp, depth 10
in one batch through ``Renderer(engine="wavefront")`` (K1-K4 in the device
wave loop) and ``Renderer(engine="megakernel")`` (K5), each twice, and prints
one JSON line with each frame's sha256 (the float32 sums' bytes), its
``RenderStats`` but the times, whether the two renders of an engine are
equal, and the card's
``nvidia-smi`` name and power limit.  The package is imported from
``PYTHONPATH``, so running this file with each checkout on the path compares
them on one card.  It needs a CUDA card.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import torch

W, H, SPP, DEPTH = 800, 450, 10, 10


def main() -> int:
    if not torch.cuda.is_available():
        print("frame_hash: no CUDA device", file=sys.stderr)
        return 2
    import path_tracer_tpu_torch as ptt
    out = {"package": ptt.__file__}
    for engine in ("wavefront", "megakernel"):
        digests = []
        for _ in range(2):
            world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=1000)
            cam.aspect_ratio, cam.img_width = W / H, W
            cam.samples_per_pixel, cam.max_depth = SPP, DEPTH
            r = ptt.Renderer(world, cam, engine=engine)
            r.render(spp=SPP, batch=SPP)
            acc = r.accum.cpu().contiguous().numpy()
            digests.append(hashlib.sha256(acc.tobytes()).hexdigest())
        stats = {k: v for k, v in vars(r.stats).items()
                 if k not in ("wall_s", "sample_times")}
        stats["depth_hist"] = [int(x) for x in stats["depth_hist"]]
        out[engine] = {"sha256": digests[0], "repeat_equal":
                       digests[0] == digests[1], "stats": stats}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
