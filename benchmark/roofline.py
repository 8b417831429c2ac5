"""The least device time a slice of frames needs on one H100, and the peaks.

What is counted is the arithmetic any correct implementation of the same
sample set performs, whatever its kernels, and the bytes it cannot avoid:

* operations: per pixel-sample spawned, the camera ray (eight threefry2x32
  draws and the ray arithmetic); per traced segment (``RenderStats.rays``,
  a count the sample set fixes), one bounce's arithmetic
  (:data:`BOUNCE_OPS`); per subsurface walk trip (``RenderStats.walk_steps``),
  :data:`WALK_TRIP_OPS`;
* bytes: the scene's own arrays read once (primitives, materials,
  textures, images, as the reference compiles them) and each frame
  written once (three float32 a pixel).

What is left out: BVH traversal and the BVH's bytes, because a better tree
walks fewer steps and no tree is needed for a correct answer, and every
intermediate state (a path's state between segments, the radiance sum
between samples), which a kernel can keep in registers, as the megakernel
does.  So the bound is a lower bound on any implementation and the share
reads low.  Fusing, splitting or renaming kernels leaves the count
unchanged.  On the benchmark's cells the operations bound it: a frame's
bytes are some megabytes against some hundred billion operations.

The bound is the larger of operations over the float32 peak and bytes
over the HBM peak, both the data sheet's for the SXM part at its 700 W
limit; a run states the card's power limit beside the share.
"""
from __future__ import annotations

# chip_smoke.py:228, NVIDIA H100 SXM data sheet: HBM3 bytes/s.
H100_BYTES_PER_S = 3.35e12
# chip_smoke.py:229: float32 FLOP/s outside the tensor cores.
H100_F32_OPS_PER_S = 67e12
# chip_smoke.py:267: float32-equivalent operations of one threefry2x32.
THREEFRY_OPS = 110
# chip_smoke.py:270: one bounce (hit refine, medium, scatter, emission,
# roulette) and its twelve threefry draws.
BOUNCE_OPS = 600 + 12 * THREEFRY_OPS
# chip_smoke.py:271: one subsurface walk trip.
WALK_TRIP_OPS = 3 * 110 + 60
# chip_smoke.py:1724: a camera ray: eight threefry draws and 60 operations.
SPAWN_OPS = 8 * THREEFRY_OPS + 60
# A frame's pixel: three float32 radiance sums.
PIXEL_BYTES = 12


def tensor_bytes(obj) -> int:
    """Bytes of every tensor among ``obj``'s fields (tuples of tensors
    too): the scene's own arrays, for :func:`work`'s ``read_bytes``."""
    import torch
    total = 0
    for v in vars(obj).values():
        for t in (v if isinstance(v, tuple) else (v,)):
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total


def work(pixel_samples: int, segments: int, walk_trips: int,
         read_bytes: int = 0, frame_pixels: int = 0) -> tuple:
    """(float32 operations, bytes): the sample set's arithmetic, the scene
    read once (``read_bytes``) and ``frame_pixels`` written once."""
    ops = (pixel_samples * SPAWN_OPS + segments * BOUNCE_OPS
           + walk_trips * WALK_TRIP_OPS)
    return ops, read_bytes + frame_pixels * PIXEL_BYTES


def bound_s(*counts, **kw) -> float:
    """The least seconds :func:`work` takes at the peaks."""
    ops, byts = work(*counts, **kw)
    return max(ops / H100_F32_OPS_PER_S, byts / H100_BYTES_PER_S)


def side(*counts, **kw) -> str:
    """Which peak bounds :func:`work`: ``"operations"`` or ``"bytes"``."""
    ops, byts = work(*counts, **kw)
    return ("operations" if ops / H100_F32_OPS_PER_S
            >= byts / H100_BYTES_PER_S else "bytes")


def share_pct(*counts, device_s: float, **kw):
    """The bound as a percentage of the device time the kernels took, or
    None where no device time was measured."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * bound_s(*counts, **kw) / device_s
