"""Scene, BVH, camera and render-config containers as torch tensors.

The PyTorch counterpart of ``path_tracer_tpu/ops/types.py``: the same field
names, shapes, dtypes and padding rules, held as dataclasses of tensors with
a ``.to(device)`` instead of registered JAX pytrees.  Every array is padded
to a power-of-two bucket by the scene compiler, so nothing overflows.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

Tensor = torch.Tensor

# --- enums (same values as the JAX package) ---
PRIM_SPHERE = 0
PRIM_QUAD = 1
PRIM_TRIANGLE = 2

MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_EMISSIVE = 3
MAT_ISOTROPIC = 4
MAT_SSS_SIMPLE = 5
MAT_SSS_VOLUMETRIC = 6

TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3

BG_SOLID = 0
BG_GRADIENT = 1

BVH_NONE = -1
# Empty BVH child slot pointer: 2^23 (exact in f32, above any interior index).
BVH_EMPTY_SLOT = 1 << 23

# Floats per packed leaf payload row.
PRIM_ROW = 16


def bvh_layout(branching: int):
    """(ptr_off, payload_off, node_row) for a ``branching``-wide node row."""
    ptr = 6 * branching
    pay = -(-7 * branching // 8) * 8
    return ptr, pay, pay + PRIM_ROW * branching


PAYLOAD = bvh_layout(4)[1]   # 32
NODE_ROW = bvh_layout(4)[2]  # 96


class _TensorFields:
    """``.to(device)`` over every tensor field; other fields are copied."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


@dataclass
class SceneArrays(_TensorFields):
    """The whole scene as padded SoA tensors (fields as in the JAX package)."""

    sph_c0: Tensor
    sph_c1: Tensor
    sph_rad: Tensor
    sph_mat: Tensor
    sph_valid: Tensor
    qd_q: Tensor
    qd_u: Tensor
    qd_v: Tensor
    qd_n: Tensor
    qd_w: Tensor
    qd_d: Tensor
    qd_mat: Tensor
    qd_valid: Tensor
    tr_v0: Tensor
    tr_e1: Tensor
    tr_e2: Tensor
    tr_n: Tensor
    tr_mat: Tensor
    tr_valid: Tensor
    mat_type: Tensor
    mat_tex: Tensor
    mat_fuzz: Tensor
    mat_ir: Tensor
    mat_g: Tensor
    mat_sigma_s: Tensor
    mat_sigma_a: Tensor
    mat_scatter_dist: Tensor
    tex_type: Tensor
    tex_c1: Tensor
    tex_c2: Tensor
    tex_scale: Tensor
    tex_img: Tensor
    img_data: Tensor
    img_hw: Tensor
    sph_medium: Tensor
    qd_medium: Tensor
    tr_medium: Tensor
    med_density: Tensor
    med_tex: Tensor
    perlin_vec: Tensor
    perlin_perm: Tensor


@dataclass
class FlatBVH(_TensorFields):
    """Flattened binary BVH (node 0 is the root; leaves hold one prim)."""

    bb_min: Tensor
    bb_max: Tensor
    left: Tensor
    right: Tensor
    prim_type: Tensor
    prim_idx: Tensor


@dataclass
class PackedBVH(_TensorFields):
    """BVH-K traversal rows: ``nodes`` (B, node_row) f32 with K child boxes,
    K child pointers and embedded 16-float leaf payloads; ``prims`` (P, 16)
    f32 leaf rows in DFS order; ``root`` ≥ 0 interior row, else
    ``-(leaf_id+1)``.  ``prim_mask``/``max_stack``/``branching`` are host
    metadata (the JAX package's static fields)."""

    nodes: Tensor
    prims: Tensor
    root: Tensor
    prim_mask: tuple = (True, True, True)
    max_stack: int = 48
    branching: int = 4


@dataclass
class CameraArrays(_TensorFields):
    """Precomputed camera bases."""

    origin: Tensor
    pixel00: Tensor
    du: Tensor
    dv: Tensor
    defocus_u: Tensor
    defocus_v: Tensor
    defocus_angle: Tensor
    bg_color: Tensor
    bg_type: Tensor


@dataclass(frozen=True)
class RenderConfig:
    """Static render configuration (same fields and defaults as JAX's)."""

    width: int = 400
    height: int = 225
    samples_per_pixel: int = 16
    max_depth: int = 16
    max_iters: int | None = None
    rr_min_depth: int = 5
    rr_max_prob: float = 0.95
    use_russian_roulette: bool = True
    sss_max_steps: int = 32
    t_min: float = 1e-3
    t_max: float = 1e9
    stack_depth: int = 48
    queue_size: int | None = None
    steps_per_wave: int | None = None
    ctrl_den: int | None = None
    sample_stride: int | None = None

    @property
    def iters(self) -> int:
        return self.max_iters if self.max_iters is not None else self.max_depth + 8


class PathState(NamedTuple):
    """Per-path state of both engines (``PathState``, ``ops/integrator.py``)."""

    origin: Tensor       # (R, 3)
    direction: Tensor    # (R, 3)
    time: Tensor         # (R,)
    color: Tensor        # (R, 3) accumulated radiance
    throughput: Tensor   # (R, 3)
    depth: Tensor        # (R,) int32 scatter bounces taken
    iters: Tensor        # (R,) int32 loop trips (incl. passthrough)
    alive: Tensor        # (R,) bool


def pad_to(n: int, minimum: int = 8) -> int:
    """Next power-of-two bucket ≥ n (and ≥ minimum)."""
    m = max(int(n), minimum)
    return 1 << (m - 1).bit_length()


# --- wavefront slot phases and device counters -----------------------------
# Shared with the CUDA kernels: csrc/common.cuh holds the same numbers.
PH_MAIN = 0   # walking the main closest-hit query
PH_EXIT = 1   # walking the volume-exit query

# Slot flags passed between the control kernels (shade → retire → spawn).
FL_NONE = 0
FL_FINISHED = 1   # path finished this wave (set by shade)
FL_RESAMPLE = 2   # finished, and its window has samples left (set by retire)

# Indices into the int64 counter vector ``WaveState.ctr``.
C_SPAWNED = 0      # work items issued (raw; clamp to items_total to read)
C_DONE = 1         # paths finished
C_RAYS = 2         # traced segments of finished paths
C_DEPTH_SUM = 3    # scatter depths of finished paths
C_WAVES = 4        # waves executed while work remained
C_CTRLS = 5        # waves that ran the control kernels
C_OCC_SUM = 6      # Σ occupied slots over waves
C_TRAV_STEPS = 7   # walking-lane traversal steps
C_EXEC_STEPS = 8   # traversal steps the waves ran (chunks run x chunk)
C_N_READY = 9      # K1 chunk scratch, buffer 0: ready occupied slots
C_N_WALK = 10      # K1 chunk scratch, buffer 0: walking occupied slots
C_N_OCC = 11       # occupied slots now
C_DO_CTRL = 12     # this wave runs the control kernels
C_N_ACT_END = 13   # K1 chunk scratch, buffer 0: lanes walking at a chunk's end
C_STACK_OVF = 14   # pushes dropped at a full stack (must stay 0)
C_N_ACT_END_B = 15  # K1 chunk scratch, buffer 1 (as C_N_ACT_END)
C_WALK_STEPS = 16  # SSS-volumetric walking trips of kept lanes (B6)
C_N_READY_B = 17   # K1 chunk scratch, buffer 1 (as C_N_READY)
C_N_WALK_B = 18    # K1 chunk scratch, buffer 1 (as C_N_WALK)
C_TICKET = 19      # K1, K5: blocks done with the launch (clears the scratch)
C_FETCH = 20       # K5: pixels taken in this launch (zero between launches)
N_COUNTERS = 21

# The stats every engine's ``render_batch(with_stats=True)`` reads from its
# counter vector; a counter an engine never writes reads 0.
STATS = {"paths": C_DONE, "rays": C_RAYS, "depth_sum": C_DEPTH_SUM,
         "waves": C_WAVES, "ctrls": C_CTRLS, "occ_sum": C_OCC_SUM,
         "trav_steps": C_TRAV_STEPS, "exec_steps": C_EXEC_STEPS,
         "walk_steps": C_WALK_STEPS, "stack_overflows": C_STACK_OVF}


def counter_stats(ctr: Tensor, depth_hist: Tensor | None = None) -> dict:
    """The stats dict of the counter vector ``ctr``: for each name of
    :data:`STATS` its entry, a 0-d tensor on ``ctr``'s device (no read);
    ``ctr`` itself, for a reader that copies it once; and ``depth_hist``
    where given."""
    out = {name: ctr[i] for name, i in STATS.items()}
    out["ctr"] = ctr
    if depth_hist is not None:
        out["depth_hist"] = depth_hist
    return out
