"""P0: the row gather ``table[idx, :]`` (``csrc/gather.cu``).

Port of the gather probe ``tools/bench_gather.py`` (``pallas_formulations``,
:105-145, and the XLA gathers of :1-104): the (R,)-indexed fetch of table
rows that K1 and K7 issue once per traversal step.  :func:`gather_rows`
launches the CUDA kernel for CUDA tensors and runs :func:`gather_rows_plain`
for CPU tensors; ``path_tracer_tpu_torch/scripts/bench_gather.py`` times it.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx, :]`` → (R, W): the plain version.  An index outside
    ``[0, B)`` is clamped into it, as ``jax.lax.gather``'s clip mode (and
    ``jnp.take(..., mode="clip")``) does; ``table[idx, :]`` in JAX clamps
    too, after wrapping an index in ``[-B, 0)`` as Python does."""
    return table.index_select(0, idx.clamp(0, table.shape[0] - 1))


def _lib():
    lib = kernels.library("gather_rows")
    if not hasattr(lib, "_typed"):
        P = ctypes.c_void_p
        lib.ptt_gather_rows.argtypes = [P, ctypes.c_int, ctypes.c_int, P,
                                        ctypes.c_longlong, P, P]
        lib.ptt_gather_rows.restype = ctypes.c_int
        lib.ptt_gather_rows_floor.argtypes = lib.ptt_gather_rows.argtypes
        lib.ptt_gather_rows_floor.restype = ctypes.c_int
        lib._typed = True
    return lib


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (R,) int32 of ``table`` (B, W) float32 → (R, W) float32.

    An index outside ``[0, B)`` is clamped into it (kernel and plain
    version alike).  CUDA tensors launch ``gather_rows``; CPU tensors take
    the plain version.
    """
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    if (table.dtype != torch.float32 or table.ndim != 2
            or not table.is_contiguous()):
        raise ValueError("table must be a contiguous (B, W) float32 tensor")
    if idx.dtype != torch.int32 or idx.ndim != 1 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous (R,) int32 tensor")
    if idx.device != table.device:
        raise ValueError("table and idx are on different devices")
    B, W = table.shape
    out = torch.empty((idx.shape[0], W), dtype=torch.float32,
                      device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _lib().ptt_gather_rows(table.data_ptr(), B, W, idx.data_ptr(),
                                 idx.shape[0], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"CUDA launch of gather_rows failed with error "
                           f"{err}")
    kernels.count({"gather_rows": 1})
    return out


def gather_rows_floor(table: torch.Tensor, idx: torch.Tensor,
                      out: torch.Tensor) -> None:
    """The launch floor of :func:`gather_rows` on these tensors (CUDA only,
    for measurement): an empty kernel on the grid, block and shared memory
    that ``gather_rows`` would launch, writing nothing.  Not counted in
    ``kernels.LAUNCHES``."""
    B, W = table.shape
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _lib().ptt_gather_rows_floor(table.data_ptr(), B, W, idx.data_ptr(),
                                       idx.shape[0], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"CUDA launch of the gather_rows floor failed with "
                           f"error {err}")
