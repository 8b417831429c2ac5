"""ctypes bridge to the native C++ SAH BVH builder (``native/bvh_builder.cpp``).

Port of ``path_tracer_tpu/ops/bvh_native.py`` with one difference: the
committed ``native/libbvh.so`` is only ever *opened*, never rewritten.  When
it is missing or its ABI version is not ours, the source is compiled into
the port's git-ignored build directory (``build/torch_ext/``) instead.  If
no toolchain is present the numpy builder is used.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libbvh.so")
_BUILD_DIR = os.path.join(_REPO, "build", "torch_ext")
_BUILT_SO = os.path.join(_BUILD_DIR, "libbvh_port.so")

_ABI_VERSION = 2  # ptt_abi_version() in bvh_builder.cpp


def _compile() -> bool:
    src = os.path.join(_NATIVE_DIR, "bvh_builder.cpp")
    if not os.path.exists(src):
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", _BUILT_SO,
             src], check=True, capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _open_checked(path):
    """CDLL ``path`` only if its ABI version matches (None otherwise)."""
    try:
        lib = ctypes.CDLL(path)
        lib.ptt_abi_version.restype = ctypes.c_int32
        if lib.ptt_abi_version() != _ABI_VERSION:
            return None
        return lib
    except (OSError, AttributeError):
        return None


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    lib = _open_checked(_SO_PATH) if os.path.exists(_SO_PATH) else None
    if lib is None and os.path.exists(_BUILT_SO):
        lib = _open_checked(_BUILT_SO)
    if lib is None and _compile():
        lib = _open_checked(_BUILT_SO)
    if lib is None:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.ptt_build_bvh.argtypes = [f32p, f32p, i32p, i32p, ctypes.c_int32,
                                  f32p, f32p, i32p, i32p, i32p, i32p,
                                  ctypes.c_int32, ctypes.c_float]
    lib.ptt_build_bvh.restype = ctypes.c_int32
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def build_bvh_native(types: np.ndarray, idxs: np.ndarray, bb_min: np.ndarray,
                     bb_max: np.ndarray, leaf_cap: int = 1,
                     leaf_ratio: float = 0.0):
    """Native build → the flat arrays of ``bvh_build.build_bvh``, or None."""
    lib = _load()
    if lib is None:
        return None
    n = int(types.shape[0])
    cap = 2 * n - 1
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    left = np.full(cap, -1, np.int32)
    right = np.full(cap, -1, np.int32)
    ptype = np.full(cap, -1, np.int32)
    pidx = np.full(cap, -1, np.int32)
    used = lib.ptt_build_bvh(
        np.ascontiguousarray(bb_min, np.float32),
        np.ascontiguousarray(bb_max, np.float32),
        np.ascontiguousarray(types, np.int32),
        np.ascontiguousarray(idxs, np.int32), n,
        node_min, node_max, left, right, ptype, pidx,
        int(leaf_cap), float(leaf_ratio))
    if used != cap:
        return None
    return node_min, node_max, left, right, ptype, pidx
