"""Carry state from the JAX package into the port, without importing JAX.

The tests feed both packages identical inputs: they build a scene, BVH,
camera or key with the JAX package, turn each into numpy arrays, and hand
those to the functions below.  Each takes an object whose fields are
array-likes (numpy arrays, or anything ``np.asarray`` accepts) with the JAX
package's field names and returns the port's tensor container.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.types import CameraArrays, PackedBVH, SceneArrays


def _t(x, device):
    return torch.from_numpy(np.array(np.asarray(x))).to(device)


def _convert(cls, obj, device, **static):
    names = [f.name for f in dataclasses.fields(cls) if f.name not in static]
    return cls(**{n: _t(getattr(obj, n), device) for n in names}, **static)


def from_numpy_scene(scene, device="cuda") -> SceneArrays:
    """JAX ``SceneArrays`` (or any object with its fields) → port tensors."""
    return _convert(SceneArrays, scene, device)


def from_numpy_bvh(bvh, device="cuda") -> PackedBVH:
    """JAX ``PackedBVH`` → port ``PackedBVH`` (static metadata copied)."""
    return _convert(PackedBVH, bvh, device,
                    prim_mask=tuple(bool(b) for b in bvh.prim_mask),
                    max_stack=int(bvh.max_stack),
                    branching=int(bvh.branching))


def from_numpy_camera(cam, device="cuda") -> CameraArrays:
    """JAX ``CameraArrays`` → port tensors."""
    return _convert(CameraArrays, cam, device)


def key_from_data(data, device="cuda") -> torch.Tensor:
    """``jax.random.key_data(k)`` words (uint32[2]) → the port's key."""
    d = np.asarray(data).astype(np.uint64).astype(np.int64).reshape(2)
    return torch.from_numpy(d).to(device)
