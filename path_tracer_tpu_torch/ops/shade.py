"""Scene capability flags + batched texture evaluation.

Port of ``SceneFlags`` (``ops/shade.py:41-92``), ``_atlas_rows`` (:107) and
``eval_texture_batched`` (:188) of the JAX package: solid, checker, image
atlas (nearest texel, clamped UV, V flipped) and Perlin marble.  The JAX
function compacts the expensive families into small buffers because masked
TPU lanes pay full width; here every family is a plain masked gather — the
results on the selected lanes are the same.  The CUDA shade kernel carries
this math in ``csrc/texture.cuh``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import perlin
from .types import (MAT_EMISSIVE, MAT_SSS_SIMPLE, MAT_SSS_VOLUMETRIC,
                    TEX_CHECKER, TEX_IMAGE, TEX_NOISE, SceneArrays)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass(frozen=True)
class SceneFlags:
    """Which shading families the scene uses (host-side, per scene)."""

    has_noise: bool = True
    has_image: bool = True
    has_medium: bool = True
    has_sss: bool = True
    has_noise_emission: bool = True
    has_noise_medium: bool = True
    has_image_emission: bool = True
    has_image_medium: bool = True

    @classmethod
    def from_scene(cls, scene: SceneArrays) -> "SceneFlags":
        tex_t = _np(scene.tex_type)
        mat_t = _np(scene.mat_type)
        mat_tex = _np(scene.mat_tex)
        med_tex = _np(scene.med_tex)
        emissive_tex = mat_tex[mat_t == MAT_EMISSIVE]
        return cls(
            has_noise=bool((tex_t == TEX_NOISE).any()),
            has_image=bool((tex_t == TEX_IMAGE).any()),
            has_medium=bool(
                (_np(scene.sph_medium) >= 0).any()
                or (_np(scene.qd_medium) >= 0).any()
                or (_np(scene.tr_medium) >= 0).any()),
            has_sss=bool(((mat_t == MAT_SSS_SIMPLE)
                          | (mat_t == MAT_SSS_VOLUMETRIC)).any()),
            has_noise_emission=bool((tex_t[emissive_tex] == TEX_NOISE).any())
            if emissive_tex.size else False,
            has_noise_medium=bool((tex_t[med_tex] == TEX_NOISE).any())
            if med_tex.size else False,
            has_image_emission=bool((tex_t[emissive_tex] == TEX_IMAGE).any())
            if emissive_tex.size else False,
            has_image_medium=bool((tex_t[med_tex] == TEX_IMAGE).any())
            if med_tex.size else False,
        )


def _atlas_rows(scene: SceneArrays, ii, y, x):
    """Texel fetch as a row gather from the flat (N*H*W, 3) atlas view."""
    H, W = scene.img_data.shape[1], scene.img_data.shape[2]
    flat = scene.img_data.reshape(-1, 3)
    return flat[((ii * H + y) * W + x).long()]


def eval_texture_batched(scene: SceneArrays, flags: SceneFlags, tex_idx,
                         u, v, p, allow_noise: bool = True,
                         allow_image: bool = True):
    """Texture colours for (R,) hits → (R, 3), every lane evaluated."""
    ti = torch.clamp(tex_idx, 0, scene.tex_type.shape[0] - 1).long()
    ttype = scene.tex_type[ti]
    c1 = scene.tex_c1[ti]
    c2 = scene.tex_c2[ti]
    scale = scene.tex_scale[ti]
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    out = c1

    lat = (torch.floor(scale * px) + torch.floor(scale * py)
           + torch.floor(scale * pz))
    even = (lat.to(torch.int32) % 2) == 0
    is_ck = ttype == TEX_CHECKER
    out = torch.where(is_ck[:, None], torch.where(even[:, None], c1, c2), out)

    if flags.has_image and allow_image:
        img_idx = scene.tex_img[ti]
        ii = torch.clamp(img_idx, 0, scene.img_data.shape[0] - 1)
        hw = scene.img_hw[ii.long()]
        h, w = hw[:, 0], hw[:, 1]
        x = torch.minimum(torch.clamp(
            (torch.clamp(u, 0.0, 1.0) * w).to(torch.int32), min=0), w - 1)
        y = torch.minimum(torch.clamp(
            ((1.0 - torch.clamp(v, 0.0, 1.0)) * h).to(torch.int32), min=0),
            h - 1)
        tex = _atlas_rows(scene, ii, y, x)
        out = torch.where((ttype == TEX_IMAGE)[:, None], tex, out)

    if flags.has_noise and allow_noise:
        turbv = perlin.turb_t(scene.perlin_vec, scene.perlin_perm,
                              px, py, pz, depth=7)
        marble = 0.5 * (1.0 + torch.sin(scale * pz + 10.0 * turbv))
        out = torch.where((ttype == TEX_NOISE)[:, None],
                          marble[:, None].expand(-1, 3), out)
    return out
