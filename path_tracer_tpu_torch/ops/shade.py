"""Scene capability flags, texture evaluation, per-lane emission and scatter.

Port of ``SceneFlags`` (``ops/shade.py:41-92``), ``sample_image`` (:95),
``_atlas_rows`` (:107), ``eval_texture`` (:120), ``eval_texture_batched``
(:188), ``emitted`` (:439) and ``scatter`` (:450) of the JAX package: solid,
checker, image atlas (nearest texel, clamped UV, V flipped) and Perlin
marble.  The JAX function compacts the expensive families into small
buffers because masked TPU lanes pay full width; here every family is a
plain masked gather — the results on the selected lanes are the same.  The
per-lane functions keep the JAX signatures over a batch of lanes and share
the component math of :mod:`.shade_tiled`.  The CUDA kernels carry this
math in ``csrc/texture.cuh`` and ``csrc/bounce.cuh``.
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
    return flat.index_select(0, (ii * H + y) * W + x)


def sample_image(scene: SceneArrays, img_idx, u, v):
    """Nearest-texel image lookup: clamp UV, flip V → (N, 3)."""
    ii = torch.clamp(img_idx, 0, scene.img_data.shape[0] - 1)
    hw = scene.img_hw.index_select(0, ii)
    h, w = hw[:, 0], hw[:, 1]
    x = torch.minimum(torch.clamp(
        (torch.clamp(u, 0.0, 1.0) * w).to(torch.int32), min=0), w - 1)
    y = torch.minimum(torch.clamp(
        ((1.0 - torch.clamp(v, 0.0, 1.0)) * h).to(torch.int32), min=0), h - 1)
    return _atlas_rows(scene, ii, y, x)


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
        tex = sample_image(scene, scene.tex_img[ti], u, v)
        out = torch.where((ttype == TEX_IMAGE)[:, None], tex, out)

    if flags.has_noise and allow_noise:
        turbv = perlin.turb_t(scene.perlin_vec, scene.perlin_perm,
                              px, py, pz, depth=7)
        marble = 0.5 * (1.0 + torch.sin(scale * pz + 10.0 * turbv))
        out = torch.where((ttype == TEX_NOISE)[:, None],
                          marble[:, None].expand(-1, 3), out)
    return out


# The per-lane texture dispatch of JAX is the batched one over N lanes.
eval_texture = eval_texture_batched


def emitted(scene: SceneArrays, flags: SceneFlags, mat_idx, u, v, p):
    """Emission of the hit material (zero unless emissive) → (N, 3)."""
    mi = torch.clamp(mat_idx, 0, scene.mat_type.shape[0] - 1).long()
    is_emissive = scene.mat_type[mi] == MAT_EMISSIVE
    tex = eval_texture(scene, flags, scene.mat_tex[mi], u, v, p,
                       allow_noise=flags.has_noise_emission,
                       allow_image=flags.has_image_emission)
    return torch.where(is_emissive[:, None], tex, torch.zeros_like(tex))


def scatter(scene: SceneArrays, flags: SceneFlags, cfg_sss_steps: int,
            hit_mat, hit_p, hit_n, hit_front, hit_u, hit_v, ray_dir, key,
            albedo=None):
    """Sample the BSDF / phase function for N hits with keys ``key`` (N, 2).

    Returns ``(scattered, new_origin, new_direction, attenuation)`` like the
    JAX per-lane ``scatter``: the draws are ``uniform(key, (8,))`` and, for
    the SSS walk, ``uniform(fold_in(key, 1), (steps, 6))``.
    """
    from . import shade_tiled as st
    from ..utils import rng

    mat = st.mat_table(scene)
    if albedo is None:
        mi = torch.clamp(hit_mat, 0, mat.shape[0] - 1).long()
        albedo = eval_texture(scene, flags, scene.mat_tex[mi], hit_u, hit_v,
                              hit_p)
    comps = lambda x: tuple(x.unbind(-1))  # noqa: E731
    rec = st.HitT(hit=None, t=None, p=comps(hit_p), n=comps(hit_n),
                  front=hit_front, u=hit_u, v=hit_v, mat=hit_mat, medium=None)
    tabs = st.ShadeTables(prim=None, mat=mat, med=None, tex=None, n_sph=0,
                          n_qd=0)
    sss_keys = rng.fold_in(key, 1) if flags.has_sss else None
    scattered, o, d, att, _mrow, _ws = st.scatter_t(
        scene, flags, cfg_sss_steps, tabs, rec, *comps(ray_dir),
        rng.uniform(key, (8,)).unbind(-1), sss_keys, comps(albedo))
    return (scattered, torch.stack(o, -1), torch.stack(d, -1),
            torch.stack(att, -1))
