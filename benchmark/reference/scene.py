"""The reference's own scene arrays, compiled from a scene description.

Primitives keep the description's order within each family (spheres,
quads, triangles).  Two tables per primitive, both float rows:

* the hit-test row (``RefScene.test``): a sphere's centre at time 0, its
  motion and its squared radius; a quad's unit normal ``n``, its planar
  rows ``A = v x w`` and ``B = w x u`` (``w = n_raw / |n_raw|^2``) and the
  offsets ``n.Q``, ``A.Q``, ``B.Q``, so that the hit distance and the
  quad's coordinates are affine in the distance; a triangle's ``v0`` and
  edges.  Derived quantities are worked out in float64 from the float32
  inputs and rounded once.
* the shading row (``RefScene.shade``): material, medium, the family's
  vectors, the unit normal, ``w`` and the plane offset.

Materials, textures and media are tables indexed from those rows; the
Perlin tables are those of the published marble texture (256 unit
gradients and three permutations from ``default_rng(0)``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MAT_KINDS = {"lambertian": 0, "metal": 1, "dielectric": 2, "light": 3,
             "isotropic": 4, "sss_simple": 5, "sss_volumetric": 6}
TEX_SOLID, TEX_IMAGE, TEX_NOISE = 0, 2, 3


@dataclass
class RefScene:
    test: tuple          # (sphere rows (S, 7), quad rows (Q, 12), tri rows (T, 9))
    shade: torch.Tensor  # (S+Q+T, 18)
    n_sph: int
    n_qd: int
    mat: torch.Tensor    # (M, 8): type, tex, fuzz, ir, g, sigma_s, sigma_a, dist
    med: torch.Tensor    # (Mv, 2): density, tex
    tex_type: torch.Tensor
    tex_c1: torch.Tensor
    tex_scale: torch.Tensor
    tex_img: torch.Tensor
    img_data: torch.Tensor
    img_hw: torch.Tensor
    perlin_vec: torch.Tensor
    perlin_perm: torch.Tensor
    has_medium: bool
    has_sss: bool
    has_noise: bool
    has_image: bool
    noise_in_light: bool
    image_in_light: bool
    noise_in_medium: bool
    image_in_medium: bool


def perlin_tables(seed: int = 0):
    rng = np.random.default_rng(seed)
    ranvec = rng.uniform(-1.0, 1.0, size=(256, 3)).astype(np.float32)
    ranvec /= np.maximum(np.linalg.norm(ranvec, axis=-1, keepdims=True), 1e-8)
    perm = np.stack([rng.permutation(256).astype(np.int32) for _ in range(3)])
    return ranvec, perm


def compile_desc(desc, device="cpu", dtype=torch.float32) -> RefScene:
    texs, tex_id = [], {}
    mats, mat_id = [], {}

    def add_tex(t):
        if id(t) not in tex_id:
            tex_id[id(t)] = len(texs)
            texs.append(t)
        return tex_id[id(t)]

    def add_mat(m):
        if id(m) not in mat_id:
            mat_id[id(m)] = len(mats)
            t = add_tex(m.tex) if m.tex is not None else -1
            mats.append([MAT_KINDS[m.kind], t, m.fuzz, m.ir, m.g, m.sigma_s,
                         m.sigma_a, m.scatter_dist])
        return mat_id[id(m)]

    media = [[m.density, add_tex(m.tex)] for m in desc.media] or [[1.0, 0]]
    fam = {k: [p for p in desc.prims if p.kind == k]
           for k in ("sphere", "quad", "triangle")}
    sph_t, qd_t, tr_t, shade = [], [], [], []
    for p in fam["sphere"]:
        c0, c1 = p.a.astype(np.float32), p.b.astype(np.float32)
        r = np.float32(p.radius)
        sph_t.append(np.concatenate([c0, c1 - c0, [r * r]]))
        shade.append(np.concatenate([[add_mat(p.mat), p.medium], c0, c1,
                                     [r], np.zeros(9)]))
    for p in fam["quad"]:
        q, u, v = (x.astype(np.float64) for x in (p.a, p.b, p.c))
        n_raw = np.cross(u, v)
        nn2 = max((n_raw * n_raw).sum(), 1e-30)
        n_hat, w = n_raw / np.sqrt(nn2), n_raw / nn2
        A, B = np.cross(v, w), np.cross(w, u)
        qd_t.append(np.concatenate([n_hat, A, B, [(n_hat * q).sum(),
                                                  (A * q).sum(),
                                                  (B * q).sum()]]))
        nn = n_raw / max(np.linalg.norm(n_raw), 1e-12)
        w_s = n_raw / max(float(np.dot(n_raw, n_raw)), 1e-12)
        shade.append(np.concatenate([[add_mat(p.mat), p.medium], p.a, p.b,
                                     p.c, nn.astype(np.float32),
                                     w_s.astype(np.float32),
                                     [np.float32(np.dot(nn, q))]]))
    for p in fam["triangle"]:
        v0 = p.a.astype(np.float64)
        e1 = (p.b.astype(np.float64) - v0).astype(np.float32)
        e2 = (p.c.astype(np.float64) - v0).astype(np.float32)
        n_raw = np.cross(p.b.astype(np.float64) - v0, p.c.astype(np.float64) - v0)
        n = (n_raw / max(np.linalg.norm(n_raw), 1e-12)).astype(np.float32)
        tr_t.append(np.concatenate([p.a, e1, e2]))
        shade.append(np.concatenate([[add_mat(p.mat), p.medium], p.a, e1, e2,
                                     n, np.zeros(4)]))

    images = [t.data for t in texs if t.kind == "image"]
    img_of = {id(t): i for i, t in enumerate(
        t for t in texs if t.kind == "image")}
    if images:
        hmax = max(im.shape[0] for im in images)
        wmax = max(im.shape[1] for im in images)
        img = np.zeros((len(images), hmax, wmax, 3), np.float32)
        for i, im in enumerate(images):
            img[i, :im.shape[0], :im.shape[1]] = im
        img_hw = np.asarray([im.shape[:2] for im in images], np.int32)
    else:
        img, img_hw = np.zeros((1, 1, 1, 3), np.float32), np.ones((1, 2), np.int32)
    kind_code = {"solid": TEX_SOLID, "image": TEX_IMAGE, "noise": TEX_NOISE}
    tex_type = np.asarray([kind_code[t.kind] for t in texs], np.int32)
    tex_c1 = np.stack([t.rgb if t.kind == "solid" else np.zeros(3, np.float32)
                       for t in texs]).astype(np.float32)
    tex_scale = np.asarray([t.scale for t in texs], np.float32)
    tex_img = np.asarray([img_of.get(id(t), -1) for t in texs], np.int32)
    ranvec, perm = perlin_tables(0)

    F = lambda a, n: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32).reshape(-1, n), device=device).to(dtype)
    I = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    mat_t = np.asarray([m[0] for m in mats])
    light_tex = [m[1] for m in mats if m[0] == MAT_KINDS["light"]]
    med_tex = [m[1] for m in media] if desc.media else []
    kinds = lambda idx: {int(tex_type[i]) for i in idx}  # noqa: E731
    return RefScene(
        test=(F(sph_t, 7), F(qd_t, 12), F(tr_t, 9)),
        shade=F(shade, 18), n_sph=len(fam["sphere"]), n_qd=len(fam["quad"]),
        mat=F(mats, 8), med=F(media, 2),
        tex_type=I(tex_type), tex_c1=F(tex_c1, 3), tex_scale=F(tex_scale, 1)[:, 0],
        tex_img=I(tex_img), img_data=torch.as_tensor(img, device=device).to(dtype),
        img_hw=I(img_hw), perlin_vec=F(ranvec, 3),
        perlin_perm=I(perm).to(torch.int64),
        has_medium=bool(desc.media) and any(p.medium >= 0 for p in desc.prims),
        has_sss=bool(np.isin(mat_t, (5, 6)).any()),
        has_noise=bool((tex_type == TEX_NOISE).any()),
        has_image=bool((tex_type == TEX_IMAGE).any()),
        noise_in_light=TEX_NOISE in kinds(light_tex),
        image_in_light=TEX_IMAGE in kinds(light_tex),
        noise_in_medium=TEX_NOISE in kinds(med_tex),
        image_in_medium=TEX_IMAGE in kinds(med_tex))
