"""Scene compiler: host object graph → :class:`SceneArrays` pytree.

Port of ``path_tracer_tpu/models/compile.py`` (reference
scene_compiler.py:931-965): the same numpy packing, emitting torch
:class:`SceneArrays` on the requested device:

* materials/textures are deduplicated **by object identity** into single
  tables (the reference dedups images by ``id()`` too, scene_compiler.py:812);
* meshes and Klein bottles flatten to triangles (scene_compiler.py:124-127);
* each constant-medium boundary primitive gets a ``medium`` index
  (scene_compiler.py:854-928's registry);
* all arrays are padded to power-of-two buckets (no MAX_* caps).

Dispatch is on concrete types, not class-name strings (the reference matches
``material.__class__.__name__`` — scene_compiler.py:254-439).
"""
from __future__ import annotations

import numpy as np

from ..ops import types as T
from ..utils import perlin as perlin_mod
from . import geometry as G
from . import materials as M
from . import textures as X


def _flatten_prims(obj, medium_idx, out, mediums):
    """Recursive walk collecting (prim, medium_idx) pairs per type."""
    if isinstance(obj, G.HittableList):
        for o in obj.objects:
            _flatten_prims(o, medium_idx, out, mediums)
    elif isinstance(obj, G.ConstantMedium):
        idx = len(mediums)
        mediums.append(obj)
        _flatten_prims(obj.boundary, idx, out, mediums)
    elif isinstance(obj, G.Sphere):
        out["sphere"].append((obj, medium_idx))
    elif isinstance(obj, G.Quad):
        out["quad"].append((obj, medium_idx))
    elif isinstance(obj, G.Triangle):
        out["triangle"].append((obj, medium_idx))
    elif isinstance(obj, (G.Mesh, G.KleinBottle)):
        for tri in obj.triangles:
            out["triangle"].append((tri, medium_idx))
    elif isinstance(obj, G.TriangleSoup):
        # Bulk block: stays vectorised through packing (no per-face objects).
        out["trisoup"].append((obj, medium_idx))
    else:
        raise TypeError(f"Unknown hittable: {type(obj).__name__}")


class _TextureTable:
    def __init__(self):
        self.by_id: dict[int, int] = {}
        self.rows: list[tuple] = []       # (type, c1, c2, scale, img_idx)
        self.images: list[np.ndarray] = []
        self.img_by_id: dict[int, int] = {}

    def add(self, tex: X.Texture) -> int:
        key = id(tex)
        if key in self.by_id:
            return self.by_id[key]
        zero = np.zeros(3, dtype=np.float32)
        if isinstance(tex, X.SolidColor):
            row = (T.TEX_SOLID, tex.albedo, zero, 0.0, -1)
        elif isinstance(tex, X.CheckerTexture):
            # Store inv_scale like texture.py:42.
            row = (T.TEX_CHECKER, tex.even, tex.odd, 1.0 / tex.scale, -1)
        elif isinstance(tex, X.ImageTexture):
            if tex.loaded:
                ikey = id(tex.data)
                if ikey not in self.img_by_id:
                    self.img_by_id[ikey] = len(self.images)
                    self.images.append(np.asarray(tex.data, dtype=np.float32))
                row = (T.TEX_IMAGE, zero, zero, 0.0, self.img_by_id[ikey])
            else:
                # Magenta fallback (rtw_image.py:120-127).
                row = (T.TEX_SOLID, np.array([1.0, 0.0, 1.0], np.float32), zero, 0.0, -1)
        elif isinstance(tex, X.NoiseTexture):
            row = (T.TEX_NOISE, zero, zero, float(tex.scale), -1)
        else:
            raise TypeError(f"Unknown texture: {type(tex).__name__}")
        self.by_id[key] = len(self.rows)
        self.rows.append(row)
        return self.by_id[key]


class _MaterialTable:
    def __init__(self, textures: _TextureTable):
        self.tex = textures
        # The compiler's own textures live as long as the table: rows are
        # deduplicated by id(), and the id of a freed temporary can be
        # handed to the next one, which made the table's rows depend on
        # the allocator (the JAX compiler creates a temporary per call).
        self.white = X.SolidColor((1, 1, 1))
        self.gray = X.SolidColor((0.5, 0.5, 0.5))
        self.by_id: dict[int, int] = {}
        self.rows: list[dict] = []

    def add(self, mat: M.Material) -> int:
        key = id(mat)
        if key in self.by_id:
            return self.by_id[key]
        row = dict(type=T.MAT_LAMBERTIAN, tex=0, fuzz=0.0, ir=1.0, g=0.0,
                   sigma_s=0.0, sigma_a=0.0, scatter_dist=0.0)
        if isinstance(mat, M.Lambertian):
            row.update(type=T.MAT_LAMBERTIAN, tex=self.tex.add(mat.tex))
        elif isinstance(mat, M.Metal):
            row.update(type=T.MAT_METAL, tex=self.tex.add(mat.albedo), fuzz=mat.fuzz)
        elif isinstance(mat, M.Dielectric):
            row.update(type=T.MAT_DIELECTRIC, tex=self.tex.add(self.white),
                       ir=float(mat.ir))
        elif isinstance(mat, M.DiffuseLight):
            row.update(type=T.MAT_EMISSIVE, tex=self.tex.add(mat.tex))
        elif isinstance(mat, M.Isotropic):
            row.update(type=T.MAT_ISOTROPIC, tex=self.tex.add(mat.tex))
        elif isinstance(mat, M.SubsurfaceSimple):
            row.update(type=T.MAT_SSS_SIMPLE, tex=self.tex.add(mat.albedo),
                       scatter_dist=mat.scatter_distance)
        elif isinstance(mat, M.SubsurfaceVolumetric):
            row.update(type=T.MAT_SSS_VOLUMETRIC, tex=self.tex.add(mat.albedo),
                       g=mat.g, sigma_s=mat.sigma_s, sigma_a=mat.sigma_a)
        else:
            # Unknown materials degrade to gray Lambertian, matching
            # scene_compiler.py:406-417's fallback.
            row.update(type=T.MAT_LAMBERTIAN,
                       tex=self.tex.add(self.gray))
        self.by_id[key] = len(self.rows)
        self.rows.append(row)
        return self.by_id[key]


def _pad2(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad leading axis to n with ``fill``."""
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def compile_scene(world: G.Hittable, perlin_seed: int = 0,
                  device="cuda") -> T.SceneArrays:
    """Flatten the object graph into padded SoA tensors on ``device``."""
    import torch

    def asarray(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    prims = {"sphere": [], "quad": [], "triangle": [], "trisoup": []}
    mediums: list[G.ConstantMedium] = []
    _flatten_prims(world, -1, prims, mediums)

    textures = _TextureTable()
    mats = _MaterialTable(textures)

    # Medium table first so boundary prims can reference it.
    med_density = np.asarray([m.density for m in mediums] or [1.0], np.float32)
    med_tex = np.asarray([textures.add(m.tex) for m in mediums] or [0], np.int32)

    # --- spheres ---
    ns = len(prims["sphere"])
    sph_c0 = np.zeros((ns, 3), np.float32)
    sph_c1 = np.zeros((ns, 3), np.float32)
    sph_rad = np.zeros((ns,), np.float32)
    sph_mat = np.zeros((ns,), np.int32)
    sph_med = np.full((ns,), -1, np.int32)
    for i, (s, med) in enumerate(prims["sphere"]):
        sph_c0[i] = s.center0
        sph_c1[i] = s.center1
        sph_rad[i] = s.radius
        sph_mat[i] = mats.add(s.material)
        sph_med[i] = med

    # --- quads (cached plane data, quad.py:15-33) ---
    nq = len(prims["quad"])
    qd_q = np.zeros((nq, 3), np.float32)
    qd_u = np.zeros((nq, 3), np.float32)
    qd_v = np.zeros((nq, 3), np.float32)
    qd_n = np.zeros((nq, 3), np.float32)
    qd_w = np.zeros((nq, 3), np.float32)
    qd_d = np.zeros((nq,), np.float32)
    qd_mat = np.zeros((nq,), np.int32)
    qd_med = np.full((nq,), -1, np.int32)
    for i, (q, med) in enumerate(prims["quad"]):
        n_raw = np.cross(q.u.astype(np.float64), q.v.astype(np.float64))
        nn = n_raw / max(np.linalg.norm(n_raw), 1e-12)
        qd_q[i], qd_u[i], qd_v[i] = q.q, q.u, q.v
        qd_n[i] = nn
        qd_w[i] = n_raw / max(float(np.dot(n_raw, n_raw)), 1e-12)
        qd_d[i] = float(np.dot(nn, q.q.astype(np.float64)))
        qd_mat[i] = mats.add(q.material)
        qd_med[i] = med

    # --- triangles (precomputed edges + normal, triangle.py:20-41) ---
    nt = len(prims["triangle"])
    tr_v0 = np.zeros((nt, 3), np.float32)
    tr_e1 = np.zeros((nt, 3), np.float32)
    tr_e2 = np.zeros((nt, 3), np.float32)
    tr_n = np.zeros((nt, 3), np.float32)
    tr_mat = np.zeros((nt,), np.int32)
    tr_med = np.full((nt,), -1, np.int32)
    for i, (t, med) in enumerate(prims["triangle"]):
        v0 = t.v0.astype(np.float64)
        e1 = t.v1.astype(np.float64) - v0
        e2 = t.v2.astype(np.float64) - v0
        n_raw = np.cross(e1, e2)
        tr_v0[i], tr_e1[i], tr_e2[i] = v0, e1, e2
        tr_n[i] = n_raw / max(np.linalg.norm(n_raw), 1e-12)
        tr_mat[i] = mats.add(t.material)
        tr_med[i] = med

    # --- bulk triangle blocks (TriangleSoup): vectorised packing ---
    if prims["trisoup"]:
        blocks = [(tr_v0, tr_e1, tr_e2, tr_n, tr_mat, tr_med)]
        for soup, med in prims["trisoup"]:
            v0 = soup.v0
            e1 = soup.v1 - v0
            e2 = soup.v2 - v0
            n_raw = np.cross(e1, e2)
            nrm = np.maximum(np.linalg.norm(n_raw, axis=-1, keepdims=True),
                             1e-12)
            m = mats.add(soup.material)
            k = len(soup)
            blocks.append((v0.astype(np.float32), e1.astype(np.float32),
                           e2.astype(np.float32),
                           (n_raw / nrm).astype(np.float32),
                           np.full((k,), m, np.int32),
                           np.full((k,), med, np.int32)))
        tr_v0, tr_e1, tr_e2, tr_n, tr_mat, tr_med = (
            np.concatenate([b[j] for b in blocks], axis=0) for j in range(6))
        nt = tr_v0.shape[0]

    # --- tables → arrays ---
    if not mats.rows:  # empty scene still needs one row
        mats.add(M.Lambertian((0.5, 0.5, 0.5)))
    mat_rows = mats.rows
    tex_rows = textures.rows

    tex_type = np.asarray([r[0] for r in tex_rows], np.int32)
    tex_c1 = np.stack([r[1] for r in tex_rows]).astype(np.float32)
    tex_c2 = np.stack([r[2] for r in tex_rows]).astype(np.float32)
    tex_scale = np.asarray([r[3] for r in tex_rows], np.float32)
    tex_img = np.asarray([r[4] for r in tex_rows], np.int32)

    if textures.images:
        hmax = max(im.shape[0] for im in textures.images)
        wmax = max(im.shape[1] for im in textures.images)
        img_data = np.zeros((len(textures.images), hmax, wmax, 3), np.float32)
        img_hw = np.zeros((len(textures.images), 2), np.int32)
        for i, im in enumerate(textures.images):
            img_data[i, : im.shape[0], : im.shape[1]] = im
            img_hw[i] = (im.shape[0], im.shape[1])
    else:
        img_data = np.zeros((1, 1, 1, 3), np.float32)
        img_hw = np.ones((1, 2), np.int32)

    ranvec, perm = perlin_mod.make_tables(perlin_seed)

    # --- pad to buckets ---
    Ns, Nq, Nt = (T.pad_to(n) for n in (ns, nq, nt))
    Nm = T.pad_to(len(mat_rows), 4)
    Ntex = T.pad_to(len(tex_rows), 4)
    Nmed = T.pad_to(len(mediums), 2)

    f = lambda name, default=0.0: np.asarray(  # noqa: E731
        [r[name] for r in mat_rows], np.float32
    )

    valid = lambda n, N: _pad2(np.ones((n,), bool), N, False)  # noqa: E731

    return T.SceneArrays(
        sph_c0=asarray(_pad2(sph_c0, Ns)),
        sph_c1=asarray(_pad2(sph_c1, Ns)),
        sph_rad=asarray(_pad2(sph_rad, Ns)),
        sph_mat=asarray(_pad2(sph_mat, Ns)),
        sph_valid=asarray(valid(ns, Ns)),
        qd_q=asarray(_pad2(qd_q, Nq)),
        qd_u=asarray(_pad2(qd_u, Nq)),
        qd_v=asarray(_pad2(qd_v, Nq)),
        qd_n=asarray(_pad2(qd_n, Nq)),
        qd_w=asarray(_pad2(qd_w, Nq)),
        qd_d=asarray(_pad2(qd_d, Nq)),
        qd_mat=asarray(_pad2(qd_mat, Nq)),
        qd_valid=asarray(valid(nq, Nq)),
        tr_v0=asarray(_pad2(tr_v0, Nt)),
        tr_e1=asarray(_pad2(tr_e1, Nt)),
        tr_e2=asarray(_pad2(tr_e2, Nt)),
        tr_n=asarray(_pad2(tr_n, Nt)),
        tr_mat=asarray(_pad2(tr_mat, Nt)),
        tr_valid=asarray(valid(nt, Nt)),
        mat_type=asarray(_pad2(np.asarray([r["type"] for r in mat_rows], np.int32), Nm)),
        mat_tex=asarray(_pad2(np.asarray([r["tex"] for r in mat_rows], np.int32), Nm)),
        mat_fuzz=asarray(_pad2(f("fuzz"), Nm)),
        mat_ir=asarray(_pad2(f("ir"), Nm, 1.0)),
        mat_g=asarray(_pad2(f("g"), Nm)),
        mat_sigma_s=asarray(_pad2(f("sigma_s"), Nm)),
        mat_sigma_a=asarray(_pad2(f("sigma_a"), Nm)),
        mat_scatter_dist=asarray(_pad2(f("scatter_dist"), Nm)),
        tex_type=asarray(_pad2(tex_type, Ntex)),
        tex_c1=asarray(_pad2(tex_c1, Ntex)),
        tex_c2=asarray(_pad2(tex_c2, Ntex)),
        tex_scale=asarray(_pad2(tex_scale, Ntex)),
        tex_img=asarray(_pad2(tex_img, Ntex, -1)),
        img_data=asarray(img_data),
        img_hw=asarray(img_hw),
        sph_medium=asarray(_pad2(sph_med, Ns, -1)),
        qd_medium=asarray(_pad2(qd_med, Nq, -1)),
        tr_medium=asarray(_pad2(tr_med, Nt, -1)),
        med_density=asarray(_pad2(med_density, Nmed, 1.0)),
        med_tex=asarray(_pad2(med_tex, Nmed)),
        perlin_vec=asarray(ranvec),
        perlin_perm=asarray(perm),
    )
