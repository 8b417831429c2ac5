"""Host-side scene geometry (user-facing scene API).

Mirrors the capability surface of ``reference core/``: Sphere
(stationary + moving, sphere.py:8-74), Quad (quad.py:11-68), Triangle
(triangle.py:10-100), Mesh/OBJ (mesh.py:20-294), Box helper
(scenes.py:961-1024 with optional Y-rotation), ConstantMedium
(constant_medium.py:11-59), KleinBottle (klein_bottle.py:7-185), and
HittableList (hittable_list.py:6-32).

These are *descriptions only* — no ``hit()`` methods.  The single source of
intersection truth is the device code in :mod:`path_tracer_tpu_torch.ops`; the scene
compiler (:mod:`.compile`) flattens this object graph into a
:class:`~path_tracer_tpu_torch.ops.types.SceneArrays` tensors, which both the GPU
engines and the brute-force CPU oracle consume.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np

from .materials import Material


@dataclass
class Hittable:
    pass


@dataclass
class HittableList(Hittable):
    """Flat container (hittable_list.py:6-32)."""

    objects: list = field(default_factory=list)

    def add(self, obj: Hittable) -> None:
        self.objects.append(obj)


@dataclass
class Sphere(Hittable):
    """Sphere with optional linear motion (sphere.py:8-35).

    ``center0``/``center1`` are the centers at time 0 and 1; the intersector
    lerps by ray time, which makes motion blur work on-device (the reference
    drops motion on GPU, scene_compiler.py:161-166).
    """

    center0: np.ndarray
    center1: np.ndarray
    radius: float
    material: Material

    @classmethod
    def stationary(cls, center, radius: float, mat: Material) -> "Sphere":
        c = np.asarray(center, dtype=np.float32)
        return cls(c, c.copy(), float(radius), mat)

    @classmethod
    def moving(cls, center0, center1, radius: float, mat: Material) -> "Sphere":
        return cls(
            np.asarray(center0, dtype=np.float32),
            np.asarray(center1, dtype=np.float32),
            float(radius),
            mat,
        )


@dataclass
class Quad(Hittable):
    """Parallelogram: corner Q + edge vectors u, v (quad.py:11-33)."""

    q: np.ndarray
    u: np.ndarray
    v: np.ndarray
    material: Material

    def __init__(self, q, u, v, mat: Material):
        self.q = np.asarray(q, dtype=np.float32)
        self.u = np.asarray(u, dtype=np.float32)
        self.v = np.asarray(v, dtype=np.float32)
        self.material = mat


@dataclass
class Triangle(Hittable):
    """Single triangle (triangle.py:10-53)."""

    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    material: Material

    def __init__(self, v0, v1, v2, mat: Material):
        self.v0 = np.asarray(v0, dtype=np.float32)
        self.v1 = np.asarray(v1, dtype=np.float32)
        self.v2 = np.asarray(v2, dtype=np.float32)
        self.material = mat


@dataclass
class ConstantMedium(Hittable):
    """Volumetric fog/smoke inside a boundary (constant_medium.py:11-59)."""

    boundary: Hittable
    density: float
    tex: object  # Texture

    def __init__(self, boundary: Hittable, density: float, albedo_or_tex):
        from .textures import as_texture

        self.boundary = boundary
        self.density = float(density)
        self.tex = as_texture(albedo_or_tex)

    @classmethod
    def from_color(cls, boundary, albedo, density):
        return cls(boundary, density, albedo)

    @classmethod
    def from_texture(cls, boundary, tex, density):
        return cls(boundary, density, tex)


def box(a, b, mat: Material, angle: float = 0.0) -> HittableList:
    """Axis-aligned box as 6 quads with optional Y-rotation about its center
    (scenes.py:961-1024).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mn = np.minimum(a, b)
    mx = np.maximum(a, b)
    dx = np.array([mx[0] - mn[0], 0.0, 0.0])
    dy = np.array([0.0, mx[1] - mn[1], 0.0])
    dz = np.array([0.0, 0.0, mx[2] - mn[2]])

    theta = math.radians(angle)
    c, s = math.cos(theta), math.sin(theta)
    center = 0.5 * (mn + mx)

    def rot_v(v):
        return np.array([c * v[0] + s * v[2], v[1], -s * v[0] + c * v[2]])

    def rot_p(p):
        return rot_v(p - center) + center

    if angle == 0.0:
        rot_v = lambda v: v  # noqa: E731
        rot_p = lambda p: p  # noqa: E731

    sides = HittableList()
    P = lambda x, y, z: np.array([x, y, z])  # noqa: E731
    sides.add(Quad(rot_p(P(mn[0], mn[1], mx[2])), rot_v(dx), rot_v(dy), mat))   # front
    sides.add(Quad(rot_p(P(mx[0], mn[1], mx[2])), rot_v(-dz), rot_v(dy), mat))  # right
    sides.add(Quad(rot_p(P(mx[0], mn[1], mn[2])), rot_v(-dx), rot_v(dy), mat))  # back
    sides.add(Quad(rot_p(P(mn[0], mn[1], mn[2])), rot_v(dz), rot_v(dy), mat))   # left
    sides.add(Quad(rot_p(P(mn[0], mx[1], mx[2])), rot_v(dx), rot_v(-dz), mat))  # top
    sides.add(Quad(rot_p(P(mn[0], mn[1], mn[2])), rot_v(dx), rot_v(dz), mat))   # bottom
    return sides


@dataclass
class Mesh(Hittable):
    """Triangle mesh loaded from an OBJ file (mesh.py:20-294).

    Own minimal OBJ parser (v / f records, fan triangulation of n-gons,
    degenerate-triangle skipping) — the reference depends on PyWavefront,
    which is deliberately not required here.  ``scale``/``offset`` transform
    vertices like mesh.py:207 ``_extract_vertex``.
    """

    triangles: list

    def __init__(self, path: str, mat: Material, scale: float = 1.0, offset=(0.0, 0.0, 0.0)):
        obj_file = self._find_obj_file(path)
        verts, faces = self._parse_obj(obj_file)
        off = np.asarray(offset, dtype=np.float64)
        verts = verts * float(scale) + off
        self.triangles = []
        for face in faces:
            # Fan triangulation (mesh.py:131).
            for k in range(1, len(face) - 1):
                v0, v1, v2 = verts[face[0]], verts[face[k]], verts[face[k + 1]]
                # Skip degenerate triangles (mesh.py:141,225).
                if np.linalg.norm(np.cross(v1 - v0, v2 - v0)) < 1e-12:
                    continue
                self.triangles.append(Triangle(v0, v1, v2, mat))

    @staticmethod
    def _find_obj_file(path: str) -> str:
        """Accept a direct .obj path or a folder to search (mesh.py:63);
        also resolves repo-root-relative paths from any cwd."""
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        for cand in (path, os.path.join(pkg_root, path)):
            if os.path.isfile(cand):
                return cand
            if os.path.isdir(cand):
                for root, _dirs, files in os.walk(cand):
                    for f in sorted(files):
                        if f.lower().endswith(".obj"):
                            return os.path.join(root, f)
        raise FileNotFoundError(f"No .obj file found at {path!r}")

    @staticmethod
    def _parse_obj(path: str):
        verts = []
        faces = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "v" and len(parts) >= 4:
                    verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
                elif parts[0] == "f" and len(parts) >= 4:
                    idx = []
                    for tok in parts[1:]:
                        i = int(tok.split("/")[0])
                        idx.append(i - 1 if i > 0 else len(verts) + i)
                    faces.append(idx)
        return np.asarray(verts, dtype=np.float64), faces


@dataclass
class TriangleSoup(Hittable):
    """Bulk triangle container: (N, 3) vertex arrays + one shared material.

    The scale path the reference cannot reach: its mesh pipeline builds one
    Python ``triangle`` object per face and hits a hard 4,096-triangle GPU
    cap (``fields.py:15`` MAX_TRIANGLES; ``mesh.py:20-294``).  Here the
    vertices stay as three (N, 3) numpy blocks end-to-end — the compiler
    packs them vectorised (no per-face Python objects), and the capless
    padded-bucket ``SceneArrays`` takes any N.
    """

    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    material: Material

    def __init__(self, v0, v1, v2, mat: Material):
        v0 = np.asarray(v0, dtype=np.float64)
        v1 = np.asarray(v1, dtype=np.float64)
        v2 = np.asarray(v2, dtype=np.float64)
        # Drop degenerate faces in bulk (mesh.py:141,225's per-face skip).
        keep = (np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1) >= 1e-12)
        self.v0, self.v1, self.v2 = v0[keep], v1[keep], v2[keep]
        self.material = mat

    def __len__(self) -> int:
        return self.v0.shape[0]


def torus_knot(mat: Material, p: int = 2, q: int = 3, segments: int = 320,
               sides: int = 80, tube_radius: float = 0.35, scale: float = 1.0,
               center=(0.0, 0.0, 0.0)) -> TriangleSoup:
    """Procedural (p, q) torus-knot tube → :class:`TriangleSoup`.

    ``segments × sides × 2`` triangles (320×80 → 51,200): the in-repo
    high-poly stress asset — no external file, fully deterministic.  The
    centreline is C(t) = ((2 + cos qt)·cos pt, (2 + cos qt)·sin pt, sin qt);
    the tube cross-section rides a tangent-orthogonal frame.
    """
    t = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    r = 2.0 + np.cos(q * t)
    C = np.stack([r * np.cos(p * t), r * np.sin(p * t), np.sin(q * t)], -1)

    # Tangent (analytic), then a stable orthogonal frame per ring.
    dr = -q * np.sin(q * t)
    T = np.stack([
        dr * np.cos(p * t) - r * p * np.sin(p * t),
        dr * np.sin(p * t) + r * p * np.cos(p * t),
        q * np.cos(q * t)], -1)
    T /= np.linalg.norm(T, axis=-1, keepdims=True)
    ref = np.where(np.abs(T[:, 2:3]) < 0.9,
                   np.array([[0.0, 0.0, 1.0]]), np.array([[1.0, 0.0, 0.0]]))
    N = np.cross(T, ref)
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    B = np.cross(T, N)

    theta = np.linspace(0.0, 2.0 * np.pi, sides, endpoint=False)
    ring = (np.cos(theta)[None, :, None] * N[:, None, :]
            + np.sin(theta)[None, :, None] * B[:, None, :])
    V = C[:, None, :] + tube_radius * ring          # (segments, sides, 3)
    V = V * float(scale) + np.asarray(center, dtype=np.float64)

    i = np.arange(segments)[:, None]
    j = np.arange(sides)[None, :]
    i1 = (i + 1) % segments
    j1 = (j + 1) % sides
    p00 = V[i, j].reshape(-1, 3)
    p10 = V[i1, j].reshape(-1, 3)
    p01 = V[i, j1].reshape(-1, 3)
    p11 = V[i1, j1].reshape(-1, 3)
    v0 = np.concatenate([p00, p00])
    v1 = np.concatenate([p10, p11])
    v2 = np.concatenate([p11, p01])
    return TriangleSoup(v0, v1, v2, mat)


@dataclass
class KleinBottle(Hittable):
    """Figure-8 immersion Klein bottle, tessellated to triangles
    (klein_bottle.py:7-185; CPU-only in the reference, on-device here).

    Each (u, v) patch becomes two triangles; the compiler flattens them like
    any mesh, so the BVH accelerates it (the reference brute-forces all
    patches per ray, klein_bottle.py:150+).
    """

    triangles: list

    A = 2.0  # major radius (klein_bottle.py:97)
    B = 1.0  # minor radius

    def __init__(self, center, scale: float, mat: Material, u_steps: int = 10, v_steps: int = 10):
        center = np.asarray(center, dtype=np.float64)
        uu = np.linspace(0.0, 2.0 * np.pi, u_steps + 1)
        vv = np.linspace(0.0, 2.0 * np.pi, v_steps + 1)
        U, V = np.meshgrid(uu, vv, indexing="ij")
        P = self._surface(U, V) * float(scale) + center  # (u+1, v+1, 3)
        self.triangles = []
        for i in range(u_steps):
            for j in range(v_steps):
                p00, p10 = P[i, j], P[i + 1, j]
                p01, p11 = P[i, j + 1], P[i + 1, j + 1]
                for tri in ((p00, p10, p11), (p00, p11, p01)):
                    e1 = tri[1] - tri[0]
                    e2 = tri[2] - tri[0]
                    if np.linalg.norm(np.cross(e1, e2)) < 1e-12:
                        continue
                    self.triangles.append(Triangle(*tri, mat))

    @classmethod
    def _surface(cls, u, v):
        """Figure-8 immersion (klein_bottle.py:68-83)."""
        a, b = cls.A, cls.B
        r = a + b * np.cos(u / 2.0) * np.sin(v) - b * np.sin(u / 2.0) * np.sin(2.0 * v)
        x = r * np.cos(u)
        y = r * np.sin(u)
        z = b * np.sin(u / 2.0) * np.sin(v) + b * np.cos(u / 2.0) * np.sin(2.0 * v)
        return np.stack([x, y, z], axis=-1)
