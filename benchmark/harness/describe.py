"""The scene description the benchmark hands to both sides.

A description is plain data: textures, materials, constant media, and a
list of primitives (spheres, quads, triangles) in the order the scene adds
them, with the camera.  ``scenes/<name>.py`` builds one from a
configuration; :mod:`.port_adapter` turns it into the port's scene objects
and :mod:`benchmark.reference.scene` into the reference's own arrays.
Vectors are float32, as the port's scene objects store them.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets")


def f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).reshape(3)


@dataclass(eq=False)
class Tex:
    """``kind``: ``solid`` (``rgb``), ``noise`` (``scale``) or ``image``
    (``data``, (H, W, 3) float32 in [0, 1])."""

    kind: str
    rgb: np.ndarray | None = None
    scale: float = 0.0
    data: np.ndarray | None = None


@dataclass(eq=False)
class Mat:
    """``kind``: lambertian, metal, dielectric, light, isotropic,
    sss_simple or sss_volumetric; ``tex`` is the albedo or emission."""

    kind: str
    tex: Tex | None = None
    fuzz: float = 0.0
    ir: float = 1.0
    g: float = 0.0
    sigma_s: float = 0.0
    sigma_a: float = 0.0
    scatter_dist: float = 0.0


@dataclass(eq=False)
class Medium:
    density: float
    tex: Tex


@dataclass(eq=False)
class Prim:
    """``kind``: sphere (``a`` = centre at time 0, ``b`` = at time 1,
    ``radius``), quad (``a`` = corner, ``b``/``c`` = edges) or triangle
    (``a``, ``b``, ``c`` = vertices); ``medium`` indexes
    :attr:`Scene.media`, -1 for a surface."""

    kind: str
    a: np.ndarray
    b: np.ndarray
    c: np.ndarray | None
    mat: Mat
    radius: float = 0.0
    medium: int = -1


@dataclass
class CameraDesc:
    width: int
    height: int
    vfov: float
    lookfrom: tuple
    lookat: tuple
    vup: tuple = (0.0, 1.0, 0.0)
    defocus_angle: float = 0.0
    focus_distance: float = 10.0
    background: tuple | None = None      # None: the gradient sky


@dataclass
class Scene:
    camera: CameraDesc
    prims: list = field(default_factory=list)
    media: list = field(default_factory=list)

    def sphere(self, c0, radius, mat, c1=None, medium=-1):
        c0 = f32(c0)
        self.prims.append(Prim("sphere", c0, c0.copy() if c1 is None
                               else f32(c1), None, mat, float(radius),
                               medium))

    def quad(self, q, u, v, mat, medium=-1):
        self.prims.append(Prim("quad", f32(q), f32(u), f32(v), mat,
                               medium=medium))

    def triangle(self, v0, v1, v2, mat, medium=-1):
        self.prims.append(Prim("triangle", f32(v0), f32(v1), f32(v2), mat,
                               medium=medium))

    def box(self, a, b, mat, medium=-1):
        """An axis-aligned box as six quads, in the RTiOW book's order."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        dx = np.array([mx[0] - mn[0], 0.0, 0.0])
        dy = np.array([0.0, mx[1] - mn[1], 0.0])
        dz = np.array([0.0, 0.0, mx[2] - mn[2]])
        P = lambda x, y, z: np.array([x, y, z])  # noqa: E731
        for q, u, v in ((P(mn[0], mn[1], mx[2]), dx, dy),
                        (P(mx[0], mn[1], mx[2]), -dz, dy),
                        (P(mx[0], mn[1], mn[2]), -dx, dy),
                        (P(mn[0], mn[1], mn[2]), dz, dy),
                        (P(mn[0], mx[1], mx[2]), dx, -dz),
                        (P(mn[0], mn[1], mn[2]), dx, dz)):
            self.quad(q, u, v, mat, medium)

    def medium(self, density, tex) -> int:
        self.media.append(Medium(float(density), tex))
        return len(self.media) - 1


def solid(rgb) -> Tex:
    return Tex("solid", rgb=f32(rgb))


def image(name: str) -> Tex:
    """A texture image from ``assets/<name>.npy`` (uint8 RGB, decoded once
    from the published JPEG), as float32 in [0, 1]."""
    data = np.load(os.path.join(ASSETS, name + ".npy"))
    return Tex("image", data=data.astype(np.float32) / 255.0)


def obj_triangles(name: str, scale: float = 1.0, offset=(0.0, 0.0, 0.0)):
    """Triangles of ``assets/<name>``: ``v`` and ``f`` records, polygons
    fanned from their first vertex, degenerate faces skipped → list of
    (v0, v1, v2) float64 triples."""
    verts, faces = [], []
    with open(os.path.join(ASSETS, name)) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v" and len(parts) >= 4:
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f" and len(parts) >= 4:
                idx = [int(t.split("/")[0]) for t in parts[1:]]
                faces.append([i - 1 if i > 0 else len(verts) + i for i in idx])
    v = np.asarray(verts, np.float64) * float(scale) + np.asarray(offset)
    out = []
    for face in faces:
        for k in range(1, len(face) - 1):
            v0, v1, v2 = v[face[0]], v[face[k]], v[face[k + 1]]
            if np.linalg.norm(np.cross(v1 - v0, v2 - v0)) >= 1e-12:
                out.append((v0, v1, v2))
    return out
