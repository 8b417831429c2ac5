"""BASELINE.json config 2: a Cornell box (*Ray Tracing: The Next Week*,
fakhirsh/path-tracer-python) of five walls and an area light of radiance
15, a white box rotated 15 degrees about the vertical, and a glass sphere
of index 1.5, seen through the configuration's thin lens on a black
background.  Quad for quad as ``path_tracer_tpu_torch/scenes.py``
``cornell_glass_dof`` lays it out: the walls and the light in its order,
then the box's six faces, then the sphere.

Departures from the book, both the port scene's own: the box is rotated
about its centre, where the book rotates it about its corner and then
translates it, so it stands a few units elsewhere; and the sphere takes the
place of the book's second, shorter box, as in the Cornell box with a
glass sphere of *Ray Tracing: The Rest of Your Life*.  The rotated faces are worked out in float64 with the
arithmetic of the port's ``models/geometry.py`` ``box`` and rounded to
float32 once, so both sides hold the same corners and edges.
"""
from __future__ import annotations

import math

import numpy as np

from harness import describe as D


def rotated_box(s: D.Scene, a, b, mat: D.Mat, angle: float) -> None:
    """The box from ``a`` to ``b`` as six quads in :meth:`D.Scene.box`'s
    order, rotated ``angle`` degrees about the vertical through its
    centre."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mn, mx = np.minimum(a, b), np.maximum(a, b)
    dx = np.array([mx[0] - mn[0], 0.0, 0.0])
    dy = np.array([0.0, mx[1] - mn[1], 0.0])
    dz = np.array([0.0, 0.0, mx[2] - mn[2]])
    theta = math.radians(angle)
    c, sn = math.cos(theta), math.sin(theta)
    center = 0.5 * (mn + mx)

    def rot_v(v):
        return np.array([c * v[0] + sn * v[2], v[1], -sn * v[0] + c * v[2]])

    def rot_p(p):
        return rot_v(p - center) + center

    P = lambda x, y, z: np.array([x, y, z])  # noqa: E731
    for q, u, v in ((P(mn[0], mn[1], mx[2]), dx, dy),
                    (P(mx[0], mn[1], mx[2]), -dz, dy),
                    (P(mx[0], mn[1], mn[2]), -dx, dy),
                    (P(mn[0], mn[1], mn[2]), dz, dy),
                    (P(mn[0], mx[1], mx[2]), dx, -dz),
                    (P(mn[0], mn[1], mn[2]), dx, dz)):
        s.quad(rot_p(q), rot_v(u), rot_v(v), mat)


def build(cam: D.CameraDesc) -> D.Scene:
    s = D.Scene(camera=cam)
    red = D.Mat("lambertian", D.solid((0.65, 0.05, 0.05)))
    white = D.Mat("lambertian", D.solid((0.73, 0.73, 0.73)))
    green = D.Mat("lambertian", D.solid((0.12, 0.45, 0.15)))
    lamp = D.Mat("light", D.solid((15, 15, 15)))
    s.quad((555, 0, 0), (0, 0, 555), (0, 555, 0), green)
    s.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red)
    s.quad((343, 554, 332), (-130, 0, 0), (0, 0, -105), lamp)
    s.quad((0, 0, 0), (0, 0, 555), (555, 0, 0), white)
    s.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)
    s.quad((0, 0, 555), (0, 555, 0), (555, 0, 0), white)
    rotated_box(s, (265, 0, 295), (430, 330, 460), white, 15.0)
    s.sphere((190, 90, 190), 90, D.Mat("dielectric", ir=1.5))
    return s
