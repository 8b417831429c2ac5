"""BASELINE.json config 4: an OBJ torus (metal) on a Perlin marble ground
under an area light, between two subsurface-scattering spheres, one a
random-walk volumetric wax, one the simple displaced-exit model."""
from __future__ import annotations

from harness import describe as D


def build(cam: D.CameraDesc, mesh: str = "torus.obj") -> D.Scene:
    s = D.Scene(camera=cam)
    s.sphere((0, -1000, 0), 1000, D.Mat("lambertian", D.Tex("noise", scale=2.0)))
    s.quad((-3, 6, -2), (6, 0, 0), (0, 0, 4), D.Mat("light", D.solid((5, 5, 5))))
    metal = D.Mat("metal", D.solid((0.7, 0.6, 0.5)), fuzz=0.1)
    for v0, v1, v2 in D.obj_triangles(mesh):
        s.triangle(v0, v1, v2, metal)
    s.sphere((-2.5, 1.0, 0.5), 1.0,
             D.Mat("sss_volumetric", D.solid((0.2, 0.5, 0.2)), g=0.7,
                   sigma_s=0.08, sigma_a=0.8))
    s.sphere((2.5, 1.0, -0.5), 1.0,
             D.Mat("sss_simple", D.solid((0.9, 0.7, 0.6)), scatter_dist=0.2))
    return s
