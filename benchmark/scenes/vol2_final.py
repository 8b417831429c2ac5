"""The final scene of *Ray Tracing: The Next Week* (Shirley): 20 x 20
ground boxes of random height, an area light, a moving sphere, glass,
metal, a glass sphere filled with blue fog, thin fog over the whole scene,
an earth-textured sphere, a Perlin marble sphere and a cluster of small
white spheres, laid out from ``rng = numpy.random.default_rng(seed)`` in
the book's order (fakhirsh/path-tracer-python ``scenes.py``
``vol2_final_scene``)."""
from __future__ import annotations

import numpy as np

from harness import describe as D


def build(cam: D.CameraDesc, seed: int = 7,
          sphere_cluster: int = 1000) -> D.Scene:
    rng = np.random.default_rng(seed)
    s = D.Scene(camera=cam)
    ground = D.Mat("lambertian", D.solid((0.48, 0.83, 0.53)))
    for i in range(20):
        for j in range(20):
            x0, z0 = -1000.0 + i * 100.0, -1000.0 + j * 100.0
            s.box((x0, 0.0, z0), (x0 + 100.0, rng.uniform(1, 101), z0 + 100.0),
                  ground)
    s.quad((123, 554, 147), (300, 0, 0), (0, 0, 265),
           D.Mat("light", D.solid((7, 7, 7))))
    c1 = np.array([400, 400, 200])
    s.sphere(c1, 50, D.Mat("lambertian", D.solid((0.7, 0.3, 0.1))),
             c1=c1 + np.array([30, 0, 0]))
    s.sphere((260, 150, 45), 50, D.Mat("dielectric", ir=1.5))
    s.sphere((0, 150, 145), 50,
             D.Mat("metal", D.solid((0.8, 0.8, 0.9)), fuzz=1.0))
    s.sphere((360, 150, 145), 70, D.Mat("dielectric", ir=1.5))
    # Blue fog inside a second sphere of the same size and place.
    s.sphere((360, 150, 145), 70, D.Mat("dielectric", ir=1.5),
             medium=s.medium(0.2, D.solid((0.2, 0.4, 0.9))))
    s.sphere((0, 0, 0), 5000, D.Mat("dielectric", ir=1.5),
             medium=s.medium(1e-4, D.solid((1, 1, 1))))
    s.sphere((400, 200, 400), 100, D.Mat("lambertian", D.image("earthmap")))
    s.sphere((220, 280, 300), 80,
             D.Mat("lambertian", D.Tex("noise", scale=0.2)))
    white = D.Mat("lambertian", D.solid((0.73, 0.73, 0.73)))
    offset = np.array([-100, 270, 395])
    for _ in range(sphere_cluster):
        s.sphere(rng.uniform(0, 165, size=3) + offset, 10, white)
    return s
