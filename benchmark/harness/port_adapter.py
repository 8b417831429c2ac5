"""A scene description (:mod:`.describe`) as the port's scene objects.

The port receives exactly what the description holds: each texture,
material and medium becomes one port object (shared where the description
shares it), each primitive the port's sphere, quad or triangle in the
description's order, and the primitives of one medium go into one
``ConstantMedium``.  Images are handed over as arrays, so the port does not
decode a file of its own.
"""
from __future__ import annotations

import numpy as np


def port_world(desc):
    """(HittableList, Camera) of the port for ``desc``."""
    import path_tracer_tpu_torch as ptt

    memo: dict = {}

    def once(obj, make):
        if id(obj) not in memo:
            memo[id(obj)] = make()
        return memo[id(obj)]

    def tex(t):
        def make():
            if t.kind == "solid":
                return ptt.SolidColor(t.rgb)
            if t.kind == "noise":
                return ptt.NoiseTexture(float(t.scale))
            if t.kind == "image":
                return ptt.ImageTexture.from_array(t.data)
            raise ValueError(f"unknown texture kind {t.kind!r}")
        return once(t, make)

    def mat(m):
        def make():
            k = m.kind
            if k == "lambertian":
                return ptt.Lambertian(tex(m.tex))
            if k == "metal":
                return ptt.Metal(tex(m.tex), m.fuzz)
            if k == "dielectric":
                return ptt.Dielectric(m.ir)
            if k == "light":
                return ptt.DiffuseLight(tex(m.tex))
            if k == "isotropic":
                return ptt.Isotropic(tex(m.tex))
            if k == "sss_simple":
                return ptt.SubsurfaceSimple(tex(m.tex), m.scatter_dist)
            if k == "sss_volumetric":
                return ptt.SubsurfaceVolumetric(tex(m.tex), m.sigma_s,
                                                m.sigma_a, m.g)
            raise ValueError(f"unknown material kind {k!r}")
        return once(m, make)

    def prim(p):
        if p.kind == "sphere":
            return ptt.Sphere.moving(p.a, p.b, p.radius, mat(p.mat))
        if p.kind == "quad":
            return ptt.Quad(p.a, p.b, p.c, mat(p.mat))
        if p.kind == "triangle":
            return ptt.Triangle(p.a, p.b, p.c, mat(p.mat))
        raise ValueError(f"unknown primitive kind {p.kind!r}")

    world = ptt.HittableList()
    bounds: dict = {}
    for p in desc.prims:
        if p.medium < 0:
            world.add(prim(p))
            continue
        if p.medium not in bounds:
            m = desc.media[p.medium]
            bounds[p.medium] = ptt.HittableList()
            world.add(ptt.ConstantMedium(bounds[p.medium], m.density,
                                         tex(m.tex)))
        bounds[p.medium].add(prim(p))

    c = desc.camera
    cam = ptt.Camera()
    cam.aspect_ratio = c.width / c.height
    cam.img_width = c.width
    cam.vfov = c.vfov
    cam.lookfrom = np.asarray(c.lookfrom, float)
    cam.lookat = np.asarray(c.lookat, float)
    cam.vup = np.asarray(c.vup, float)
    cam.defocus_angle = c.defocus_angle
    cam.focus_distance = c.focus_distance
    cam.background = (None if c.background is None
                      else np.asarray(c.background, float))
    if cam.img_height != c.height:
        raise ValueError(f"camera height {cam.img_height} != {c.height}")
    return world, cam
