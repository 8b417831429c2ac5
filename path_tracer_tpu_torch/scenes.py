"""Scene gallery: every scene family from the reference, as builders.

Mirrors ``reference scenes.py`` (~20 builders spanning the RTiOW
vol-1/vol-2 book chapters plus extras) — but each function returns
``(world, camera)`` instead of rendering inline, so the same scene drives the
megakernel engine, the wavefront engine, tests, and benchmarks.  Random
scenes take a ``seed`` (the reference uses the unseeded global ``random``
module, so its layouts are irreproducible; ours are deterministic).

Scene ↔ reference mapping is noted per function (file:line into scenes.py).
"""
from __future__ import annotations

import numpy as np

from .models.camera import Camera
from .models.geometry import (ConstantMedium, HittableList, KleinBottle, Mesh,
                              Quad, Sphere, Triangle, box, torus_knot)
from .models.materials import (Dielectric, DiffuseLight, Isotropic, Lambertian,
                               Metal, SubsurfaceSimple, SubsurfaceVolumetric)
from .models.textures import (CheckerTexture, ImageTexture, NoiseTexture,
                              SolidColor)

SKY = (0.70, 0.80, 1.00)


def _cam(aspect=16.0 / 9.0, width=400, spp=50, depth=16, vfov=20,
         lookfrom=(13, 2, 3), lookat=(0, 0, 0), defocus=0.0, focus=10.0,
         background=SKY) -> Camera:
    c = Camera()
    c.aspect_ratio = aspect
    c.img_width = width
    c.samples_per_pixel = spp
    c.max_depth = depth
    c.vfov = vfov
    c.lookfrom = np.asarray(lookfrom, float)
    c.lookat = np.asarray(lookat, float)
    c.defocus_angle = defocus
    c.focus_distance = focus
    c.background = None if background is None else np.asarray(background, float)
    return c


def vol1_sec9_5():
    """Two-sphere diffuse opener (scenes.py:16-44)."""
    w = HittableList()
    w.add(Sphere.stationary((0, 0, 0), 0.5, Lambertian((0.8, 0.3, 0.3))))
    w.add(Sphere.stationary((0, -100.5, -1), 100, Lambertian((0.5, 0.5, 0.5))))
    return w, _cam(width=800, spp=100, lookfrom=(0, 1, -5), background=None)


def _random_spheres(seed, moving: bool, a_range=11):
    rng = np.random.default_rng(seed)
    w = HittableList()
    w.add(Sphere.stationary((0, -1000, 0), 1000, Lambertian((0.5, 0.5, 0.5))))
    for a in range(-a_range, a_range):
        for b in range(-a_range, a_range):
            choose = rng.uniform()
            center = np.array([a + 0.9 * rng.uniform(), 0.2,
                               b + 0.9 * rng.uniform()])
            if np.linalg.norm(center - np.array([4, 0.2, 0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.uniform(size=3) * rng.uniform(size=3)
                mat = Lambertian(albedo)
                if moving:
                    c2 = center + np.array([0, rng.uniform(0, 0.5), 0])
                    w.add(Sphere.moving(center, c2, 0.2, mat))
                else:
                    w.add(Sphere.stationary(center, 0.2, mat))
            elif choose < 0.95:
                mat = Metal(rng.uniform(0.5, 1, size=3), rng.uniform(0, 0.5))
                w.add(Sphere.stationary(center, 0.2, mat))
            else:
                w.add(Sphere.stationary(center, 0.2, Dielectric(1.5)))
    w.add(Sphere.stationary((0, 1, 0), 1.0, Dielectric(1.5)))
    w.add(Sphere.stationary((-4, 1, 0), 1.0, Lambertian((0.4, 0.2, 0.1))))
    w.add(Sphere.stationary((4, 1, 0), 1.0, Metal((0.7, 0.6, 0.5), 0.0)))
    return w


def vol1_sec14_1(seed=3):
    """Vol-1 finale: ~480 random spheres (scenes.py:48-113)."""
    return _random_spheres(seed, moving=False), _cam(width=800, spp=100,
                                                     depth=50)


def vol2_sec2_6(seed=3):
    """Random spheres with motion blur + depth of field (scenes.py:117-186)."""
    return _random_spheres(seed, moving=True), _cam(width=1280, spp=100,
                                                    defocus=0.6, background=None)


def vol2_sec4_3_simple():
    """Two checkered spheres (scenes.py:352-379)."""
    w = HittableList()
    checker = CheckerTexture(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    w.add(Sphere.stationary((0, -10, 0), 10, Lambertian(checker)))
    w.add(Sphere.stationary((0, 10, 0), 10, Lambertian(checker)))
    return w, _cam(width=300, spp=10, depth=5)


def vol2_sec4_6():
    """Earth image-texture globe (scenes.py:383-412)."""
    w = HittableList()
    earth = ImageTexture("assets/images/earthmap.jpg")
    w.add(Sphere.stationary((0, 0, 0), 2.0, Lambertian(earth)))
    return w, _cam(width=600, spp=50, depth=10, lookfrom=(0, 0, 12))


def vol2_sec5():
    """Perlin marble spheres (scenes.py:561-598)."""
    w = HittableList()
    noise = NoiseTexture(4.0)
    w.add(Sphere.stationary((0, -1000, 0), 1000, Lambertian(noise)))
    w.add(Sphere.stationary((0, 2, 0), 2, Lambertian(noise)))
    return w, _cam(width=500, spp=20, depth=10)


def vol2_sec6():
    """Five colored quads (scenes.py:635-671)."""
    w = HittableList()
    w.add(Quad((-3, -2, 5), (0, 0, -4), (0, 4, 0), Lambertian((1.0, 0.2, 0.2))))
    w.add(Quad((-2, -2, 0), (4, 0, 0), (0, 4, 0), Lambertian((0.2, 1.0, 0.2))))
    w.add(Quad((3, -2, 1), (0, 0, 4), (0, 4, 0), Lambertian((0.2, 0.2, 1.0))))
    w.add(Quad((-2, 3, 1), (4, 0, 0), (0, 0, 4), Lambertian((1.0, 0.5, 0.0))))
    w.add(Quad((-2, -3, 5), (4, 0, 0), (0, 0, -4), Lambertian((0.2, 0.8, 0.8))))
    return w, _cam(aspect=1.0, width=400, spp=50, depth=10, vfov=80,
                   lookfrom=(0, 0, 9))


def triangles():
    """Three textured triangles (scenes.py:675-734)."""
    w = HittableList()
    w.add(Sphere.stationary((0, -1000, 0), 1000, Lambertian((0.5, 0.5, 0.5))))
    w.add(Triangle((-2, 0, -1), (-1, 2, -1), (0, 0, -1),
                   Lambertian(SolidColor((0.9, 0.2, 0.2)))))
    w.add(Triangle((0.5, 0, 0), (1.5, 2, 0), (2.5, 0, 0),
                   Lambertian(ImageTexture("assets/images/earthmap.jpg"))))
    w.add(Triangle((-0.5, 0, 1), (0.5, 2, 1), (1.5, 0, 1),
                   Lambertian(NoiseTexture(24.0))))
    return w, _cam(width=400, spp=50, depth=10, vfov=50, lookfrom=(0, 1, 5),
                   lookat=(0.5, 1, 0))


def subsurface_scattering():
    """SSS showcase: volumetric wax + matte + marble (scenes.py:510-557)."""
    w = HittableList()
    w.add(Quad((-1, 0, 3), (2, 0, 0), (0, 2, 0), DiffuseLight((4, 4, 4))))
    w.add(Sphere.stationary((0, -1000, 0), 1000, Lambertian((0.5, 0.5, 0.5))))
    wax = SubsurfaceVolumetric((0.2, 0.5, 0.2), scatter_coeff=0.08,
                               absorb_coeff=0.8, g=0.7)
    w.add(Sphere.stationary((0, 0.5, 0), 0.5, wax))
    w.add(Sphere.stationary((-1, 0.5, 0), 0.5, Lambertian((0.1, 0.3, 0.1))))
    w.add(Sphere.stationary((1, 0.5, 0), 0.5, Lambertian(NoiseTexture(50.0))))
    return w, _cam(width=100, spp=40, depth=15, lookfrom=(0, 1, -5),
                   lookat=(0, 0.5, 0))


def simple_light():
    """Emissive sphere + quad over marble (scenes.py:918-957)."""
    w = HittableList()
    noise = NoiseTexture(4.0)
    w.add(Sphere.stationary((0, -1000, 0), 1000, Lambertian(noise)))
    w.add(Sphere.stationary((0, 2, 0), 2, Lambertian(noise)))
    light = DiffuseLight((4, 4, 4))
    w.add(Sphere.stationary((0, 7, 0), 2, light))
    w.add(Quad((3, 1, -2), (2, 0, 0), (0, 2, 0), light))
    return w, _cam(width=800, spp=200, depth=50, lookfrom=(26, 3, 6),
                   lookat=(0, 2, 0), background=(0, 0, 0))


def cornell_box():
    """Classic Cornell box with two rotated boxes (scenes.py:1028-1082)."""
    w = HittableList()
    red = Lambertian((0.65, 0.05, 0.05))
    white = Lambertian((0.73, 0.73, 0.73))
    green = Lambertian((0.12, 0.45, 0.15))
    light = DiffuseLight((15, 15, 15))
    w.add(Quad((555, 0, 0), (0, 0, 555), (0, 555, 0), green))
    w.add(Quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red))
    w.add(Quad((343, 554, 332), (-130, 0, 0), (0, 0, -105), light))
    w.add(Quad((0, 0, 0), (0, 0, 555), (555, 0, 0), white))
    w.add(Quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white))
    w.add(Quad((0, 0, 555), (0, 555, 0), (555, 0, 0), white))
    w.add(box((130, 0, 65), (295, 165, 230), white, -18))
    w.add(box((265, 0, 295), (430, 330, 460), white, 15))
    return w, _cam(aspect=1.0, width=800, spp=500, depth=50, vfov=40,
                   lookfrom=(278, 278, -800), lookat=(278, 278, 0),
                   background=(0, 0, 0))


def cornell_smoke():
    """Cornell box with black/white smoke volumes (scenes.py:1094-1148)."""
    w = HittableList()
    red = Lambertian((0.65, 0.05, 0.05))
    white = Lambertian((0.73, 0.73, 0.73))
    green = Lambertian((0.12, 0.45, 0.15))
    light = DiffuseLight((7, 7, 7))
    w.add(Quad((555, 0, 0), (0, 555, 0), (0, 0, 555), green))
    w.add(Quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red))
    w.add(Quad((113, 554, 127), (330, 0, 0), (0, 0, 305), light))
    w.add(Quad((0, 555, 0), (555, 0, 0), (0, 0, 555), white))
    w.add(Quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white))
    w.add(Quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white))
    box1 = box((265, 0, 295), (430, 330, 460), white, 15)
    box2 = box((130, 0, 65), (295, 165, 230), white, -18)
    w.add(ConstantMedium.from_color(box1, (0, 0, 0), 0.01))
    w.add(ConstantMedium.from_color(box2, (1, 1, 1), 0.01))
    return w, _cam(aspect=1.0, width=800, spp=1000, depth=50, vfov=40,
                   lookfrom=(278, 278, -800), lookat=(278, 278, 0),
                   background=(0, 0, 0))


def texture_target(n: int = 8) -> np.ndarray:
    """The n x n RGB pattern of the texture demo in [0.15, 0.85]
    (tools/train_demo.py:207-215): gradients on R/G, a checker on B."""
    yy, xx = np.mgrid[0:n, 0:n] / max(n - 1, 1)
    checker = (np.arange(n)[:, None] + np.arange(n)[None, :]) % 2
    return np.stack([0.15 + 0.70 * xx, 0.15 + 0.70 * yy,
                     0.20 + 0.60 * checker], axis=-1).astype(np.float32)


def texture_demo(tex_n: int = 8):
    """The texture-recovery scene of tools/train_demo.py:261-280: the
    Cornell walls and light without the boxes, an image-textured back wall
    (``texture_target``; its ``img_data`` atlas is the trained leaf), a
    weak flash quad behind the camera, and the camera at z = -200.  Not
    one of :data:`SCENES`, as in the JAX package."""
    w = HittableList()
    red = Lambertian((0.65, 0.05, 0.05))
    white = Lambertian((0.73, 0.73, 0.73))
    green = Lambertian((0.12, 0.45, 0.15))
    light = DiffuseLight((15, 15, 15))
    w.add(Quad((555, 0, 0), (0, 0, 555), (0, 555, 0), green))
    w.add(Quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red))
    w.add(Quad((343, 554, 332), (-130, 0, 0), (0, 0, -105), light))
    w.add(Quad((0, 0, 0), (0, 0, 555), (555, 0, 0), white))
    w.add(Quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white))
    w.add(Quad((0, 0, 555), (0, 555, 0), (555, 0, 0),
               Lambertian(ImageTexture.from_array(texture_target(tex_n)))))
    w.add(Quad((50, 50, -210), (455, 0, 0), (0, 455, 0),
               DiffuseLight((1.5, 1.5, 1.5))))
    _, cam = cornell_box()
    cam.lookfrom = np.array([278.0, 278.0, -200.0])
    return w, cam


def vol2_final_scene(seed=7, sphere_cluster=1000):
    """The vol-2 finale: 1000+ objects, all features (scenes.py:1152-1246)."""
    rng = np.random.default_rng(seed)
    w = HittableList()
    ground = Lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            x0 = -1000.0 + i * 100.0
            z0 = -1000.0 + j * 100.0
            y1 = rng.uniform(1, 101)
            w.add(box((x0, 0.0, z0), (x0 + 100.0, y1, z0 + 100.0), ground))
    w.add(Quad((123, 554, 147), (300, 0, 0), (0, 0, 265),
               DiffuseLight((7, 7, 7))))
    c1 = np.array([400, 400, 200])
    w.add(Sphere.moving(c1, c1 + np.array([30, 0, 0]), 50,
                        Lambertian((0.7, 0.3, 0.1))))
    w.add(Sphere.stationary((260, 150, 45), 50, Dielectric(1.5)))
    w.add(Sphere.stationary((0, 150, 145), 50, Metal((0.8, 0.8, 0.9), 1.0)))
    boundary = Sphere.stationary((360, 150, 145), 70, Dielectric(1.5))
    w.add(boundary)
    w.add(ConstantMedium.from_color(
        Sphere.stationary((360, 150, 145), 70, Dielectric(1.5)),
        (0.2, 0.4, 0.9), 0.2))
    w.add(ConstantMedium.from_color(
        Sphere.stationary((0, 0, 0), 5000, Dielectric(1.5)), (1, 1, 1), 1e-4))
    w.add(Sphere.stationary((400, 200, 400), 100,
                            Lambertian(ImageTexture("assets/images/earthmap.jpg"))))
    w.add(Sphere.stationary((220, 280, 300), 80, Lambertian(NoiseTexture(0.2))))
    white = Lambertian((0.73, 0.73, 0.73))
    offset = np.array([-100, 270, 395])
    for _ in range(sphere_cluster):
        w.add(Sphere.stationary(rng.uniform(0, 165, size=3) + offset, 10, white))
    return w, _cam(aspect=1.0, width=1000, spp=10000, depth=50, vfov=40,
                   lookfrom=(478, 278, -600), lookat=(278, 278, 0),
                   background=(0, 0, 0))


def vol2_test_scene(seed=7):
    """Ground boxes + light + glass/fog sphere (scenes.py:1552-1625), the
    reference's default benchmark scene (main.py:17)."""
    rng = np.random.default_rng(seed)
    w = HittableList()
    ground = Lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            x0 = -1000.0 + i * 100.0
            z0 = -1000.0 + j * 100.0
            y1 = rng.uniform(1, 101)
            w.add(box((x0, 0.0, z0), (x0 + 100.0, y1, z0 + 100.0), ground))
    w.add(Quad((123, 554, 147), (300, 0, 0), (0, 0, 265),
               DiffuseLight((7, 7, 7))))
    w.add(Sphere.stationary((360, 150, 145), 70, Dielectric(1.5)))
    w.add(ConstantMedium.from_color(
        Sphere.stationary((360, 150, 145), 70, Dielectric(1.5)),
        (0.2, 0.4, 0.9), 0.2))
    return w, _cam(aspect=1.0, width=600, spp=200, depth=50, vfov=40,
                   lookfrom=(478, 278, -600), lookat=(278, 278, 0),
                   background=(0, 0, 0))


def wavefront_comparison(seed=11):
    """~41-sphere A/B scene for mega-vs-wavefront (scenes.py:1433-1547)."""
    rng = np.random.default_rng(seed)
    w = HittableList()
    w.add(Sphere.stationary((0, -1000, 0), 1000, Lambertian((0.5, 0.5, 0.5))))
    for a in range(-3, 3):
        for b in range(-3, 3):
            choose = rng.uniform()
            center = np.array([a + 0.9 * rng.uniform(), 0.2,
                               b + 0.9 * rng.uniform()])
            if np.linalg.norm(center - np.array([4, 0.2, 0])) <= 0.9:
                continue
            if choose < 0.6:
                w.add(Sphere.stationary(
                    center, 0.2,
                    Lambertian(rng.uniform(size=3) * rng.uniform(size=3))))
            elif choose < 0.85:
                w.add(Sphere.stationary(
                    center, 0.2,
                    Metal(rng.uniform(0.5, 1, size=3), rng.uniform(0, 0.5))))
            else:
                w.add(Sphere.stationary(center, 0.2, Dielectric(1.5)))
    w.add(Sphere.stationary((0, 1, 0), 1.0, Dielectric(1.5)))
    w.add(Sphere.stationary((-4, 1, 0), 1.0, Lambertian((0.4, 0.2, 0.1))))
    w.add(Sphere.stationary((4, 1, 0), 1.0, Metal((0.7, 0.6, 0.5), 0.0)))
    w.add(Sphere.stationary((0, 5, 0), 1.5, DiffuseLight((4, 4, 4))))
    return w, _cam(width=800, spp=200, background=None)


def test_mesh(path="assets/models", scale=1.0):
    """OBJ mesh scene (scenes.py:738-807); teapot if assets exist."""
    w = HittableList()
    w.add(Sphere.stationary((0, -1000, 0), 1000, Lambertian((0.5, 0.5, 0.5))))
    try:
        w.add(Mesh(path, Metal((0.7, 0.6, 0.5), 0.1), scale=scale))
    except FileNotFoundError:
        # Asset-free fallback: a Klein bottle stands in as the mesh.
        w.add(KleinBottle((0, 1.5, 0), 0.5, Metal((0.7, 0.6, 0.5), 0.1)))
    return w, _cam(width=800, spp=100, depth=10, vfov=40,
                   lookfrom=(15, 5, 10), lookat=(0, 1.5, 0))


def klein_bottle():
    """Klein bottle showcase (klein_bottle.py; CPU-only in the reference)."""
    w = HittableList()
    w.add(Sphere.stationary((0, -1000, 0), 1000, Lambertian((0.5, 0.5, 0.5))))
    w.add(KleinBottle((0, 1.5, 0), 0.5, Lambertian((0.3, 0.5, 0.8)),
                      u_steps=16, v_steps=16))
    return w, _cam(width=400, spp=50, depth=10, vfov=40, lookfrom=(10, 4, 8),
                   lookat=(0, 1.5, 0))


def vol2_sec42_scene_simple():
    """Simple motion-blur showcase: checker ground + mixed moving/static
    spheres (scenes.py:272-349)."""
    w = HittableList()
    checker = CheckerTexture(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    w.add(Sphere.stationary((0, -1000, 0), 1000, Lambertian(checker)))
    w.add(Sphere.moving((-2, 0.5, 0), (-2, 0.8, 0), 0.5,
                        Lambertian((0.8, 0.3, 0.3))))
    w.add(Sphere.stationary((0, 0.5, 0), 0.5, Dielectric(1.5)))
    w.add(Sphere.stationary((2, 0.5, 0), 0.5, Metal((0.7, 0.6, 0.5), 0.1)))
    w.add(Sphere.moving((0, 0.3, -2), (0, 0.7, -2), 0.3,
                        Lambertian((0.3, 0.3, 0.8))))
    w.add(Sphere.moving((-1, 0.3, 1), (-1, 0.7, 1), 0.3,
                        Lambertian((0.3, 0.8, 0.3))))
    w.add(Sphere.moving((1, 0.3, 1.5), (1, 0.65, 1.5), 0.3,
                        Lambertian((0.8, 0.8, 0.3))))
    w.add(Sphere.stationary((3, 0.3, -1), 0.3, Dielectric(1.5)))
    w.add(Sphere.stationary((-3, 0.4, -0.5), 0.4, Metal((0.9, 0.9, 0.9), 0.0)))
    w.add(Sphere.stationary((0.5, 0.3, -3), 0.3, Metal((0.8, 0.5, 0.3), 0.3)))
    w.add(Sphere.moving((-3.5, 0.25, 1), (-3.5, 0.5, 1), 0.25,
                        Lambertian((0.7, 0.3, 0.7))))
    return w, _cam(width=400, spp=100, depth=20)


def vol2_sec4_6_ver2():
    """Earth globe flanked by solid/checker spheres (scenes.py:460-558; the
    ``_cpu`` variant at :416 is the same world on the CPU renderer — here
    both engines consume one builder)."""
    w = HittableList()
    w.add(Sphere.stationary((0, -1000, 0), 1000, Lambertian((0.5, 0.5, 0.5))))
    w.add(Sphere.stationary((-1, 0.5, 0), 0.5,
                            Lambertian(SolidColor((0.8, 0.3, 0.3)))))
    w.add(Sphere.stationary((0, 0.5, 0), 0.5,
                            Lambertian(ImageTexture("assets/images/earthmap.jpg"))))
    w.add(Sphere.stationary((1, 0.5, 0), 0.5,
                            Lambertian(CheckerTexture(0.2, (0.2, 0.3, 0.8),
                                                      (0.9, 0.9, 0.9)))))
    return w, _cam(width=600, spp=50, depth=10, lookfrom=(0, 1, -5),
                   lookat=(0, 0.5, 0))


vol2_sec4_6_ver2_cpu = vol2_sec4_6_ver2


def emmission():
    """Perlin sphere on gray ground (scenes.py:602-632; the reference keeps
    this spelling)."""
    w = HittableList()
    w.add(Sphere.stationary((0, -1000, 0), 1000, Lambertian((0.5, 0.5, 0.5))))
    w.add(Sphere.stationary((0, 2, 0), 2, Lambertian(NoiseTexture(1.0))))
    return w, _cam(width=400, spp=20, depth=10)


def vol2_final_scene_simple():
    """Small final-scene variant for fast iteration.  The reference's
    function is an empty stub (scenes.py:1250-1253 ``pass``); here it is the
    real final scene with a reduced sphere cluster."""
    return vol2_final_scene(sphere_cluster=100)


# Interactive variants (scenes.py:189, :813): the reference opens a Tk orbit
# viewer; per the BASELINE north star this framework replaces GUIs with
# progressive offline rendering + checkpoints (render/renderer.py), so the
# interactive entries map to the same worlds.
vol2_sec2_6_interactive = vol2_sec2_6
test_mesh_interactive = test_mesh


def cornell_glass_dof():
    """BASELINE.json config #2: glass + emissive Cornell-style scene with
    depth-of-field (400x300 @ 64 spp in the ladder)."""
    w = HittableList()
    red = Lambertian((0.65, 0.05, 0.05))
    white = Lambertian((0.73, 0.73, 0.73))
    green = Lambertian((0.12, 0.45, 0.15))
    light = DiffuseLight((15, 15, 15))
    w.add(Quad((555, 0, 0), (0, 0, 555), (0, 555, 0), green))
    w.add(Quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red))
    w.add(Quad((343, 554, 332), (-130, 0, 0), (0, 0, -105), light))
    w.add(Quad((0, 0, 0), (0, 0, 555), (555, 0, 0), white))
    w.add(Quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white))
    w.add(Quad((0, 0, 555), (0, 555, 0), (555, 0, 0), white))
    w.add(box((265, 0, 295), (430, 330, 460), white, 15))
    w.add(Sphere.stationary((190, 90, 190), 90, Dielectric(1.5)))
    return w, _cam(aspect=4.0 / 3.0, width=400, spp=64, depth=20, vfov=40,
                   lookfrom=(278, 278, -800), lookat=(278, 278, 0),
                   defocus=0.6, focus=1030.0, background=(0, 0, 0))


def mesh_perlin_sss():
    """BASELINE.json config #4: OBJ mesh + Perlin textures + subsurface
    scattering in one scene."""
    w = HittableList()
    w.add(Sphere.stationary((0, -1000, 0), 1000,
                            Lambertian(NoiseTexture(2.0))))
    w.add(Quad((-3, 6, -2), (6, 0, 0), (0, 0, 4), DiffuseLight((5, 5, 5))))
    try:
        w.add(Mesh("assets/models", Metal((0.7, 0.6, 0.5), 0.1), scale=1.0))
    except FileNotFoundError:
        w.add(KleinBottle((0, 1.5, 0), 0.5, Metal((0.7, 0.6, 0.5), 0.1)))
    wax = SubsurfaceVolumetric((0.2, 0.5, 0.2), scatter_coeff=0.08,
                               absorb_coeff=0.8, g=0.7)
    w.add(Sphere.stationary((-2.5, 1.0, 0.5), 1.0, wax))
    w.add(Sphere.stationary((2.5, 1.0, -0.5), 1.0,
                            SubsurfaceSimple((0.9, 0.7, 0.6), 0.2)))
    return w, _cam(width=400, spp=64, depth=12, vfov=40,
                   lookfrom=(12, 5, 9), lookat=(0, 1.2, 0))


def mesh_hipoly(segments=320, sides=80):
    """High-poly mesh stress: a 51,200-triangle procedural torus knot.

    The scale regime the reference's 4,096-triangle cap
    (``fields.py:15`` MAX_TRIANGLES) cannot represent at all — here the
    capless padded-bucket scene arrays and the SAH BVH take it natively.
    No external asset: the knot is generated in-repo (geometry.torus_knot).
    """
    w = HittableList()
    w.add(Sphere.stationary((0, -1000, 0), 1000,
                            Lambertian(CheckerTexture(0.8, (0.2, 0.3, 0.1),
                                                      (0.9, 0.9, 0.9)))))
    w.add(torus_knot(Metal((0.75, 0.65, 0.5), 0.05), p=2, q=3,
                     segments=segments, sides=sides, tube_radius=0.35,
                     scale=1.0, center=(0.0, 1.6, 0.0)))
    w.add(Sphere.stationary((0, 7, 4), 2.0, DiffuseLight((6, 6, 6))))
    return w, _cam(width=400, spp=64, depth=10, vfov=35,
                   lookfrom=(9, 4.5, 7), lookat=(0, 1.4, 0))


SCENES = {
    "vol1_sec9_5": vol1_sec9_5,
    "vol1_sec14_1": vol1_sec14_1,
    "vol2_sec2_6": vol2_sec2_6,
    "vol2_sec4_3_simple": vol2_sec4_3_simple,
    "vol2_sec4_6": vol2_sec4_6,
    "vol2_sec5": vol2_sec5,
    "vol2_sec6": vol2_sec6,
    "triangles": triangles,
    "subsurface_scattering": subsurface_scattering,
    "simple_light": simple_light,
    "cornell_box": cornell_box,
    "cornell_glass_dof": cornell_glass_dof,
    "mesh_perlin_sss": mesh_perlin_sss,
    "mesh_hipoly": mesh_hipoly,
    "cornell_smoke": cornell_smoke,
    "vol2_final_scene": vol2_final_scene,
    "vol2_test_scene": vol2_test_scene,
    "wavefront_comparison": wavefront_comparison,
    "test_mesh": test_mesh,
    "klein_bottle": klein_bottle,
    "vol2_sec42_scene_simple": vol2_sec42_scene_simple,
    "vol2_sec4_6_ver2": vol2_sec4_6_ver2,
    "vol2_sec4_6_ver2_cpu": vol2_sec4_6_ver2_cpu,
    "emmission": emmission,
    "vol2_final_scene_simple": vol2_final_scene_simple,
    "vol2_sec2_6_interactive": vol2_sec2_6_interactive,
    "test_mesh_interactive": test_mesh_interactive,
}
