"""Render gradients of the port against ``jax.grad`` for the leaves that
move rays: a solo sphere's ``sph_c1``/``sph_rad``, the fuzz plate's quad as
a marble wall (``qd_n``/``qd_d``, and the exactly-zero ``qd_q``/``qd_u``/
``qd_v``/``qd_w``), two triangles over a ground sphere (``tr_v0``/
``tr_e1``/``tr_e2``/``tr_n``), the SSS-simple ``mat_scatter_dist``, a fog
ball's ``med_density`` and a marble solo sphere's ``tex_scale``/
``perlin_vec`` (its forward matches JAX within the tolerance here, so no
finite-difference stand-in is needed).  The check and its tolerance are
``tests/test_torch_grad.py``'s ``check_render_grad``.
"""
import numpy as np
import pytest

from test_torch_grad import _solo, check_render_grad


def _marble_plate(pkg):
    """The fuzz plate's quad as a diffuse marble wall: its hit point moves
    with ``qd_n``/``qd_d`` and the marble reads it (on the metal plate only
    the reflected direction, hence only ``qd_n``, reaches the sky)."""
    w = pkg.HittableList()
    w.add(pkg.Quad((-5, -5, -2), (10, 0, 0), (0, 10, 0),
                   pkg.Lambertian(pkg.NoiseTexture(2.0))))
    cam = pkg.Camera()
    cam.aspect_ratio = 1.5
    cam.img_width = 24
    cam.lookfrom = np.array([0.0, 0.0, 5.0])
    cam.lookat = np.array([0.0, 0.0, 0.0])
    return w, cam


def _triangle_world(pkg):
    """Two solid triangles (lambertian, metal) over a ground sphere, as
    ``scenes.triangles`` with solid colours, under the sky."""
    w = pkg.HittableList()
    w.add(pkg.Sphere.stationary((0, -1000, 0), 1000,
                                pkg.Lambertian((0.5, 0.5, 0.5))))
    w.add(pkg.Triangle((-2, 0, -1), (-1, 2, -1), (0, 0, -1),
                       pkg.Lambertian((0.9, 0.2, 0.2))))
    w.add(pkg.Triangle((0.5, 0, 0), (1.5, 2, 0), (2.5, 0, 0),
                       pkg.Metal((0.8, 0.8, 0.7), 0.2)))
    cam = pkg.Camera()
    cam.aspect_ratio = 1.5
    cam.img_width = 24
    cam.vfov = 50
    cam.lookfrom = np.array([0.0, 1.0, 5.0])
    cam.lookat = np.array([0.5, 1.0, 0.0])
    return w, cam


def _fog_world(pkg):
    """A fog ball around a diffuse sphere under the sky: after a scatter in
    the fog the next hit's normal, hence the diffuse direction and the sky
    it sees, depends on where the fog scattered (cornell_smoke's lambertian
    quads under a black sky give ``med_density`` no gradient at all)."""
    w = pkg.HittableList()
    w.add(pkg.Sphere.stationary((0, 0, 0), 0.6,
                                pkg.Lambertian((0.7, 0.6, 0.5))))
    w.add(pkg.ConstantMedium.from_color(
        pkg.Sphere.stationary((0, 0, 0), 1.2, pkg.Dielectric(1.5)),
        (0.8, 0.8, 0.9), 0.7))
    cam = pkg.Camera()
    cam.aspect_ratio = 1.5
    cam.img_width = 16
    cam.lookfrom = np.array([0.0, 0.0, 3.0])
    cam.lookat = np.array([0.0, 0.0, 0.0])
    return w, cam


# Leaves that only set a quad's (u, v), which no texture differentiates
# (floor and integer casts): exactly zero in JAX and in the port.
ZERO_LEAVES = ("qd_q", "qd_u", "qd_v", "qd_w")

# name: (scene function, (width, height, spp, depth), key, leaves, tied leaves)
LEAF_SETUPS = {
    "sphere_c1_radius": (_solo(lambda pkg: pkg.Metal((0.9, 0.85, 0.8), 0.0)),
                         (16, 10, 4, 4), 7, ("sph_c1", "sph_rad"), ()),
    "quad_plate": (_marble_plate, (24, 16, 4, 3), 5,
                   ("qd_n", "qd_d") + ZERO_LEAVES, ()),
    "triangles": (_triangle_world, (24, 16, 2, 4), 11,
                  ("tr_v0", "tr_e1", "tr_e2", "tr_n"), ()),
    "sss_simple": (_solo(lambda pkg: pkg.SubsurfaceSimple((0.8, 0.6, 0.5),
                                                          0.2)),
                   (16, 10, 4, 4), 7, ("mat_scatter_dist",), ()),
    "med_density": (_fog_world, (16, 10, 4, 5), 12, ("med_density", "tex_c1"),
                    ()),
    "marble": (_solo(lambda pkg: pkg.Lambertian(pkg.NoiseTexture(4.0))),
               (16, 10, 4, 4), 7, ("tex_scale", "perlin_vec"), ()),
}


@pytest.mark.parametrize("name", LEAF_SETUPS)
def test_render_grad_matches_jax(name):
    check_render_grad(LEAF_SETUPS[name], zero=ZERO_LEAVES)
