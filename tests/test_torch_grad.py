"""Gradients of the port against ``jax.grad`` of the JAX package, and K6's
per-pixel code against the port's plain path.

* ``integrator.render(differentiable=True)`` on the CPU (autograd of the
  megakernel twin's replay) against ``jax.grad`` of the JAX ``render`` on the
  setups of ``tests/test_grad.py``: emission/albedo colours, the metal fuzz
  plate, the dielectric ``mat_ir``, the SSS-volumetric ``mat_g``,
  ``mat_sigma_s`` and colour (the exponent), a sphere centre, and two more:
  the texture-demo atlas ``img_data`` and cornell_smoke's medium albedo.
* ``wavefront.render_batch_diff`` (primal image, stats, gradients of
  ``tex_c1``, ``tex_c2`` (checker), ``mat_fuzz``, ``mat_ir``) against the JAX ``render_batch_diff``
  on the setup of ``tests/test_integrator_tiled.py:83-112``, with the marble
  sphere of that world made solid: XLA's CPU backend contracts the marble's
  multiply-adds, so a marble forward matches JAX only under the graded rule
  (ROADMAP.md C), and this scene's forward matches exactly.

Tolerance: atol 2e-5, rtol 1e-3, JAX's own engine-to-engine limit for
gradients (``tests/test_integrator_tiled.py:111-112``).

* ``emu_adjoint`` (``csrc/adjoint.cu``'s per-pixel code built by g++ through
  ``csrc/host_emulation.cpp``) against the plain path's colour-leaf gradients
  on five scenes at 32x18, 2 spp: relative L2 error of the gradient vector
  at most 1e-4 (float add order differs; measured about 1e-7).
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu as pt
from path_tracer_tpu.ops import integrator as jint
from path_tracer_tpu.ops import wavefront as jwf
from path_tracer_tpu.ops.shade import SceneFlags as JFlags
from path_tracer_tpu.ops.types import RenderConfig as JCfg
import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.ops import adjoint
from path_tracer_tpu_torch.ops import camera as tcam
from path_tracer_tpu_torch.ops import integrator as tint
from path_tracer_tpu_torch.ops import kernels
from path_tracer_tpu_torch.ops import wavefront as twf
from path_tracer_tpu_torch.ops.shade import SceneFlags as TFlags
from path_tracer_tpu_torch.ops.types import MAT_SSS_VOLUMETRIC
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg
from path_tracer_tpu_torch.utils import rng as trng

ATOL, RTOL = 2e-5, 1e-3


def _grad_world(pkg):
    """tests/test_grad.py:_setup."""
    w = pkg.HittableList()
    w.add(pkg.Sphere.stationary((0, 0, -1), 0.5, pkg.Lambertian((0.7, 0.3, 0.3))))
    w.add(pkg.Sphere.stationary((0, -100.5, -1), 100,
                                pkg.Lambertian((0.6, 0.6, 0.2))))
    w.add(pkg.Sphere.stationary((1.2, 0, -1), 0.4,
                                pkg.Metal((0.9, 0.8, 0.7), 0.1)))
    w.add(pkg.Quad((-2, 1.5, -2), (1, 0, 0), (0, 0, 1),
                   pkg.DiffuseLight((3, 3, 3))))
    cam = pkg.Camera()
    cam.aspect_ratio = 1.5
    cam.img_width = 24
    return w, cam


def _fuzz_plate(pkg):
    w = pkg.HittableList()
    w.add(pkg.Quad((-5, -5, -2), (10, 0, 0), (0, 10, 0),
                   pkg.Metal((0.9, 0.9, 0.9), 0.3)))
    cam = pkg.Camera()
    cam.aspect_ratio = 1.5
    cam.img_width = 24
    cam.lookfrom = np.array([0.0, 0.0, 5.0])
    cam.lookat = np.array([0.0, 0.0, 0.0])
    return w, cam


def _solo(make_mat, width=16):
    """tests/test_grad.py:_solo_scene: one big sphere in the sky."""
    def build(pkg):
        w = pkg.HittableList()
        w.add(pkg.Sphere.stationary((0, 0, 0), 1.0, make_mat(pkg)))
        cam = pkg.Camera()
        cam.aspect_ratio = 1.5
        cam.img_width = width
        cam.lookfrom = np.array([0.0, 0.0, 3.0])
        cam.lookat = np.array([0.0, 0.0, 0.0])
        return w, cam
    return build


def _texture_wall(pkg):
    """The texture-demo scene (tools/train_demo.py:261-280) with a 4x4
    atlas: ``img_data`` is the leaf."""
    yy, xx = np.mgrid[0:4, 0:4] / 3.0
    atlas = np.stack([0.15 + 0.7 * xx, 0.15 + 0.7 * yy, 0.2 + 0.6 * (
        (np.arange(4)[:, None] + np.arange(4)[None, :]) % 2)], -1)
    w = pkg.HittableList()
    w.add(pkg.Quad((555, 0, 0), (0, 0, 555), (0, 555, 0),
                   pkg.Lambertian((0.12, 0.45, 0.15))))
    w.add(pkg.Quad((0, 0, 0), (0, 555, 0), (0, 0, 555),
                   pkg.Lambertian((0.65, 0.05, 0.05))))
    w.add(pkg.Quad((343, 554, 332), (-130, 0, 0), (0, 0, -105),
                   pkg.DiffuseLight((15, 15, 15))))
    w.add(pkg.Quad((0, 0, 555), (0, 555, 0), (555, 0, 0),
                   pkg.Lambertian(pkg.ImageTexture.from_array(
                       atlas.astype(np.float32)))))
    w.add(pkg.Quad((50, 50, -210), (455, 0, 0), (0, 455, 0),
                   pkg.DiffuseLight((1.5, 1.5, 1.5))))
    _, cam = pkg.scenes.cornell_box()
    cam.lookfrom = np.array([278.0, 278.0, -200.0])
    cam.aspect_ratio = 1.5
    cam.img_width = 24
    return w, cam


def _smoke(pkg):
    w, cam = pkg.scenes.cornell_smoke()
    cam.aspect_ratio = 1.5
    cam.img_width = 24
    return w, cam


_WAX = _solo(lambda pkg: pkg.SubsurfaceVolumetric((0.8, 0.7, 0.6), 2.0, 0.4,
                                                  g=0.3))

# name: (scene function, (width, height, spp, depth), key, leaves, tied leaves)
SETUPS = {
    "tex_c1": (_grad_world, (24, 16, 4, 5), 3, ("tex_c1",), ()),
    "sphere_centre": (_grad_world, (24, 16, 4, 5), 4, ("sph_c0",),
                      ("sph_c1",)),
    "fuzz_plate": (_fuzz_plate, (24, 16, 8, 3), 5, ("mat_fuzz",), ()),
    "mat_ir": (_solo(lambda pkg: pkg.Dielectric(1.5)), (16, 10, 4, 4), 7,
               ("mat_ir",), ()),
    "sss_volumetric": (_WAX, (16, 10, 2, 4), 7,
                       ("mat_g", "mat_sigma_s", "tex_c1"), ()),
    "img_data": (_texture_wall, (24, 16, 2, 4), 8, ("img_data",), ()),
    "medium_albedo": (_smoke, (24, 16, 2, 5), 9, ("tex_c1",), ()),
}


def _both(build, w, h):
    jw, jc = build(pt)
    scene = pt.compile_scene(jw)
    bvh = pt.build_from_scene(scene)
    cam = jc.initialize()
    port = (interop.from_numpy_scene(scene, "cpu"),
            interop.from_numpy_bvh(bvh, "cpu"),
            interop.from_numpy_camera(cam, "cpu"))
    return (scene, JFlags.from_scene(scene), bvh, cam), port


def _tkey(key):
    return interop.key_from_data(np.asarray(jax.random.key_data(key)), "cpu")


@pytest.mark.parametrize("name", list(SETUPS))
def test_render_grad_matches_jax(name):
    build, (w, h, spp, depth), seed, leaves, tied = SETUPS[name]
    (js, jf, jb, jc), (ts, tb, tc) = _both(build, w, h)
    key = jax.random.key(seed)

    def jloss(params):
        repl = dict(params)
        repl.update({t: params[leaves[0]] for t in tied})
        img = jint.render(dataclasses.replace(js, **repl), jf, jb, jc,
                          JCfg(width=w, height=h, samples_per_pixel=spp,
                               max_depth=depth, use_russian_roulette=False),
                          key, differentiable=True)
        return jnp.sum(img) / img.size

    jl, jg = jax.value_and_grad(jloss)({n: getattr(js, n) for n in leaves})
    xs = {n: getattr(ts, n).clone().requires_grad_() for n in leaves}
    repl = dict(xs)
    repl.update({t: xs[leaves[0]] for t in tied})
    img = tint.render(dataclasses.replace(ts, **repl), TFlags.from_scene(ts),
                      tb, tc, TCfg(width=w, height=h, samples_per_pixel=spp,
                                   max_depth=depth,
                                   use_russian_roulette=False),
                      _tkey(key), differentiable=True)
    loss = img.sum() / img.numel()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for n in leaves:
        g = xs[n].grad.numpy()
        assert np.isfinite(g).all(), n
        assert np.abs(g).max() > 0, n
        np.testing.assert_allclose(g, np.asarray(jg[n]), atol=ATOL,
                                   rtol=RTOL, err_msg=n)


def _diff_world(pkg):
    """tests/test_shade_tiled.py:_world_all_materials with the marble sphere
    solid (every family but marble: checker, metal, dielectric, light,
    SSS-simple triangle, SSS-volumetric sphere, a medium)."""
    w = pkg.HittableList()
    w.add(pkg.Sphere.stationary((0, -100.5, -1), 100,
                                pkg.Lambertian(pkg.CheckerTexture(
                                    0.5, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))))
    w.add(pkg.Sphere.stationary((0, 0, -1), 0.5,
                                pkg.Lambertian((0.5, 0.4, 0.3))))
    w.add(pkg.Sphere.stationary((1, 0, -1), 0.5, pkg.Metal((0.8, 0.6, 0.2), 0.3)))
    w.add(pkg.Sphere.stationary((-1, 0, -1), 0.5, pkg.Dielectric(1.5)))
    w.add(pkg.Quad((-2, 2, -2), (4, 0, 0), (0, 0, 2),
                   pkg.DiffuseLight((4, 4, 4))))
    w.add(pkg.Triangle((-2, -0.4, -2), (2, -0.4, -2), (0, 1.8, -2.5),
                       pkg.SubsurfaceSimple((0.9, 0.5, 0.4), 0.3)))
    w.add(pkg.Sphere.stationary((0, 0.2, -2.5), 0.7,
                                pkg.SubsurfaceVolumetric((0.8, 0.7, 0.6),
                                                         2.0, 0.3, g=0.4)))
    w.add(pkg.ConstantMedium.from_color(
        pkg.Sphere.stationary((0.2, 0.1, -1.2), 1.4, pkg.Dielectric(1.5)),
        (0.6, 0.7, 0.9), 0.8))
    cam = pkg.Camera()
    cam.aspect_ratio = 2.0
    cam.img_width = 16
    return w, cam


DIFF_LEAVES = ("tex_c1", "tex_c2", "mat_fuzz", "mat_ir")


@pytest.fixture(scope="module")
def diff_setup():
    """The JAX render_batch_diff's image, stats and gradients, made once."""
    (js, jf, jb, jc), port = _both(_diff_world, 16, 8)
    cfg = dict(width=16, height=8, samples_per_pixel=1, max_depth=4)
    key = jax.random.key(6)
    accum0 = jnp.zeros((8, 16, 3), jnp.float32)
    out = {}

    def loss(params):
        img, st = jwf.render_batch_diff(
            dataclasses.replace(js, **params), jf, jb, jc, JCfg(**cfg),
            accum0, 0, 1, key, queue_size=256, steps_per_wave=8, n_waves=512)
        out["img"], out["stats"] = img, st
        return jnp.mean(img ** 2)

    out["loss"], out["grads"] = jax.value_and_grad(loss)(
        {n: getattr(js, n) for n in DIFF_LEAVES})
    out["img"], out["stats"] = jwf.render_batch_diff(
        js, jf, jb, jc, JCfg(**cfg), accum0, 0, 1, key, queue_size=256,
        steps_per_wave=8, n_waves=512)
    return out, port, cfg, _tkey(key)


def _port_diff(port, cfg, key, sample_stride=None):
    ts, tb, tc = port
    xs = {n: getattr(ts, n).clone().requires_grad_() for n in DIFF_LEAVES}
    img, st = twf.render_batch_diff(
        dataclasses.replace(ts, **xs), TFlags.from_scene(ts), tb, tc,
        TCfg(**cfg), torch.zeros((cfg["height"], cfg["width"], 3)), 0,
        cfg["samples_per_pixel"], key, queue_size=256, steps_per_wave=8,
        n_waves=512, sample_stride=sample_stride)
    loss = torch.mean(img ** 2)
    loss.backward()
    return img, st, loss, {n: x.grad.numpy() for n, x in xs.items()}


def test_render_batch_diff_matches_jax(diff_setup):
    ref, port, cfg, key = diff_setup
    img, st, loss, grads = _port_diff(port, cfg, key)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref["img"]),
                               atol=ATOL)
    jst = ref["stats"]
    # (``waves`` counts the port's own schedule: K1 walks up to
    # steps_per_wave steps without JAX's adaptive early exit.)
    for k in ("paths", "total", "spawned", "rays", "depth_sum", "walk_steps"):
        assert int(st[k]) == int(jst[k]), k
    assert int(st["paths"]) == int(st["total"]) == 16 * 8
    np.testing.assert_array_equal(st["depth_hist"].numpy(),
                                  np.asarray(jst["depth_hist"]))
    np.testing.assert_allclose(loss.item(), float(ref["loss"]), rtol=1e-5)
    for n in DIFF_LEAVES:
        assert np.isfinite(grads[n]).all(), n
        np.testing.assert_allclose(grads[n], np.asarray(ref["grads"][n]),
                                   atol=ATOL, rtol=RTOL, err_msg=n)


def test_render_batch_diff_stride_and_engines_agree(diff_setup):
    """Gradients do not depend on the wavefront's sample stride, and the
    differentiable megakernel gives the wavefront's image and gradients
    (one sample set)."""
    _, port, cfg, key = diff_setup
    cfg2 = dict(cfg, samples_per_pixel=2)
    img1, _, l1, g1 = _port_diff(port, cfg2, key, sample_stride=1)
    img2, st2, l2, g2 = _port_diff(port, cfg2, key, sample_stride=2)
    assert int(st2["paths"]) == int(st2["total"])
    np.testing.assert_allclose(img2.detach().numpy(), img1.detach().numpy(),
                               atol=ATOL)
    ts, tb, tc = port
    xs = {n: getattr(ts, n).clone().requires_grad_() for n in DIFF_LEAVES}
    mimg = tint.render(dataclasses.replace(ts, **xs), TFlags.from_scene(ts),
                       tb, tc, TCfg(**cfg2), key, differentiable=True) * 2
    torch.mean(mimg ** 2).backward()
    np.testing.assert_allclose(mimg.detach().numpy(), img1.detach().numpy(),
                               atol=ATOL)
    for n in DIFF_LEAVES:
        np.testing.assert_allclose(g2[n], g1[n], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(xs[n].grad.numpy(), g1[n], atol=ATOL,
                                   rtol=RTOL)


def test_trace_ray_scan_equals_trace_ray_and_unused_leaves_get_zero():
    world, cam = _grad_world(ptt)
    ts = ptt.compile_scene(world, device="cpu")
    fl, tb = TFlags.from_scene(ts), ptt.build_from_scene(ts)
    tc = cam.initialize(device="cpu")
    cfg = TCfg(width=24, height=16, samples_per_pixel=1, max_depth=5)
    pix = torch.arange(24 * 16, dtype=torch.int32)
    key_p = trng.fold_in(trng.fold_in(trng.key(1), 0), pix)
    o, d, t = tcam.get_ray(tc, (pix % 24).float(), (pix // 24).float(),
                           trng.fold_in(key_p, 7))
    c1 = ts.tex_c1.clone().requires_grad_()
    c2 = ts.tex_c2.clone().requires_grad_()
    g = ts.mat_g.clone().requires_grad_()
    sc = dataclasses.replace(ts, tex_c1=c1, tex_c2=c2, mat_g=g)
    scan = tint.trace_ray_scan(sc, fl, tb, tc, cfg, o, d, t, key_p,
                               full_state=True)
    loop = tint.trace_ray(ts, fl, tb, tc, cfg, o, d, t, key_p,
                          full_state=True)
    for a, b in zip(scan, loop):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    scan.color.sum().backward()
    assert float(c1.grad.abs().max()) > 0
    img = tint.render(sc, fl, tb, tc, cfg, trng.key(1), differentiable=True)
    gc2, gg = torch.autograd.grad(img.sum(), (c2, g))
    # no checker and no SSS material: zero, not None and not NaN
    assert torch.equal(gc2, torch.zeros_like(c2))
    assert torch.equal(gg, torch.zeros_like(g))


def test_card_guard_refuses_non_colour_leaves():
    adjoint.check_leaves(["tex_c1", "tex_c2", "img_data"], on_card=True)
    adjoint.check_leaves(["mat_fuzz", "sph_c0", "tex_c1"], on_card=False)
    for leaf in ("mat_fuzz", "mat_ir", "mat_g", "mat_sigma_s", "mat_sigma_a",
                 "mat_scatter_dist", "sph_c0", "qd_q", "tr_v0", "tex_scale",
                 "med_density"):
        with pytest.raises(NotImplementedError, match="B13'"):
            adjoint.check_leaves(["tex_c1", leaf], on_card=True)


# --- K6's per-pixel code (host emulation) against the plain path ---

EMU_SCENES = {
    "cornell_box": (lambda: ptt.scenes.cornell_box(), 6),
    "texture_demo": (lambda: ptt.scenes.texture_demo(), 5),
    "vol2_sec4_3_simple": (lambda: ptt.scenes.vol2_sec4_3_simple(), 6),
    "cornell_smoke": (lambda: ptt.scenes.cornell_smoke(), 6),
    "subsurface_scattering": (lambda: ptt.scenes.subsurface_scattering(), 8),
}


@pytest.fixture(scope="module")
def emu_adjoint():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    return kernels.host_emulation_adjoint()


@pytest.mark.parametrize("name", list(EMU_SCENES))
def test_emulated_adjoint_matches_plain_path(emu_adjoint, name):
    build, depth = EMU_SCENES[name]
    world, cam = build()
    W, H = 32, 18
    cam.img_width, cam.aspect_ratio = W, W / H
    sc = ptt.compile_scene(world, device="cpu")
    eng = tint.MegaEngine(sc, TFlags.from_scene(sc), ptt.build_from_scene(sc),
                          cam.initialize(device="cpu"),
                          TCfg(width=W, height=H, samples_per_pixel=2,
                               max_depth=depth), trng.key(0))
    ms = eng.init_state(torch.zeros((W * H, 3)))
    delta = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (W * H, 3)).astype(np.float32))
    gp, ge = adjoint.grad_buffers(sc), adjoint.grad_buffers(sc)
    for s in range(2):
        adjoint.adjoint(eng, ms, s, delta, *gp)          # plain on CPU
        emu_adjoint(eng, ms, s, delta, *ge)
    vp = torch.cat([g.flatten() for g in gp])
    ve = torch.cat([g.flatten() for g in ge])
    assert float((ve - vp).norm()) <= 1e-4 * float(vp.norm())
    g = adjoint.leaf_grads(sc, *gp)
    mat_t = sc.mat_type.numpy()
    if name == "texture_demo":
        assert float((g["img_data"].abs().sum(-1) > 0).float().mean()) > 0.5
    elif name == "vol2_sec4_3_simple":                # checker: c1 and c2
        assert float(g["tex_c1"].abs().sum()) > 0
        assert float(g["tex_c2"].abs().sum()) > 0
    elif name == "cornell_smoke":                     # medium albedo rows
        med = sc.med_tex.numpy()
        assert float(g["tex_c1"][med].abs().sum()) > 0
    elif name == "subsurface_scattering":             # the SSS exponent
        rows = sc.mat_tex.numpy()[mat_t == MAT_SSS_VOLUMETRIC]
        assert float(g["tex_c1"][rows].abs().sum()) > 0
    else:
        assert float(g["tex_c1"].abs().sum()) > 0


def test_gradient_buffers_map_to_leaves():
    world, cam = ptt.scenes.cornell_box()
    cam.img_width = 8
    sc = ptt.compile_scene(world, device="cpu")
    eng = tint.MegaEngine(sc, TFlags.from_scene(sc), ptt.build_from_scene(sc),
                          cam.initialize(device="cpu"),
                          TCfg(width=8, height=8, samples_per_pixel=1,
                               max_depth=4), trng.key(0))
    g_tex, g_img = adjoint.grad_buffers(sc)
    assert g_tex.shape == (sc.tex_c1.shape[0], 6)
    assert g_img.shape == (sc.img_data[..., 0].numel(), 3)
    grads = adjoint.leaf_grads(sc, g_tex, g_img)
    assert grads["img_data"].shape == sc.img_data.shape
    assert grads["tex_c2"].shape == sc.tex_c2.shape
    ms = eng.init_state(torch.zeros((64, 3)))
    adjoint.adjoint(eng, ms, 0, torch.ones((64, 3)), g_tex, g_img)
    assert float(g_tex.abs().sum()) > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell_box", "texture_demo",
                                  "subsurface_scattering"])
def test_adjoint_kernel_matches_plain_on_card(cuda_device, name):
    """K6 against its plain version on the card (relative L2 ≤ 1e-3: the
    atomics' add order varies), and its launches counted."""
    build, depth = EMU_SCENES[name]
    world, cam = build()
    W, H = 64, 36
    cam.img_width, cam.aspect_ratio = W, W / H
    sc = ptt.compile_scene(world, device=cuda_device)
    eng = tint.MegaEngine(sc, TFlags.from_scene(sc), ptt.build_from_scene(sc),
                          cam.initialize(device=cuda_device),
                          TCfg(width=W, height=H, samples_per_pixel=1,
                               max_depth=depth), trng.key(0))
    ms = eng.init_state(torch.zeros((W * H, 3), device=cuda_device))
    delta = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (W * H, 3)).astype(np.float32)).to(cuda_device)
    gk, gp = adjoint.grad_buffers(sc), adjoint.grad_buffers(sc)
    before = kernels.LAUNCHES["adjoint"]
    adjoint.adjoint(eng, ms, 0, delta, *gk)
    assert kernels.LAUNCHES["adjoint"] == before + 1
    adjoint.adjoint_plain(eng, ms, 0, delta, *gp)
    torch.cuda.synchronize()
    vk = torch.cat([g.flatten() for g in gk])
    vp = torch.cat([g.flatten() for g in gp])
    assert float(vp.norm()) > 0
    assert float((vk - vp).norm()) <= 1e-3 * float(vp.norm())


@pytest.mark.gpu
def test_card_backward_refuses_non_colour_leaves(cuda_device):
    world, cam = ptt.scenes.cornell_box()
    cam.img_width = 16
    sc = ptt.compile_scene(world, device=cuda_device)
    fuzz = sc.mat_fuzz.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="B13'"):
        tint.render(dataclasses.replace(sc, mat_fuzz=fuzz),
                    TFlags.from_scene(sc), ptt.build_from_scene(sc),
                    cam.initialize(device=cuda_device),
                    TCfg(width=16, height=16, samples_per_pixel=1,
                         max_depth=4), trng.key(0, device=cuda_device),
                    differentiable=True)
