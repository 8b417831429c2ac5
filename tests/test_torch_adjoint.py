"""K6's full instantiation (``csrc/adjoint.cu``'s lane code, built by g++
through ``csrc/host_emulation.cpp``, which runs a launch's pixels as a
simulated warp of 32 lanes that fetch them out of order) against the
plain path, and the gradient buffers' map to the leaves.

* ``emu_adjoint_full`` with every floating leaf against ``plain_vjp``
  (autograd of the megakernel twin's replay, itself held against
  ``jax.grad`` in ``tests/test_torch_grad.py`` and
  ``tests/test_torch_grad_leaves.py``) on those files' setups and on
  cornell_box, vol2_final_scene(sphere_cluster=20) and mesh_perlin_sss, at
  32x18, 2 spp: relative L2 error at most 1e-4 per leaf, finite.  Float add
  order differs between the two (measured about 1e-7 to 4e-6).  A pixel
  whose forward colour differs between the emulated K5 and the twin is left
  out of the comparison (delta 0 there): the host's cosf/sinf/logf and
  torch's round some arguments differently, and on a grazing path into the
  marble ground of mesh_perlin_sss that last-bit difference moves the hit
  enough to change that pixel's gradient by a few per mille; at most 5% of
  the pixel-samples may be left out.
* The full instantiation against the colour one on the colour leaves
  (relative L2 ≤ 1e-5: the same path, the colour sweep's products in
  another order).
* Both instantiations at K = 4 and 8 on vol2_final: per leaf within 1e-4
  of the plain path.
* ``leaf_grads`` against autograd of ``make_tables`` (with ``mat_table``
  and ``med_table``), the atlas and the Perlin table, contracted with
  random buffers: equal.
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch.ops import adjoint
from path_tracer_tpu_torch.ops import integrator as tint
from path_tracer_tpu_torch.ops import kernels
from path_tracer_tpu_torch.ops.shade import SceneFlags as TFlags
from path_tracer_tpu_torch.ops.shade_tiled import make_tables
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg
from path_tracer_tpu_torch.utils import rng as trng

from test_torch_grad import SETUPS as GRAD_SETUPS
from test_torch_grad_leaves import LEAF_SETUPS

SETUPS = {**GRAD_SETUPS, **LEAF_SETUPS}

W, H, SPP = 32, 18, 2


def _scene(name):
    """(world, camera, depth) of a setup of test_torch_grad or a scene."""
    if name in SETUPS:
        build, (_w, _h, _spp, depth) = SETUPS[name][:2]
        world, cam = build(ptt)
        return world, cam, depth
    if name == "vol2_final_scene":
        return (*ptt.scenes.vol2_final_scene(sphere_cluster=20), 10)
    depth = {"cornell_box": 6, "mesh_perlin_sss": 12}[name]
    return (*getattr(ptt.scenes, name)(), depth)


def _engine(name, branching=4):
    world, cam, depth = _scene(name)
    cam.img_width, cam.aspect_ratio = W, W / H
    sc = ptt.compile_scene(world, device="cpu")
    return tint.MegaEngine(sc, TFlags.from_scene(sc),
                           ptt.build_from_scene(sc, branching),
                           cam.initialize(device="cpu"),
                           TCfg(width=W, height=H, samples_per_pixel=SPP,
                                max_depth=depth), trng.key(0))


@pytest.fixture(scope="module")
def emu():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    return (kernels.host_emulation_adjoint(full=True),
            kernels.host_emulation_adjoint(full=False),
            kernels.host_emulation_ops()[1])


@pytest.mark.parametrize("name", [*SETUPS, "cornell_box", "vol2_final_scene",
                                  "mesh_perlin_sss"])
def test_emulated_full_adjoint_matches_plain_path(emu, name):
    emu_full, emu_colour, emu_mega = emu
    eng = _engine(name)
    sc = eng.scene
    delta = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (W * H, 3)).astype(np.float32))
    gp, ge, gc = (adjoint.grad_buffers(sc) for _ in range(3))
    left_out = 0
    for s in range(SPP):
        mk, mp = (eng.init_state(torch.zeros((W * H, 3))) for _ in range(2))
        emu_mega(eng, mk, s)
        tint.megakernel_plain(eng, mp, s)
        same = (mk.color == mp.color).all(-1)
        left_out += int((~same).sum())
        d = delta * same[:, None]
        adjoint.adjoint(eng, mp, s, d, gp, full=True)       # plain on CPU
        emu_full(eng, mp, s, d, ge)
        emu_colour(eng, mp, s, d, gc)
    assert left_out <= 0.05 * W * H * SPP
    P, E, C = (adjoint.leaf_grads(sc, g) for g in (gp, ge, gc))
    for n in adjoint.FLOAT_LEAVES:
        assert bool(torch.isfinite(E[n]).all()), n
        assert float((E[n] - P[n]).norm()) <= 1e-4 * float(P[n].norm()), n
    for n in adjoint.COLOUR_LEAVES:
        assert float((C[n] - E[n]).norm()) <= 1e-5 * float(E[n].norm()), n
    if name in SETUPS:
        for n in SETUPS[name][3]:
            if n not in ("qd_q", "qd_u", "qd_v", "qd_w"):
                assert float(E[n].abs().sum()) > 0, n


_PLAIN = {}


def _plain_sample0(emu_mega, branching):
    """vol2_final_scene(sphere_cluster=20) at K = ``branching``, sample 0:
    the engine, its state, the delta (0 where the emulated K5 and the twin
    disagree, as above) and the plain path's gradient buffers."""
    if branching not in _PLAIN:
        eng = _engine("vol2_final_scene", branching)
        mk, mp = (eng.init_state(torch.zeros((W * H, 3))) for _ in range(2))
        emu_mega(eng, mk, 0)
        tint.megakernel_plain(eng, mp, 0)
        same = (mk.color == mp.color).all(-1)
        assert int((~same).sum()) <= 0.05 * W * H
        d = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (W * H, 3)).astype(np.float32)) * same[:, None]
        gp = adjoint.grad_buffers(eng.scene)
        adjoint.adjoint(eng, mp, 0, d, gp, full=True)       # plain on CPU
        _PLAIN[branching] = (eng, mp, d, gp)
    return _PLAIN[branching]


@pytest.mark.parametrize("branching", [4, 8])
@pytest.mark.parametrize("full", [True, False], ids=["full", "colour"])
def test_emulated_adjoint_in_fetch_order_matches_plain(emu, full, branching):
    """K6's lanes as the kernel's take their pixels: a simulated warp that
    fetches pixels from a counter when its lanes' work ends and runs one
    unit (a replay trip, a sweep unit) a turn, so pixels start and end out
    of order and a lane's tape and stack carry over from pixel to pixel.
    Both instantiations at K = 4 and 8 on vol2_final: per leaf within the
    tolerance above of the plain path."""
    eng, mp, d, gp = _plain_sample0(emu[2], branching)
    g = adjoint.grad_buffers(eng.scene)
    kernels.host_emulation_adjoint(full=full)(eng, mp, 0, d, g)
    P, E = (adjoint.leaf_grads(eng.scene, x) for x in (gp, g))
    for n in adjoint.FLOAT_LEAVES if full else adjoint.COLOUR_LEAVES:
        assert bool(torch.isfinite(E[n]).all()), n
        assert float((E[n] - P[n]).norm()) <= 1e-4 * float(P[n].norm()), n
    assert float(E["img_data"].abs().sum()) > 0
    if full:
        assert float(E["sph_c0"].abs().sum()) > 0


@pytest.mark.parametrize("name", ["mesh_perlin_sss", "cornell_smoke"])
def test_leaf_grads_transpose_the_tables(name):
    world, _cam = getattr(ptt.scenes, name)()
    sc = ptt.compile_scene(world, device="cpu")
    gen = torch.Generator().manual_seed(3)
    bufs = adjoint.GradBuffers(*(torch.randn(b.shape, generator=gen)
                                 for b in adjoint.grad_buffers(sc)))
    xs = {n: getattr(sc, n).clone().requires_grad_()
          for n in adjoint.FLOAT_LEAVES}
    sc2 = dataclasses.replace(sc, **xs)
    tabs = make_tables(sc2)
    loss = ((tabs.prim * bufs.prim).sum() + (tabs.mat * bufs.mat).sum()
            + (tabs.med * bufs.med).sum() + (tabs.tex * bufs.tex).sum()
            + (sc2.img_data.reshape(-1, 3) * bufs.img).sum()
            + (sc2.perlin_vec * bufs.perlin).sum())
    grads = torch.autograd.grad(loss, list(xs.values()), allow_unused=True)
    mapped = adjoint.leaf_grads(sc, bufs)
    for n, g in zip(xs, grads):
        assert g is not None, n
        assert torch.equal(mapped[n], g), n
