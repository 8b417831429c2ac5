"""The tiled fixed-trip engine (B12) against the JAX package's.

* ``render_tiled``'s image against JAX ``render_tiled`` on
  ``test_shade_tiled._world_all_materials`` at 32x16, 2 spp, depth 6, atol
  2e-5 (``tests/test_integrator_tiled.py:36-37``), and on a medium scene.
* Gradients of ``tex_c1``, ``mat_fuzz``, ``mat_ir``, ``sph_c0`` against
  ``jax.grad`` of JAX ``render_tiled`` at 16x8, depth 4, atol 2e-5 / rtol
  1e-3 (JAX's engine-to-engine limit, ``test_integrator_tiled.py:111-112``).
* The volume-exit query walks only lanes whose hit has a medium: the image
  is bit-equal to walking it on every lane that hit (JAX's mask), with
  fewer traversal steps.
* ``pix_idx``, pixel blocks and ``chunk_size`` change nothing.
* The lane code of K7 (``closest_hit``), K9 (``ring_hop``), K8
  (``tiled_trip``, its rec variant) and the tiled spawn, built for the CPU
  by ``csrc/host_emulation.cpp``, against their plain versions.
* On a CUDA card (marker ``gpu``): the kernels against their plain
  versions, and the tiled frame with its backward.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu as pt
from path_tracer_tpu.ops import integrator_tiled as jit_
from path_tracer_tpu.ops.shade import SceneFlags as JFlags
from path_tracer_tpu.ops.types import RenderConfig as JCfg
import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.ops import integrator_tiled as it
from path_tracer_tpu_torch.ops import kernels
from path_tracer_tpu_torch.ops.shade import SceneFlags as TFlags
from path_tracer_tpu_torch.ops.shade_tiled import refine_hit_t
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg
from path_tracer_tpu_torch.parallel import pipeline

from test_shade_tiled import _world_all_materials

ATOL, RTOL = 2e-5, 1e-3


def _smoke_world():
    """tests/test_sharding.py:217-241: a sphere in a fog ball under a light."""
    w = pt.HittableList()
    w.add(pt.Sphere.stationary((0, 0, -1), 0.5, pt.Lambertian((0.7, 0.3, 0.3))))
    w.add(pt.ConstantMedium(
        pt.Sphere.stationary((0, 0, -1), 2.0, pt.Lambertian((1, 1, 1))),
        0.4, (0.9, 0.9, 0.9)))
    w.add(pt.Quad((-2, 1.5, -2), (1, 0, 0), (0, 0, 1),
                  pt.DiffuseLight((4, 4, 4))))
    cam = pt.Camera()
    cam.aspect_ratio = 2.0
    return w, cam


def _both(world, cam, width, depth, spp=2):
    cam.img_width = width
    scene = pt.compile_scene(world)
    bvh = pt.build_from_scene(scene)
    cam_a = cam.initialize()
    kw = dict(width=width, height=width // 2, samples_per_pixel=spp,
              max_depth=depth)
    port = (interop.from_numpy_scene(scene, "cpu"),
            interop.from_numpy_bvh(bvh, "cpu"),
            interop.from_numpy_camera(cam_a, "cpu"))
    return (scene, JFlags.from_scene(scene), bvh, cam_a, JCfg(**kw)), \
        (port[0], TFlags.from_scene(port[0]), port[1], port[2], TCfg(**kw))


def _tkey(key):
    return interop.key_from_data(np.asarray(jax.random.key_data(key)), "cpu")


@pytest.mark.parametrize("world", ["all_materials", "smoke"])
def test_render_tiled_matches_jax(world):
    build = _world_all_materials if world == "all_materials" else _smoke_world
    (js, jf, jb, jc, jcfg), (ts, tf, tb, tc, tcfg) = _both(*build(), 32, 6)
    key = jax.random.key(11)
    ref = np.asarray(jit_.render_tiled(js, jf, jb, jc, jcfg, key, spp=2))
    img, stats = it.render_tiled(ts, tf, tb, tc, tcfg, _tkey(key), spp=2,
                                 with_stats=True)
    assert img.shape == (16, 32, 3) and int(stats["trav_steps"]) > 0
    np.testing.assert_allclose(img.numpy(), ref, atol=ATOL)
    if world == "all_materials":
        assert tf.has_sss and tf.has_medium and tf.has_noise
        assert int(stats["walk_steps"]) > 0


def test_exit_query_only_where_read(monkeypatch):
    """The volume-exit query walks only the live lanes whose hit has a
    medium (``exit_lanes``): the image is bit-equal to walking it on every
    live lane that hit (JAX's mask) and to JAX's within ATOL, with fewer
    lanes walked and fewer traversal steps."""
    (js, jf, jb, jc, jcfg), (ts, tf, tb, tc, tcfg) = _both(*_smoke_world(),
                                                           32, 6)
    assert tf.has_medium
    key = jax.random.key(11)
    walked = {}

    def counted(tag, rule):
        def mask(eng, alive, found, pt, pi):
            m = rule(eng, alive, found, pt, pi)
            walked[tag] = walked.get(tag, 0) + int(m.sum())
            return m
        return mask

    masked = it.exit_lanes
    monkeypatch.setattr(it, "exit_lanes", counted("medium", masked))
    img, st = it.render_tiled(ts, tf, tb, tc, tcfg, _tkey(key), spp=2,
                              with_stats=True)
    monkeypatch.setattr(it, "exit_lanes", counted(
        "found", lambda eng, alive, found, pt, pi: alive & found))
    full, st_full = it.render_tiled(ts, tf, tb, tc, tcfg, _tkey(key), spp=2,
                                    with_stats=True)
    assert torch.equal(img, full)
    assert 0 < walked["medium"] < walked["found"]
    assert 0 < int(st["trav_steps"]) < int(st_full["trav_steps"])
    assert int(st["walk_steps"]) == int(st_full["walk_steps"])
    ref = np.asarray(jit_.render_tiled(js, jf, jb, jc, jcfg, key, spp=2))
    np.testing.assert_allclose(img.numpy(), ref, atol=ATOL)


def test_render_tiled_grads_match_jax():
    (js, jf, jb, jc, jcfg), (ts, tf, tb, tc, tcfg) = _both(
        *_world_all_materials(), 16, 4)
    key = jax.random.key(12)
    names = ("tex_c1", "mat_fuzz", "mat_ir", "sph_c0")

    def jloss(params):
        s = dataclasses.replace(js, **params)
        return jnp.mean(jit_.render_tiled(s, jf, jb, jc, jcfg, key, spp=1) ** 2)

    jl, jg = jax.value_and_grad(jloss)({n: getattr(js, n) for n in names})
    xs = {n: getattr(ts, n).clone().requires_grad_() for n in names}
    img = it.render_tiled(dataclasses.replace(ts, **xs), tf, tb, tc, tcfg,
                          _tkey(key), spp=1)
    loss = torch.mean(img ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for n in names:
        g = xs[n].grad.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(jg[n]), atol=ATOL, rtol=RTOL,
                                   err_msg=n)
    assert float(np.abs(xs["tex_c1"].grad.numpy()).max()) > 0


def test_pixel_blocks_and_chunks_change_nothing():
    _, (ts, tf, tb, tc, tcfg) = _both(*_world_all_materials(), 16, 4)
    key = torch.tensor([0, 5])
    full = it.render_sample_tiled(ts, tf, tb, tc, tcfg, 1, key)
    pix = torch.tensor([3, 77, 5, 127, 64, 0, 99], dtype=torch.int32)
    part = it.render_sample_tiled(ts, tf, tb, tc, tcfg, 1, key, pix_idx=pix,
                                  chunk_size=3)
    assert torch.equal(part, full.reshape(-1, 3)[pix.long()])
    whole = it.render_tiled(ts, tf, tb, tc, tcfg, key, spp=2)
    block = it.render_tiled(ts, tf, tb, tc, tcfg, key, spp=2, pix_offset=40,
                            n_pix=50, chunk_size=16)
    assert torch.equal(block, whole.reshape(-1, 3)[40:90])
    # the megakernel twin integrates the same sample set
    mega = ptt.ops.integrator.render(ts, tf, tb, tc, tcfg, key, spp=2)
    assert torch.equal(whole, mega)


# ---------------------------------------------------------------------------
# The kernels' lane code, built for the CPU.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emu():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    return kernels.host_emulation_lanes()


def _lanes_setup():
    _, (ts, tf, tb, tc, tcfg) = _both(*_world_all_materials(), 32, 6)
    eng = it.TiledEngine(ts, tf, tb, tc, tcfg, torch.tensor([0, 3]))
    pix = torch.arange(32 * 16, dtype=torch.int32)
    return eng, pix


def _emu_args(eng, n, ctr, **lanes):
    a = kernels.fill_args(eng)
    return kernels.set_lanes(a, n, torch.device("cpu"), ctr, **lanes)


def test_emulated_lane_kernels_match_plain(emu):
    eng, pix = _lanes_setup()
    cfg, R = eng.cfg, pix.shape[0]
    # tiled_spawn against spawn_paths
    st = it.tiled_spawn(eng, 2, pix)
    es = it.PathState(*(torch.empty_like(x) for x in st))
    a = _emu_args(eng, R, it.new_counters("cpu"), pixel=pix, **es._asdict())
    a.start_sample = 2
    emu["tiled_spawn"](a)
    for x, y in zip(st, es):
        torch.testing.assert_close(y, x, rtol=1e-6, atol=1e-6)
    # Run the paths a few trips with the plain versions; at each trip hold
    # K7 (main and exit queries), K8 and K9 against them on the same state.
    t_min = torch.full((R,), cfg.t_min)
    walked = 0
    for trip in range(4):
        c_p, c_k = it.new_counters("cpu"), it.new_counters("cpu")
        hit = it.closest_hit_plain(eng.bvh, st.origin, st.direction, st.time,
                                   t_min, cfg.t_max, cfg.stack_depth,
                                   st.alive, c_p)
        out = [torch.empty_like(x) for x in hit]
        emu["closest_hit"](_emu_args(
            eng, R, c_k, origin=st.origin, direction=st.direction,
            time=st.time, q_tmin=t_min, q_active=st.alive, hit_found=out[0],
            hit_pt=out[1], hit_pi=out[2], hit_t=out[3]))
        for x, y in zip(hit, out):
            assert torch.equal(x, y), trip
        t_e = (hit[3] + 1e-4).contiguous()
        ext = it.closest_hit_plain(eng.bvh, st.origin, st.direction, st.time,
                                   t_e, cfg.t_max, cfg.stack_depth,
                                   st.alive & hit[0], c_p)
        e_out = [torch.empty_like(x) for x in ext]
        emu["closest_hit"](_emu_args(
            eng, R, c_k, origin=st.origin, direction=st.direction,
            time=st.time, q_tmin=t_e, q_active=st.alive & hit[0],
            hit_found=e_out[0], hit_pt=e_out[1], hit_pi=e_out[2],
            hit_t=e_out[3]))
        for x, y in zip(ext, e_out):
            assert torch.equal(x, y), trip
        # the exit query as the engine walks it: K7 gated on the main hit's
        # medium (set_gate), the plain version on exit_lanes' mask
        g_ext = it.closest_hit_plain(eng.bvh, st.origin, st.direction,
                                     st.time, t_e, cfg.t_max,
                                     cfg.stack_depth,
                                     it.exit_lanes(eng, st.alive, *hit[:3]),
                                     c_p)
        g_out = [torch.empty_like(x) for x in g_ext]
        a = _emu_args(eng, R, c_k, origin=st.origin, direction=st.direction,
                      time=st.time, q_tmin=t_e, q_active=st.alive,
                      hit_found=g_out[0], hit_pt=g_out[1], hit_pi=g_out[2],
                      hit_t=g_out[3])
        emu["closest_hit"](kernels.set_gate(a, R, torch.device("cpu"),
                                            eng.tabs, hit[1], hit[2]))
        for x, y in zip(g_ext, g_out):
            assert torch.equal(x, y), trip
        assert int(c_p[it.C_TRAV_STEPS]) == int(c_k[it.C_TRAV_STEPS]) > 0
        # K9: one hop from an empty bundle refines this stage's hits
        fnd = torch.zeros((R,), dtype=torch.bool)
        tb = torch.full((R,), 1e30)
        rec = pipeline._empty_rec(R, "cpu")
        pipeline.ring_hop_plain(eng, st.origin, st.direction, st.time, t_min,
                                st.alive, fnd, tb, rec)
        k_fnd, k_tb = torch.zeros_like(fnd), torch.full_like(tb, 1e30)
        k_rec = pipeline._empty_rec(R, "cpu")
        emu["ring_hop"](_emu_args(
            eng, R, it.new_counters("cpu"), origin=st.origin,
            direction=st.direction, time=st.time, q_tmin=t_min,
            q_active=st.alive, hit_found=k_fnd, hit_t=k_tb, rec=k_rec))
        assert torch.equal(fnd, k_fnd) and torch.equal(tb, k_tb)
        # refine's sin/acos/atan2: host libm and torch differ in the last bit
        torch.testing.assert_close(k_rec, rec, rtol=1e-5, atol=1e-5)
        # K8 and its rec variant against the plain trip
        nxt = it.tiled_trip_plain(eng, st, 2, pix, hit[:3], ext, ctr=c_p)
        ke = [x.clone() for x in st]
        lanes = dict(zip(st._fields, ke), pixel=pix, hit_found=hit[0],
                     hit_pt=hit[1], hit_pi=hit[2], exit_found=ext[0],
                     exit_pt=ext[1], exit_pi=ext[2], exit_t=ext[3])
        a = _emu_args(eng, R, c_k, **lanes)
        a.start_sample = 2
        emu["tiled_trip"](a)
        kr = [x.clone() for x in st]
        lanes_r = dict(lanes, **dict(zip(st._fields, kr)), rec=rec)
        lanes_r["exit_med"] = ext[0] & (it.prim_medium_t(
            eng.tabs, ext[1], ext[2]) >= 0)
        a = _emu_args(eng, R, it.new_counters("cpu"), **lanes_r)
        a.start_sample = 2
        emu["tiled_trip_rec"](a)
        same = (nxt.alive == ke[7]) & (nxt.depth == ke[5])
        assert float(same.float().mean()) >= 0.99, trip
        for x, y, z in zip(nxt, ke, kr):
            torch.testing.assert_close(y[same], x[same], rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(z[same], x[same], rtol=1e-4, atol=1e-4)
        walked += int(c_k[it.C_WALK_STEPS])
        st = nxt
    assert walked > 0


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

def _hop_unbounded(eng, ray, carry, ctr):
    """One ring hop as JAX takes it (``parallel/pipeline.py:80-90``): the
    stage's walk to t_max, its hit refined, merged where strictly closer."""
    ro, rd, time, t_min, active = ray
    fnd, tbest, rec = carry
    found, pt, pi, t = it.closest_hit_plain(eng.bvh, ro, rd, time, t_min,
                                            eng.cfg.t_max,
                                            eng.cfg.stack_depth, active, ctr)
    loc = refine_hit_t(eng.tabs, pt, pi, *ro.unbind(-1), *rd.unbind(-1), time,
                       t_min)
    better = found & (t < tbest)
    return (fnd | better, torch.where(better, t, tbest),
            torch.where(better[:, None], it.rec_to_rows(loc), rec))


@pytest.mark.parametrize("branching", [4, 8])
def test_emulated_ring_hop_walks_to_the_carried_best(emu, branching):
    """K9's walk ends at the carried best.  Over a two-shard ring of
    vol2_final (its glass ball held twice, in both shards, so hits tie
    exactly across stages), the main and the volume-exit query of the
    camera rays: after each hop the bounded plain version's bundle equals
    the unbounded hop's bit for bit, the g++-built K9's found and t equal it
    exactly and its record within the last bit of the host's libm; the
    kernel's traversal steps equal the bounded plain version's, the same as
    the unbounded walk's on the first hop (from an empty bundle) and fewer
    on the second."""
    from path_tracer_tpu_torch.parallel import shard_scene
    from path_tracer_tpu_torch.parallel.scene_shard import local_shard
    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=20)
    W, H = 32, 18
    cam.aspect_ratio, cam.img_width = W / H, W
    sc = ptt.compile_scene(world, device="cpu")
    flags, cam_a = TFlags.from_scene(sc), cam.initialize(device="cpu")
    cfg = TCfg(width=W, height=H, samples_per_pixel=1, max_depth=10)
    sc_t, bv_t = shard_scene(sc, 2, branching=branching)
    key = torch.tensor([0, 7])
    engs = []
    for r in range(2):
        sc_l, bv_l = local_shard(sc_t, bv_t, r)
        engs.append(it.TiledEngine(sc_l, flags, bv_l, cam_a, cfg, key))
    R = W * H
    st = it.tiled_spawn(engs[0], 0, torch.arange(R, dtype=torch.int32))
    t_main = torch.full((R,), cfg.t_min)
    queries = [(t_main, st.alive)]
    pruned = 0
    for q in range(2):
        t_min, active = queries[q]
        ray = (st.origin, st.direction, st.time, t_min, active)
        carry = (torch.zeros((R,), dtype=torch.bool),
                 torch.full((R,), 1e30), pipeline._empty_rec(R, "cpu"))
        for hop, eng in enumerate(engs):
            c_u, c_p, c_k = (it.new_counters("cpu") for _ in range(3))
            ref = _hop_unbounded(eng, ray, carry, c_u)
            plain = tuple(x.clone() for x in carry)
            pipeline.ring_hop_plain(eng, *ray, *plain, ctr=c_p)
            kern = tuple(x.clone() for x in carry)
            emu["ring_hop"](_emu_args(
                eng, R, c_k, origin=st.origin, direction=st.direction,
                time=st.time, q_tmin=t_min, q_active=active,
                hit_found=kern[0], hit_t=kern[1], rec=kern[2]))
            for x, y in zip(plain, ref):
                assert torch.equal(x, y), (q, hop)
            assert torch.equal(kern[0], ref[0]) and torch.equal(kern[1],
                                                                ref[1])
            torch.testing.assert_close(kern[2], ref[2], rtol=1e-5, atol=1e-5)
            steps = [int(c[it.C_TRAV_STEPS]) for c in (c_u, c_p, c_k)]
            assert steps[2] == steps[1] > 0, (q, hop, steps)
            if hop == 0:
                assert steps[1] == steps[0], (q, steps)
            else:
                assert steps[1] < steps[0], (q, steps)
                pruned += steps[0] - steps[1]
            carry = ref
        if q == 0:
            queries.append((carry[1] + 1e-4, active & carry[0]))
    assert pruned > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    return torch.device("cuda")


@pytest.mark.gpu
def test_tiled_engine_on_card(cuda_device):
    """render_tiled through K7/K8 (and its K6 backward) against the plain
    versions on the card: the graded image rule, gradients within rel L2
    1e-3."""
    _, port = _both(*_world_all_materials(), 64, 6)
    ts, tf, tb, tc, tcfg = port
    ts, tb, tc = ts.to(cuda_device), tb.to(cuda_device), tc.to(cuda_device)
    key = torch.tensor([0, 9], device=cuda_device)
    x = ts.tex_c1.clone().requires_grad_()
    kernels.reset_launches()
    img = it.render_tiled(dataclasses.replace(ts, tex_c1=x), tf, tb, tc, tcfg,
                          key, spp=2)
    img.square().mean().backward()
    for n in ("closest_hit", "tiled_trip", "tiled_spawn", "adjoint"):
        assert kernels.LAUNCHES[n] > 0, n
    ref = ptt.ops.integrator.render(ts, tf, tb, tc, tcfg, key, spp=2)
    per_pix = (img.detach() - ref).abs().max(-1).values.cpu().numpy()
    assert (per_pix > 1e-3).mean() <= 0.01
    assert per_pix[per_pix <= 1e-3].mean() < 1e-5
    xp = ts.tex_c1.cpu().clone().requires_grad_()
    ip = it.render_tiled(dataclasses.replace(ts.to("cpu"), tex_c1=xp), tf,
                         tb.to("cpu"), tc.to("cpu"), tcfg, key.cpu(), spp=2)
    ip.square().mean().backward()
    g, gp = x.grad.cpu(), xp.grad
    assert float((g - gp).norm() / gp.norm()) <= 1e-3


@pytest.mark.gpu
def test_lane_kernels_match_plain_on_card(cuda_device):
    """K7, K9 and K8 (with its rec variant) against their plain versions on
    the card, on the first trip of a 64x32 frame of every material."""
    _, port = _both(*_world_all_materials(), 64, 6)
    ts, tf, tb, tc, tcfg = port
    ts, tb, tc = ts.to(cuda_device), tb.to(cuda_device), tc.to(cuda_device)
    eng = it.TiledEngine(ts, tf, tb, tc, tcfg,
                         torch.tensor([0, 4], device=cuda_device))
    R = tcfg.width * tcfg.height
    pix = torch.arange(R, dtype=torch.int32, device=cuda_device)
    st = it.tiled_spawn(eng, 0, pix)
    t_min = torch.full((R,), tcfg.t_min, device=cuda_device)
    q = (tb, st.origin, st.direction, st.time, t_min, tcfg.t_max,
         tcfg.stack_depth)
    c_k, c_p = it.new_counters(cuda_device), it.new_counters(cuda_device)
    hit = it.closest_hit_batched(*q, active=st.alive, ctr=c_k)
    ref = it.closest_hit_plain(*q, active=st.alive, ctr=c_p)
    for x, y in zip(hit, ref):
        assert torch.equal(x, y)
    assert torch.equal(c_k, c_p)
    fnd = torch.zeros((R,), dtype=torch.bool, device=cuda_device)
    tbest = torch.full((R,), 1e30, device=cuda_device)
    rec = pipeline._empty_rec(R, cuda_device)
    k = (fnd.clone(), tbest.clone(), rec.clone())
    p = (fnd.clone(), tbest.clone(), rec.clone())
    pipeline.ring_hop(eng, st.origin, st.direction, st.time, t_min, st.alive,
                      *k)
    pipeline.ring_hop_plain(eng, st.origin, st.direction, st.time, t_min,
                            st.alive, *p)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    torch.testing.assert_close(k[2], p[2], rtol=1e-5, atol=1e-5)
    ext = it.closest_hit_batched(tb, st.origin, st.direction, st.time,
                                 hit[3] + 1e-4, tcfg.t_max, tcfg.stack_depth,
                                 active=st.alive & hit[0])
    nxt = it.tiled_trip_plain(eng, st, 0, pix, hit[:3], ext)
    ks = it.PathState(*(x.clone() for x in st))
    it.tiled_trip(eng, ks, 0, pix, hit[:3], ext)
    kr = it.PathState(*(x.clone() for x in st))
    exit_med = ext[0] & (it.prim_medium_t(eng.tabs, ext[1], ext[2]) >= 0)
    it.tiled_trip(eng, kr, 0, pix, hit[:3], ext, exit_med=exit_med,
                  rec=p[2])
    same = (nxt.alive == ks.alive) & (nxt.depth == ks.depth)
    assert float(same.float().mean()) >= 0.999
    for x, y, z in zip(nxt, ks, kr):
        torch.testing.assert_close(y[same], x[same], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(z[same], x[same], rtol=1e-4, atol=1e-4)
    assert kernels.LAUNCHES["ring_hop"] > 0
    assert kernels.LAUNCHES["tiled_trip_rec"] > 0


@pytest.mark.gpu
def test_exit_gate_matches_mask_on_card(cuda_device):
    """K7's volume-exit launch gated on the main hit's medium (``exit_of``)
    against the plain version on ``exit_lanes``' mask, on the card: found,
    pt, pi, t and the traversal steps exactly; fewer lanes walk than with
    JAX's mask (every live lane that hit)."""
    _, port = _both(*_smoke_world(), 64, 6)
    ts, tf, tb, tc, tcfg = port
    ts, tb, tc = ts.to(cuda_device), tb.to(cuda_device), tc.to(cuda_device)
    eng = it.TiledEngine(ts, tf, tb, tc, tcfg,
                         torch.tensor([0, 4], device=cuda_device))
    R = tcfg.width * tcfg.height
    pix = torch.arange(R, dtype=torch.int32, device=cuda_device)
    st = it.tiled_spawn(eng, 0, pix)
    t_min = torch.full((R,), tcfg.t_min, device=cuda_device)
    hit = it.closest_hit_batched(tb, st.origin, st.direction, st.time, t_min,
                                 tcfg.t_max, tcfg.stack_depth, active=st.alive)
    mask = it.exit_lanes(eng, st.alive, *hit[:3])
    assert 0 < int(mask.sum()) < int((st.alive & hit[0]).sum())
    q = (tb, st.origin, st.direction, st.time, hit[3] + 1e-4, tcfg.t_max,
         tcfg.stack_depth)
    c_k, c_p = it.new_counters(cuda_device), it.new_counters(cuda_device)
    ext = it.closest_hit_batched(*q, active=st.alive, ctr=c_k,
                                 exit_of=(eng, *hit[:3]))
    ref = it.closest_hit_plain(*q, active=mask, ctr=c_p)
    for x, y in zip(ext, ref):
        assert torch.equal(x, y)
    assert torch.equal(c_k, c_p)


def test_lane_kernels_refuse_a_bvh8():
    """The node-width check of the lane kernels' argument blocks: a BVH8
    (shard_scene's branching=8) is taken like a BVH4, its width carried to
    the launchers; any other width is refused before a pointer is taken."""
    _, (ts, tf, tb, tc, tcfg) = _both(*_world_all_materials(), 16, 4)
    bvh8 = ptt.build_from_scene(ts, branching=8)
    key = torch.tensor([0, 1])
    for bvh, k in ((tb, 4), (bvh8, 8)):
        a = kernels.query_args(bvh, tcfg.t_max, 8)
        assert (a.branching, a.nodes) == (k, bvh.nodes.data_ptr())
        e = it.TiledEngine(ts, tf, bvh, tc, tcfg, key).args()
        assert (e.branching, e.nodes) == (k, bvh.nodes.data_ptr())
    bvh16 = dataclasses.replace(bvh8, branching=16)
    with pytest.raises(ValueError, match="node widths"):
        kernels.query_args(bvh16, tcfg.t_max, 8)
    with pytest.raises(ValueError, match="node widths"):
        it.TiledEngine(ts, tf, bvh16, tc, tcfg, key).args()
