"""The port's scene sharding (tensor and pipeline parallel) against JAX's.

* ``shard_scene``'s arrays equal JAX's exactly: the round-robin deal, the
  donor duplicate for an empty shard, the ``-1`` medium pad rows, and the
  padded BVH rows (inverted boxes, empty child pointers), for 2 and 4
  shards at branching 4 and 8, and a 4-way deal that leaves shards empty.
* ``render_tp`` and ``render_pp`` on 2 gloo ranks (shards' BVHs of 4- and
  8-wide nodes) against JAX's on a 2-device virtual mesh, on the scene of
  ``tests/test_sharding.py:_setup`` and on its medium scene
  (``:217-241``), atol 1e-5 (the JAX suite's limit for these modes
  against the replicated render).
* ``render_dp_tp`` on 4 ranks (2x2) against JAX's on a 2x2 mesh, atol 1e-5.

The rank processes import only the port (``tests/torch_ranks.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import path_tracer_tpu as pt
from path_tracer_tpu.ops.shade import SceneFlags as JFlags
from path_tracer_tpu.ops.types import RenderConfig as JCfg
from path_tracer_tpu.parallel import pipeline as jpp
from path_tracer_tpu.parallel import render_dist as jrd
from path_tracer_tpu.parallel import scene_shard as jss
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.parallel import render_dp_tp, shard_scene

import torch_ranks as tr

CFG = dict(width=32, height=16, samples_per_pixel=2, max_depth=5)
ATOL = 1e-5


def _setup_world():
    """tests/test_sharding.py:_setup: two spheres and a quad light."""
    w = pt.HittableList()
    w.add(pt.Sphere.stationary((0, 0, -1), 0.5, pt.Lambertian((0.7, 0.3, 0.3))))
    w.add(pt.Sphere.stationary((0, -100.5, -1), 100,
                               pt.Lambertian((0.8, 0.8, 0.0))))
    w.add(pt.Quad((-2, 1.5, -2), (1, 0, 0), (0, 0, 1),
                  pt.DiffuseLight((4, 4, 4))))
    return w


def _medium_world():
    """tests/test_sharding.py:217-241: a sphere in a fog ball."""
    w = pt.HittableList()
    w.add(pt.Sphere.stationary((0, 0, -1), 0.5, pt.Lambertian((0.7, 0.3, 0.3))))
    w.add(pt.ConstantMedium(
        pt.Sphere.stationary((0, 0, -1), 2.0, pt.Lambertian((1, 1, 1))),
        0.4, (0.9, 0.9, 0.9)))
    w.add(pt.Quad((-2, 1.5, -2), (1, 0, 0), (0, 0, 1),
                  pt.DiffuseLight((4, 4, 4))))
    return w


def _compiled(world):
    cam = pt.Camera()
    cam.aspect_ratio = 2.0
    cam.img_width = CFG["width"]
    scene = pt.compile_scene(world)
    return scene, JFlags.from_scene(scene), pt.build_from_scene(scene), \
        cam.initialize()


def _job(name, world, seed, **kw):
    scene, _, bvh, cam = _compiled(world)
    b = tr.fields(bvh, ["nodes", "prims", "root"])
    b.update(prim_mask=np.array(bvh.prim_mask), max_stack=bvh.max_stack,
             branching=bvh.branching)
    return dict(name=name, scene=tr.fields(scene), bvh=b, cam=tr.fields(cam),
                key=np.asarray(jax.random.key_data(jax.random.key(seed))),
                cfg=CFG, spp=CFG["samples_per_pixel"], **kw)


# ---------------------------------------------------------------------------
# shard_scene: pure numpy and the BVH builder.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene_name,n_shards,branching", [
    ("mesh_perlin_sss", 2, 4), ("mesh_perlin_sss", 4, 4),
    ("mesh_perlin_sss", 2, 8), ("mesh_perlin_sss", 4, 8),
    ("empty_shards", 4, 4)])
def test_shard_scene_matches_jax(scene_name, n_shards, branching):
    if scene_name == "empty_shards":
        # 2 spheres and 1 quad dealt 4 ways: shards 2 and 3 get nothing and
        # take the donor duplicate.
        scene = pt.compile_scene(_setup_world())
    else:
        scene = pt.compile_scene(getattr(pt.scenes, scene_name)()[0])
    j_sc, j_bvh = jss.shard_scene(scene, n_shards, branching)
    t_sc, t_bvh = shard_scene(interop.from_numpy_scene(scene, "cpu"),
                              n_shards, branching)
    for f in dataclasses.fields(j_sc):
        a, b = np.asarray(getattr(j_sc, f.name)), getattr(t_sc, f.name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)
    for f in ("nodes", "prims", "root"):
        np.testing.assert_array_equal(getattr(t_bvh, f).numpy(),
                                      np.asarray(getattr(j_bvh, f)), err_msg=f)
    assert t_bvh.prim_mask == tuple(bool(x) for x in j_bvh.prim_mask)
    assert (t_bvh.max_stack, t_bvh.branching) == (j_bvh.max_stack,
                                                  j_bvh.branching)
    if scene_name == "empty_shards":
        valid = np.concatenate([t_sc.sph_valid.numpy(), t_sc.qd_valid.numpy(),
                                t_sc.tr_valid.numpy()], 1)
        assert valid.any(1).all()                  # every shard holds a prim
        assert (t_sc.qd_medium.numpy()[1:] == -1).all()   # pad rows


# ---------------------------------------------------------------------------
# render_tp, render_pp, render_dp_tp on gloo ranks.
# ---------------------------------------------------------------------------

# (mode, world, seed, node width of the shards' BVHs)
TWO_RANK_JOBS = (("tp", "setup", 5, 4), ("pp", "setup", 13, 4),
                 ("tp", "medium", 17, 4), ("pp", "medium", 17, 4),
                 ("tp", "medium", 17, 8), ("pp", "setup", 13, 8))


@pytest.fixture(scope="module")
def two_ranks():
    worlds = {"setup": _setup_world, "medium": _medium_world}
    jobs = [_job(n, worlds[w](), seed, branching=k)
            for n, w, seed, k in TWO_RANK_JOBS]
    return tr.run_ranks(2, jobs)


def _jax_mode(mode, world, seed, mesh_shape, branching=4):
    scene, flags, _, cam = _compiled(world)
    key = jax.random.key(seed)
    if mode == "dp_tp":
        devs = np.array(jax.devices()[:4]).reshape(mesh_shape)
        mesh = jax.sharding.Mesh(devs, ("d", "t"))
        sc, bv = jss.shard_scene(scene, mesh_shape[1])
        return jss.render_dp_tp(sc, flags, bv, cam, JCfg(**CFG), key, mesh,
                                spp=CFG["samples_per_pixel"])
    axis = "t" if mode == "tp" else "p"
    sc, bv = jss.shard_scene(scene, 2, branching)
    fn = jss.render_tp if mode == "tp" else jpp.render_pp
    return fn(sc, flags, bv, cam, JCfg(**CFG), key,
              jrd.make_mesh(2, axis=axis), spp=CFG["samples_per_pixel"],
              axis=axis)


@pytest.mark.parametrize("job", range(len(TWO_RANK_JOBS)),
                         ids=[f"{n}-{w}" + ("-k8" if k == 8 else "")
                              for n, w, _, k in TWO_RANK_JOBS])
def test_two_rank_modes_match_jax(two_ranks, job):
    mode, world, seed, branching = TWO_RANK_JOBS[job]
    build = _setup_world if world == "setup" else _medium_world
    ref = np.asarray(_jax_mode(mode, build(), seed, None, branching))
    imgs = [two_ranks[r][job]["image"] for r in range(2)]
    assert imgs[0].shape == (CFG["height"], CFG["width"], 3)
    assert np.array_equal(imgs[0], imgs[1])        # every rank holds the frame
    assert float(imgs[0].mean()) > 0
    np.testing.assert_allclose(imgs[0], ref, atol=ATOL)


def test_dp_tp_matches_jax():
    res = tr.run_ranks(4, [_job("dp_tp", _setup_world(), 21, shape=(2, 2))])
    ref = np.asarray(_jax_mode("dp_tp", _setup_world(), 21, (2, 2)))
    for r in range(4):
        np.testing.assert_allclose(res[r][0]["image"], ref, atol=ATOL)


def test_mode_refuses_a_mismatched_mesh():
    """A scene sharded 2 ways on a 1-rank axis raises, as JAX's does."""
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import RenderConfig
    from path_tracer_tpu_torch.parallel import make_mesh, render_pp, render_tp
    scene, _, _, cam = _compiled(_setup_world())
    t_scene = interop.from_numpy_scene(scene, "cpu")
    t_sc, t_bvh = shard_scene(t_scene, 2)
    args = (t_sc, SceneFlags.from_scene(t_scene), t_bvh,
            interop.from_numpy_camera(cam, "cpu"), RenderConfig(**CFG),
            torch.tensor([0, 1]))
    for fn, mesh in ((render_tp, make_mesh(1, "t")),
                     (render_pp, make_mesh(1, "p")),
                     (render_dp_tp, make_mesh((1, 1), ("d", "t")))):
        with pytest.raises(ValueError, match="sharded 2-way"):
            fn(*args, mesh)


def test_vol2_final_has_cross_shard_ties():
    """vol2_final holds one sphere twice (the glass ball and its medium
    boundary): primary rays hit both at exactly equal t, one in each of two
    shards, and the tensor-parallel rule takes the lowest rank's where one
    BVH keeps the first it walks.  This is why the DP x TP frame may differ
    from the one-rank frame in a few pixels."""
    from path_tracer_tpu_torch import scenes
    from path_tracer_tpu_torch.ops import integrator_tiled as itl
    from path_tracer_tpu_torch.ops.bvh_build import build_from_scene
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import RenderConfig
    from path_tracer_tpu_torch.parallel.scene_shard import local_shard
    from path_tracer_tpu_torch.models.compile import compile_scene
    world, cam = scenes.vol2_final_scene(sphere_cluster=1000)
    W, H = 64, 36
    cam.aspect_ratio, cam.img_width = W / H, W
    sc = compile_scene(world, device="cpu")
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=1, max_depth=10)
    eng = itl.TiledEngine(sc, SceneFlags.from_scene(sc), build_from_scene(sc),
                          cam.initialize(device="cpu"), cfg,
                          torch.tensor([0, 0]))
    st = itl.tiled_spawn(eng, 0, torch.arange(W * H, dtype=torch.int32))
    t_min = torch.full((W * H,), cfg.t_min)
    sc_t, bv_t = shard_scene(sc, 2)
    hits = [itl.closest_hit_plain(local_shard(sc_t, bv_t, r)[1], st.origin,
                                  st.direction, st.time, t_min, cfg.t_max,
                                  cfg.stack_depth) for r in range(2)]
    tie = hits[0][0] & hits[1][0] & (hits[0][3] == hits[1][3])
    assert int(tie.sum()) > 0
    assert bool((hits[0][1][tie] == 0).all())          # spheres, both sides
    full = itl.closest_hit_plain(eng.bvh, st.origin, st.direction, st.time,
                                 t_min, cfg.t_max, cfg.stack_depth)
    assert torch.equal(full[3][tie], hits[0][3][tie])   # the same t
