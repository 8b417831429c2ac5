"""Rank processes for the port's multi-rank tests.

    python tests/torch_ranks.py RANK WORLD PORT JOBS OUT

Each rank joins a gloo job of WORLD ranks on ``127.0.0.1:PORT``, runs the
jobs pickled in JOBS (a list of dicts of numpy arrays and plain values) and
pickles its results to ``OUT.<rank>``.  It imports torch, numpy and the port,
nothing of JAX.  :func:`run_ranks` starts the ranks through the port's
``parallel.launch.run_ranks`` (a free port, the ranks polled together,
every rank killed as soon as one fails).
"""
from __future__ import annotations

import os
import pickle
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fields(obj, names=None) -> dict:
    """An object's array fields as numpy arrays (a JAX or port container)."""
    import dataclasses
    names = names or [f.name for f in dataclasses.fields(obj)]
    return {n: np.array(np.asarray(getattr(obj, n))) for n in names}


def run_ranks(world: int, jobs: list, timeout: float = 150.0) -> list:
    """Run ``jobs`` on ``world`` gloo ranks → one list of job results per
    rank (rank order)."""
    from path_tracer_tpu_torch.parallel.launch import run_ranks as launch
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "jobs.pkl")
        out = os.path.join(tmp, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump(jobs, f)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
        launch(world, lambda r, port: [sys.executable, os.path.abspath(
            __file__), str(r), str(world), str(port), inp, out], tmp,
            timeout, env=env, cwd=REPO)
        res = []
        for r in range(world):
            with open(f"{out}.{r}", "rb") as f:
                res.append(pickle.load(f))
        return res


# ---------------------------------------------------------------------------
# The rank side (imports the port only).
# ---------------------------------------------------------------------------

def _inputs(job):
    import torch
    from path_tracer_tpu_torch import interop
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import PackedBVH, RenderConfig

    scene = interop.from_numpy_scene(_Obj(job["scene"]), "cpu")
    b = job["bvh"]
    bvh = PackedBVH(nodes=torch.from_numpy(b["nodes"]),
                    prims=torch.from_numpy(b["prims"]),
                    root=torch.from_numpy(b["root"]),
                    prim_mask=tuple(bool(x) for x in b["prim_mask"]),
                    max_stack=int(b["max_stack"]),
                    branching=int(b["branching"]))
    cam = interop.from_numpy_camera(_Obj(job["cam"]), "cpu")
    key = interop.key_from_data(job["key"], "cpu")
    return (scene, SceneFlags.from_scene(scene), bvh, cam,
            RenderConfig(**job["cfg"]), key)


class _Obj:
    def __init__(self, d):
        self.__dict__.update(d)


def _resume_job(job) -> dict:
    """``render_distributed`` of a catalog scene three ways: to ``spp`` in
    one go; to ``split`` samples with a checkpoint, then resumed from it to
    ``spp`` (batches of one sample); then another seed on that checkpoint,
    which must be refused."""
    from path_tracer_tpu_torch import parallel as par
    from path_tracer_tpu_torch import scenes

    def run(spp, seed=job["seed"], ckpt=None):
        world, cam = scenes.SCENES[job["scene"]]()
        cam.img_width, cam.samples_per_pixel = job["width"], job["spp"]
        return par.render_distributed(
            world, cam, spp=spp, seed=seed, batch=1, checkpoint_path=ckpt,
            checkpoint_every=1 if ckpt else 0, device="cpu")

    ckpt = job["ckpt"]
    out = {"whole": run(job["spp"]), "part": run(job["split"], ckpt=ckpt)}
    out["resumed"] = run(job["spp"], ckpt=ckpt)
    try:
        run(job["spp"], seed=job["seed"] + 1, ckpt=ckpt)
        out["refused"] = ""
    except ValueError as e:
        out["refused"] = str(e)
    return out


def _spp_job(job) -> dict:
    """``render_distributed`` of a catalog scene: ``split`` samples of a
    camera of ``spp`` samples into a checkpoint; a camera of twice ``spp``
    on that checkpoint, which must be refused; then the first camera
    resumed to twice ``spp`` through the ``spp`` argument."""
    from path_tracer_tpu_torch import parallel as par
    from path_tracer_tpu_torch import scenes

    def run(cam_spp, spp):
        world, cam = scenes.SCENES[job["scene"]]()
        cam.img_width, cam.samples_per_pixel = job["width"], cam_spp
        return par.render_distributed(
            world, cam, spp=spp, seed=job["seed"], batch=1,
            checkpoint_path=job["ckpt"], checkpoint_every=1, device="cpu")

    run(job["spp"], job["split"])
    try:
        run(2 * job["spp"], 2 * job["spp"])
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"refused": refused, "resumed": run(job["spp"], 2 * job["spp"])}


def _run_job(job, world: int) -> dict:
    import torch
    from path_tracer_tpu_torch import parallel as par

    if job["name"] == "resume":
        return _resume_job(job)
    if job["name"] == "spp":
        return _spp_job(job)
    scene, flags, bvh, cam, cfg, key = _inputs(job)
    name, spp = job["name"], job.get("spp", 1)
    if name in ("tp", "pp"):
        axis = "t" if name == "tp" else "p"
        mesh = par.make_mesh(world, axis)
        sc_s, bv_s = par.shard_scene(scene, world, job.get("branching", 4))
        fn = par.render_tp if name == "tp" else par.render_pp
        return {"image": fn(sc_s, flags, bv_s, cam, cfg, key, mesh, spp=spp,
                            axis=axis).numpy()}
    if name == "dp_tp":
        mesh = par.make_mesh(tuple(job["shape"]), ("d", "t"))
        sc_s, bv_s = par.shard_scene(scene, job["shape"][1])
        return {"image": par.render_dp_tp(sc_s, flags, bv_s, cam, cfg, key,
                                          mesh, spp=spp).numpy()}
    mesh = par.make_mesh(world)
    if name == "sharded":
        return {"image": par.render_sharded(scene, flags, bvh, cam, cfg, key,
                                            mesh, spp).numpy()}
    if name == "sharded_wavefront":
        img, st = par.render_sharded_wavefront(
            scene, flags, bvh, cam, cfg, key, mesh, spp=spp, with_stats=True,
            **job.get("kw", {}))
        return {"image": img.numpy(),
                "stats": {k: v.numpy() for k, v in st.items()}}
    if name == "calibrate":
        return {"n_waves": par.calibrate_n_waves(scene, flags, bvh, cam, cfg,
                                                 key, spp=spp, mesh=mesh,
                                                 **job.get("kw", {}))}
    if name == "train":
        step = par.make_train_step(flags, cfg, mesh, spp=spp, **job["kw"])
        params = {k: torch.from_numpy(v) for k, v in job["params"].items()}
        p, loss, g, aux = step(params, scene, bvh, cam, key,
                               torch.from_numpy(job["target"]))
        return {"params": {k: v.numpy() for k, v in p.items()},
                "loss": float(loss),
                "grads": {k: v.numpy() for k, v in g.items()}, "aux": aux}
    raise ValueError(f"unknown job {name!r}")


def _main(argv) -> int:
    import torch
    from path_tracer_tpu_torch.parallel import init_distributed

    rank, world, port, inp, out = (int(argv[0]), int(argv[1]), argv[2],
                                   argv[3], argv[4])
    torch.set_num_threads(2)
    init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    with open(inp, "rb") as f:
        jobs = pickle.load(f)
    res = [_run_job(job, world) for job in jobs]
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(_main(sys.argv[1:]))
