"""Rendering and training across ranks (port of ``path_tracer_tpu/parallel``).

* :mod:`.render_dist` — the mesh of ``torch.distributed`` ranks, data
  parallelism (pixel blocks, scene replicated), the train step with its
  all-reduce, and ``calibrate_n_waves``.
* :mod:`.scene_shard` — tensor parallelism (scene sharded by primitive, rays
  replicated) and its composition with data parallelism.
* :mod:`.pipeline` — pipeline parallelism (scene-shard stages on a ring).
* :mod:`.launch` — one process per rank of a job on this host.
"""
from .pipeline import render_pp
from .render_dist import (calibrate_n_waves, global_mesh, init_distributed,
                          make_mesh, make_train_step, render_distributed,
                          render_sharded, render_sharded_wavefront)
from .scene_shard import render_dp_tp, render_tp, shard_scene

__all__ = ["calibrate_n_waves", "global_mesh", "init_distributed",
           "make_mesh", "make_train_step", "render_distributed",
           "render_dp_tp", "render_pp",
           "render_sharded", "render_sharded_wavefront", "render_tp",
           "shard_scene"]
