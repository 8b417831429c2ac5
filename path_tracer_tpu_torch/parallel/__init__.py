"""Rendering and training across devices (port of ``path_tracer_tpu/parallel``).

:mod:`.render_dist` holds the single-device train step and
``calibrate_n_waves``; the data-parallel, tensor-parallel and pipeline
modes are later slices (ROADMAP.md A.11, B14).
"""
from .render_dist import calibrate_n_waves, make_train_step

__all__ = ["calibrate_n_waves", "make_train_step"]
