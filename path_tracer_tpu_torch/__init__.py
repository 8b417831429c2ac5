"""path_tracer_tpu_torch — the PyTorch/CUDA port of ``path_tracer_tpu``.

A second package beside the JAX one, with the same module layout and names.
It imports ``torch`` and never ``jax``; the hot loops of the wavefront
engine run as hand-written CUDA kernels (``csrc/``) on an NVIDIA H100, and
as plain-torch twins on the CPU.  Entry points default to ``device="cuda"``;
pass ``device="cpu"`` to run the twins.  Gradients with respect to scene
leaves come from ``integrator.render(differentiable=True)``,
``wavefront.render_batch_diff``, ``integrator_tiled.render_tiled`` and
``parallel.make_train_step``.  :mod:`.parallel` renders and trains over the
ranks of a ``torch.distributed`` job: data, tensor (scene sharded by
primitive) and pipeline parallel.

Quick start::

    import path_tracer_tpu_torch as ptt
    world, cam = ptt.scenes.cornell_box()
    r = ptt.Renderer(world, cam, engine="wavefront")
    img = r.render(spp=4)
"""

from .models.camera import Camera
from .models.compile import compile_scene
from .models.geometry import (ConstantMedium, Hittable, HittableList,
                              KleinBottle, Mesh, Quad, Sphere, Triangle, box)
from .models.materials import (Dielectric, DiffuseLight, Isotropic, Lambertian,
                               Material, Metal, SubsurfaceSimple,
                               SubsurfaceVolumetric)
from .models.textures import (CheckerTexture, ImageTexture, NoiseTexture,
                              SolidColor, Texture)
from .ops.bvh_build import build_from_scene
from .ops.integrator import trace_ray_scan
from .ops.integrator_tiled import render_tiled
from .ops.wavefront import render_batch_diff
from .parallel import (calibrate_n_waves, make_mesh, make_train_step,
                       render_pp, render_sharded, render_sharded_wavefront,
                       render_tp, shard_scene)
from .ops.types import CameraArrays, FlatBVH, RenderConfig, SceneArrays
from .render.factory import RendererFactory
from .render.renderer import Renderer, render_scene
from . import scenes

__all__ = [
    "Camera", "CameraArrays", "CheckerTexture", "ConstantMedium", "Dielectric",
    "DiffuseLight", "FlatBVH", "Hittable", "HittableList", "ImageTexture",
    "Isotropic", "KleinBottle", "Lambertian", "Material", "Mesh", "Metal",
    "NoiseTexture", "Quad", "RenderConfig", "Renderer", "RendererFactory",
    "SceneArrays", "SolidColor", "Sphere", "SubsurfaceSimple",
    "SubsurfaceVolumetric", "Texture", "Triangle", "box", "build_from_scene",
    "calibrate_n_waves", "compile_scene", "make_mesh", "make_train_step",
    "render_batch_diff", "render_pp", "render_scene", "render_sharded",
    "render_sharded_wavefront", "render_tiled", "render_tp", "shard_scene",
    "trace_ray_scan",
]

__version__ = "0.1.0"
