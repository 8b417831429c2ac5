"""RendererFactory: the reference-compatible construction seam.

Port of ``path_tracer_tpu/render/factory.py``: 'taichi' and 'gpu' map to
the wavefront engine; 'cpu' and 'megakernel' map to the megakernel engine.
"""
from __future__ import annotations

from .renderer import Renderer

_ALIASES = {
    "taichi": "wavefront",
    "gpu": "wavefront",
    "cpu": "megakernel",
    "wavefront": "wavefront",
    "megakernel": "megakernel",
}


class RendererFactory:
    """Reference-style factory (renderer_factory.py:13-44)."""

    @staticmethod
    def create(renderer_type: str, world, camera, img_path: str | None = None,
               **kwargs) -> Renderer:
        engine = _ALIASES.get(renderer_type)
        if engine is None:
            raise ValueError(
                f"unknown renderer type {renderer_type!r}; expected one of "
                f"{sorted(_ALIASES)}")
        r = Renderer(world, camera, engine=engine, **kwargs)
        if img_path is not None:
            r.default_image_path = img_path
        return r

    @staticmethod
    def available_renderers():
        return sorted(_ALIASES)
