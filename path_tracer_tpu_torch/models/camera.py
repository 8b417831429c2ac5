"""Host-side camera (user-facing API) → device CameraArrays.

Port of ``path_tracer_tpu/models/camera.py`` (reference core/camera.py:19-72):
lookfrom/lookat/vup, vfov, aspect ratio and defocus-disk depth of field.
:meth:`Camera.initialize` returns torch :class:`CameraArrays` on ``device``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..ops.types import BG_GRADIENT, BG_SOLID, CameraArrays


def _v3(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64).reshape(3)


@dataclass
class Camera:
    aspect_ratio: float = 1.0
    img_width: int = 100
    samples_per_pixel: int = 10
    max_depth: int = 16
    vfov: float = 90.0
    lookfrom: np.ndarray = field(default_factory=lambda: np.zeros(3))
    lookat: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, -1.0]))
    vup: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    defocus_angle: float = 0.0
    focus_distance: float = 10.0
    # None → vol-1 gradient sky; a color → solid background (camera.py:90
    # `self.background` / fields.bg_color).
    background: np.ndarray | None = None

    @property
    def img_height(self) -> int:
        return max(1, int(self.img_width / self.aspect_ratio))

    def initialize(self, device="cuda") -> CameraArrays:
        """Compute the viewport basis (camera.py:34-72)."""
        w_px, h_px = self.img_width, self.img_height
        center = _v3(self.lookfrom)

        theta = math.radians(self.vfov)
        h = math.tan(theta / 2.0)
        viewport_h = 2.0 * h * self.focus_distance
        viewport_w = viewport_h * (w_px / h_px)

        def normalize(v):
            return v / np.linalg.norm(v)

        w = normalize(_v3(self.lookfrom) - _v3(self.lookat))
        u = normalize(np.cross(_v3(self.vup), w))
        v = np.cross(w, u)

        viewport_u = viewport_w * u
        viewport_v = viewport_h * -v
        du = viewport_u / w_px
        dv = viewport_v / h_px
        upper_left = center - self.focus_distance * w - viewport_u / 2 - viewport_v / 2
        pixel00 = upper_left + 0.5 * (du + dv)

        defocus_radius = self.focus_distance * math.tan(math.radians(self.defocus_angle) / 2.0)

        import torch

        bg_solid = self.background is not None
        bg = _v3(self.background) if bg_solid else np.zeros(3)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
        return CameraArrays(
            origin=f32(center),
            pixel00=f32(pixel00),
            du=f32(du),
            dv=f32(dv),
            defocus_u=f32(defocus_radius * u),
            defocus_v=f32(defocus_radius * v),
            defocus_angle=f32(self.defocus_angle),
            bg_color=f32(bg),
            bg_type=torch.tensor(BG_SOLID if bg_solid else BG_GRADIENT, dtype=torch.int32,
                                 device=device),
        )
