"""Orbit-camera controls and progressive restart, without a GUI.

Port of ``path_tracer_tpu/render/orbit.py`` (:31-94), the reference's
``InteractiveViewer`` camera machinery: :class:`OrbitCamera` orbits
``camera.lookat`` in spherical coordinates with the reference's conventions
(azimuth from the -Z axis, ``atan2(x, -z)``; elevation clamped to ±89°;
degrees of rotation per pixel of drag), and :func:`restart` applies a camera
change to a :class:`~.renderer.Renderer`, after which ``render()`` integrates
the new view from sample 0.  The maths is host code in float64, as JAX's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..models.camera import Camera


@dataclass
class OrbitCamera:
    """Spherical-coordinate orbit control around ``camera.lookat``."""

    camera: Camera
    # Degrees of rotation per pixel of drag (interactive_viewer.py:40-43).
    rotation_velocity: tuple = (0.5, 0.3)

    def __post_init__(self):
        offset = np.asarray(self.camera.lookfrom, float) - np.asarray(
            self.camera.lookat, float)
        self.radius = float(np.linalg.norm(offset))
        # Azimuth from the -Z axis in the XZ plane; elevation from the plane.
        self.theta = math.atan2(offset[0], -offset[2])
        self.phi = (math.asin(offset[1] / self.radius)
                    if self.radius > 0 else 0.0)

    def _to_cartesian(self) -> np.ndarray:
        cos_phi = math.cos(self.phi)
        return self.radius * np.array([
            cos_phi * math.sin(self.theta),
            math.sin(self.phi),
            -cos_phi * math.cos(self.theta)])

    def _place(self) -> Camera:
        self.camera.lookfrom = (np.asarray(self.camera.lookat, float)
                                + self._to_cartesian())
        return self.camera

    def rotate(self, delta_x: float, delta_y: float) -> Camera:
        """Orbit by a (right, down) drag in pixels; returns the camera.
        Pixel deltas scale by ``rotation_velocity`` degrees a pixel, and the
        elevation clamps to ±89°."""
        self.theta += math.radians(delta_x * self.rotation_velocity[0])
        self.phi += math.radians(delta_y * self.rotation_velocity[1])
        max_phi = math.radians(89.0)
        self.phi = max(-max_phi, min(max_phi, self.phi))
        return self._place()

    def zoom(self, factor: float) -> Camera:
        """Scale the orbit radius (the scroll wheel); ``factor`` < 1 moves
        closer."""
        self.radius = max(1e-6, self.radius * float(factor))
        return self._place()


def restart(renderer, camera: Camera | None = None) -> None:
    """Apply a camera change to ``renderer`` and reset its accumulation
    (interactive_viewer.py:131-149): the camera arrays are derived again on
    ``renderer.device`` and ``accum`` is zeroed there; the compiled scene
    and the BVH stay.  The next ``render(spp=...)`` starts at sample 0."""
    if camera is not None:
        renderer.camera = camera
    renderer.cam_arrays = renderer.camera.initialize(device=renderer.device)
    renderer.accum = torch.zeros((renderer.cfg.height, renderer.cfg.width, 3),
                                 dtype=torch.float32, device=renderer.device)
    renderer.samples_done = 0
