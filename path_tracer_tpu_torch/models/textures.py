"""Host-side texture descriptions (user-facing scene API).

Mirrors the capability surface of ``reference core/texture.py:10-90``
but as plain data records: nothing here evaluates colors — evaluation happens
on device in :mod:`path_tracer_tpu_torch.ops.shade` from the compiled texture table.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _c3(c) -> np.ndarray:
    a = np.asarray(c, dtype=np.float32).reshape(-1)
    if a.size == 1:
        a = np.repeat(a, 3)
    return a[:3]


@dataclass
class Texture:
    pass


@dataclass
class SolidColor(Texture):
    """texture.py:17-32."""

    albedo: np.ndarray

    def __init__(self, albedo):
        self.albedo = _c3(albedo)

    @classmethod
    def from_rgb(cls, r: float, g: float, b: float) -> "SolidColor":
        return cls((r, g, b))


@dataclass
class CheckerTexture(Texture):
    """3-D integer-lattice checker (texture.py:36-57).

    The reference's GPU path only supports two solid colors; same here.
    """

    scale: float
    even: np.ndarray
    odd: np.ndarray

    def __init__(self, scale, even, odd):
        self.scale = float(scale)
        self.even = _c3(getattr(even, "albedo", even))
        self.odd = _c3(getattr(odd, "albedo", odd))


@dataclass
class ImageTexture(Texture):
    """Image-backed texture (texture.py:61-80).

    Loads eagerly on host (rtw_image search-path semantics in
    utils/image.load_image); missing files fall back to solid magenta like
    rtw_image.py:120-127.
    """

    filename: str
    data: np.ndarray = field(repr=False, default=None)

    def __init__(self, filename: str):
        from ..utils.image import load_image

        self.filename = filename
        self.data = load_image(filename)

    @property
    def loaded(self) -> bool:
        return self.data is not None

    @classmethod
    def from_array(cls, data, name: str = "<array>") -> "ImageTexture":
        """Texture from an in-memory (H, W, 3) float array in [0, 1].

        The inverse-rendering path uses this: the compiled ``img_data``
        atlas leaf is a trainable parameter (texture.py:61-80's type, now
        differentiable — the reference cannot express this)."""
        self = cls.__new__(cls)
        self.filename = name
        self.data = np.asarray(data, dtype=np.float32)
        return self


@dataclass
class NoiseTexture(Texture):
    """Perlin marble texture (texture.py:84-90)."""

    scale: float = 1.0


def as_texture(obj) -> Texture:
    """Coerce colors / tuples to a SolidColor."""
    if isinstance(obj, Texture):
        return obj
    return SolidColor(obj)
