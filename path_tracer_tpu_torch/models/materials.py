"""Host-side material descriptions (user-facing scene API).

Covers the full hierarchy of ``reference core/material.py:9-277``:
Lambertian, Metal, Dielectric, DiffuseLight, Isotropic, SubsurfaceSimple,
SubsurfaceVolumetric.  Unlike the reference, the two subsurface materials are
first-class on-device citizens (the reference silently degrades them to gray
Lambertian on GPU, scene_compiler.py:406-417).
"""
from __future__ import annotations

from dataclasses import dataclass

from .textures import Texture, as_texture


@dataclass
class Material:
    pass


@dataclass
class Lambertian(Material):
    """Cosine-weighted diffuse (material.py:18-45)."""

    tex: Texture

    def __init__(self, albedo_or_tex):
        self.tex = as_texture(albedo_or_tex)

    @classmethod
    def from_color(cls, albedo) -> "Lambertian":
        return cls(albedo)

    @classmethod
    def from_texture(cls, tex: Texture) -> "Lambertian":
        return cls(tex)


@dataclass
class Metal(Material):
    """Mirror + fuzz (material.py:47-60); fuzz clamped to 1."""

    albedo: object
    fuzz: float

    def __init__(self, albedo, fuzz: float = 0.0):
        self.albedo = as_texture(albedo)
        self.fuzz = min(float(fuzz), 1.0)


@dataclass
class Dielectric(Material):
    """Glass with Schlick reflectance (material.py:62-93)."""

    ir: float


@dataclass
class DiffuseLight(Material):
    """Emissive, no scatter (material.py:97-115)."""

    tex: Texture

    def __init__(self, emit_or_tex):
        self.tex = as_texture(emit_or_tex)

    @classmethod
    def from_color(cls, emit) -> "DiffuseLight":
        return cls(emit)


@dataclass
class Isotropic(Material):
    """Uniform-sphere phase function (material.py:118-141)."""

    tex: Texture

    def __init__(self, albedo_or_tex):
        self.tex = as_texture(albedo_or_tex)


@dataclass
class SubsurfaceSimple(Material):
    """50% displaced-exit diffuse approximation (material.py:145-174)."""

    albedo: object
    scatter_distance: float

    def __init__(self, albedo, scatter_distance: float):
        self.albedo = as_texture(albedo)
        self.scatter_distance = float(scatter_distance)


@dataclass
class SubsurfaceVolumetric(Material):
    """Random-walk SSS with Henyey–Greenstein phase (material.py:176-276)."""

    albedo: object
    sigma_s: float
    sigma_a: float
    g: float

    def __init__(self, albedo, scatter_coeff: float, absorb_coeff: float, g: float = 0.0):
        self.albedo = as_texture(albedo)
        self.sigma_s = float(scatter_coeff)
        self.sigma_a = float(absorb_coeff)
        self.g = float(g)
