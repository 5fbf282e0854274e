"""Procedural HDR skies for RENI++ prior training (the port's own copy of
``neusky_tpu/data/sky_generator.py``; host numpy, so a corpus equals the
JAX package's bit for bit).

The Preetham analytic daylight model (Perez sky luminance distribution and
a turbidity-parameterised Yxy zenith colour) plus a sun disc, rendered on
the equirectangular sampler's direction grid (z up, as
``sampling/illumination.py::EquirectangularSampler``).  The formulas are
the published Preetham/Perez ones (A Practical Analytic Model for
Daylight, SIGGRAPH '99).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# Perez coefficient rows [multiplier of T, constant] for Y, x, y
_PEREZ_Y = np.array([
    [0.1787, -1.4630],
    [-0.3554, 0.4275],
    [-0.0227, 5.3251],
    [0.1206, -2.5771],
    [-0.0670, 0.3703],
])
_PEREZ_x = np.array([
    [-0.0193, -0.2592],
    [-0.0665, 0.0008],
    [-0.0004, 0.2125],
    [-0.0641, -0.8989],
    [-0.0033, 0.0452],
])
_PEREZ_y = np.array([
    [-0.0167, -0.2608],
    [-0.0950, 0.0092],
    [-0.0079, 0.2102],
    [-0.0441, -1.6537],
    [-0.0109, 0.0529],
])

# zenith chromaticity: rows multiply [T^2, T, 1], columns [th^3, th^2, th, 1]
_ZENITH_x = np.array([
    [0.00166, -0.00375, 0.00209, 0.0],
    [-0.02903, 0.06377, -0.03202, 0.00394],
    [0.11693, -0.21196, 0.06052, 0.25886],
])
_ZENITH_y = np.array([
    [0.00275, -0.00610, 0.00317, 0.0],
    [-0.04214, 0.08970, -0.04153, 0.00516],
    [0.15346, -0.26756, 0.06670, 0.26688],
])

# CIE XYZ (D65) → linear sRGB
_XYZ_TO_RGB = np.array([
    [3.2406, -1.5372, -0.4986],
    [-0.9689, 1.8758, 0.0415],
    [0.0557, -0.2040, 1.0570],
])


def _perez(theta: np.ndarray, gamma: np.ndarray, c) -> np.ndarray:
    """Perez sky distribution F(theta, gamma) with coefficients c=[A..E]."""
    a, b, cc, d, e = c
    cos_t = np.clip(np.cos(theta), 1e-2, None)  # guard horizon singularity
    return (1.0 + a * np.exp(b / cos_t)) * (
        1.0 + cc * np.exp(d * gamma) + e * np.cos(gamma) ** 2
    )


def _zenith_chroma(m: np.ndarray, turbidity: float, theta_s: float) -> float:
    tv = np.array([turbidity**2, turbidity, 1.0])
    sv = np.array([theta_s**3, theta_s**2, theta_s, 1.0])
    return float(tv @ m @ sv)


@dataclasses.dataclass(frozen=True)
class SkyParams:
    """One sky's generation parameters (sampled by ``random_sky_params``)."""

    sun_azimuth: float  # radians
    sun_elevation: float  # radians above horizon
    turbidity: float  # 2 (clear) … 10 (hazy)
    exposure: float  # global linear scale (sky-to-sky brightness variation)
    sun_intensity: float  # sun-disc radiance as a multiple of zenith luminance
    sun_angular_radius: float  # radians (physical ≈ 0.00465; widened for low res)
    ground_albedo: float  # constant lambertian-ish ground colour scale


def random_sky_params(rng: np.random.Generator) -> SkyParams:
    return SkyParams(
        sun_azimuth=float(rng.uniform(0.0, 2.0 * np.pi)),
        sun_elevation=float(rng.uniform(np.radians(2.0), np.radians(65.0))),
        turbidity=float(rng.uniform(2.0, 9.0)),
        exposure=float(np.exp(rng.uniform(np.log(0.5), np.log(2.0)))),
        sun_intensity=float(np.exp(rng.uniform(np.log(50.0), np.log(500.0)))),
        sun_angular_radius=float(rng.uniform(np.radians(0.5), np.radians(2.0))),
        ground_albedo=float(rng.uniform(0.1, 0.4)),
    )


def sky_radiance(directions: np.ndarray, p: SkyParams) -> np.ndarray:
    """Linear-HDR RGB radiance for unit ``directions`` [N, 3] (z-up).

    Preetham sky above the horizon, sun disc with smooth limb, constant
    albedo-scaled ground below the horizon."""
    d = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    theta_s = np.pi / 2.0 - p.sun_elevation  # sun zenith angle
    sun = np.array([
        np.cos(p.sun_azimuth) * np.sin(theta_s),
        np.sin(p.sun_azimuth) * np.sin(theta_s),
        np.cos(theta_s),
    ])

    cos_theta = np.clip(d[:, 2], -1.0, 1.0)
    theta = np.arccos(np.clip(cos_theta, 0.0, 1.0))  # view zenith (sky side)
    cos_gamma = np.clip(d @ sun, -1.0, 1.0)
    gamma = np.arccos(cos_gamma)

    t = p.turbidity
    tc = np.array([t, 1.0])
    coef_Y = _PEREZ_Y @ tc
    coef_x = _PEREZ_x @ tc
    coef_y = _PEREZ_y @ tc

    chi = (4.0 / 9.0 - t / 120.0) * (np.pi - 2.0 * theta_s)
    Y_z = (4.0453 * t - 4.9710) * np.tan(chi) - 0.2155 * t + 2.4192  # Kcd/m^2
    Y_z = max(Y_z, 1e-3)
    x_z = _zenith_chroma(_ZENITH_x, t, theta_s)
    y_z = _zenith_chroma(_ZENITH_y, t, theta_s)

    def ratio(c, g, th):
        return _perez(th, g, c) / _perez(np.zeros_like(th), np.full_like(th, theta_s), c)

    Y = Y_z * ratio(coef_Y, gamma, theta)
    x = x_z * ratio(coef_x, gamma, theta)
    y = y_z * ratio(coef_y, gamma, theta)
    y = np.clip(y, 1e-3, None)

    X = Y / y * x
    Z = Y / y * (1.0 - x - y)
    rgb = np.stack([X, Y, Z], axis=-1) @ _XYZ_TO_RGB.T
    rgb = np.clip(rgb, 0.0, None)

    # sun disc: smooth limb over [r, 1.5 r]
    limb = np.clip(
        (1.5 * p.sun_angular_radius - gamma) / (0.5 * p.sun_angular_radius),
        0.0, 1.0,
    )
    sun_rgb = np.array([1.0, 0.96, 0.9]) * (p.sun_intensity * Y_z)
    rgb = rgb + limb[:, None] * sun_rgb[None, :]

    # ground: constant albedo times mean horizon radiance, fading with -z
    horizon = cos_theta < 0.0
    if horizon.any():
        band = (cos_theta >= 0.0) & (cos_theta < 0.1)
        base = rgb[band].mean(axis=0) if band.any() else rgb.mean(axis=0)
        fade = 1.0 + cos_theta[horizon, None]  # 1 at horizon → 0 at nadir
        rgb[horizon] = p.ground_albedo * base[None, :] * np.clip(fade, 0.05, None)

    return (rgb * p.exposure).astype(np.float32)


def generate_sky_corpus(
    num: int,
    width: int = 128,
    seed: int = 0,
    params: Optional[Tuple[SkyParams, ...]] = None,
) -> np.ndarray:
    """[num, H, W, 3] linear-HDR equirect skies on the sampler's grid
    (H = width // 2), from ``np.random.default_rng(seed)`` or the given
    ``params``.  The directions are computed in numpy with the
    ``EquirectangularSampler`` formula, so generation is host work alone."""
    h = width // 2
    phi = (np.arange(h) + 0.5) / h * np.pi
    theta = (np.arange(width) + 0.5) / width * 2.0 * np.pi - np.pi
    phi_g, theta_g = np.meshgrid(phi, theta, indexing="ij")
    dirs = np.stack(
        [
            np.sin(phi_g) * np.cos(theta_g),
            np.sin(phi_g) * np.sin(theta_g),
            np.cos(phi_g),
        ],
        axis=-1,
    ).reshape(-1, 3).astype(np.float32)
    rng = np.random.default_rng(seed)
    out = np.empty((num, h, width, 3), np.float32)
    for i in range(num):
        p = params[i] if params is not None else random_sky_params(rng)
        out[i] = sky_radiance(dirs, p).reshape(h, width, 3)
    # cap at the decoder's representable HDR domain (exp(log_domain_max)=e^8)
    return np.minimum(out, 2900.0)
