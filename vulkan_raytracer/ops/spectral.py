"""Wavelength -> linear-sRGB conversion for spectral dispersion.

Port of shaders/spectral.glsl: Gaussian fits of the CIE-1931 colour-matching
functions (xFit/yFit/zFit, :48-68) composed with the XYZ->linear-sRGB matrix
(:70-71).  Used when a path's wavelength collapses on its first dispersive
hit (shaders/bsdf.glsl:330-334).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _gauss(wave, mu, s_lo, s_hi):
    t = (wave - mu) * jnp.where(wave < mu, s_lo, s_hi)
    return jnp.exp(-0.5 * t * t)


def x_fit_1931(wave):
    return (
        0.362 * _gauss(wave, 442.0, 0.0624, 0.0374)
        + 1.056 * _gauss(wave, 599.8, 0.0264, 0.0323)
        - 0.065 * _gauss(wave, 501.1, 0.0490, 0.0382)
    )


def y_fit_1931(wave):
    return 0.821 * _gauss(wave, 568.8, 0.0213, 0.0247) + 0.286 * _gauss(
        wave, 530.9, 0.0613, 0.0322
    )


def z_fit_1931(wave):
    return 1.217 * _gauss(wave, 437.0, 0.0845, 0.0278) + 0.681 * _gauss(
        wave, 459.0, 0.0385, 0.0725
    )


# Column-major mat3 in the reference (shaders/spectral.glsl:70) -> rows here.
_XYZ_TO_RGB = jnp.array(
    [
        [2.364613, -0.896541, -0.468073],
        [-0.5151166, 1.426408, 0.088758],
        [0.005203, -0.014408, 1.009204],
    ],
    dtype=jnp.float32,
)


def spectral_colour_1931(wavelength):
    """RGB for a wavelength in nm; shape (...,) -> (..., 3)."""
    xyz = jnp.stack(
        [x_fit_1931(wavelength), y_fit_1931(wavelength), z_fit_1931(wavelength)],
        axis=-1,
    )
    # full f32: a default-precision GPU matmul may round operands to TF32
    return jnp.matmul(xyz, _XYZ_TO_RGB.T, precision=jax.lax.Precision.HIGHEST)
