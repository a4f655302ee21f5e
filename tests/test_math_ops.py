"""Unit tests for ONB, GLSL intrinsics, tonemapping, and spectral fits."""

import numpy as np
import jax.numpy as jnp

from vulkan_raytracer.ops import math3, spectral, tonemap


def rand_unit(n, seed=0):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_branchless_onb_orthonormal():
    n = jnp.asarray(rand_unit(512))
    t, b = math3.branchless_onb(n)
    np.testing.assert_allclose(np.asarray(math3.dot3(t, b)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(math3.dot3(t, n)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(math3.dot3(b, n)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(math3.length3(t)), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(math3.length3(b)), 1.0, atol=1e-5)
    # right-handed-consistent: cross(t, b) == +-n with the Duff sign rule
    c = np.asarray(math3.cross3(t, b))
    dots = np.sum(c * np.asarray(n), axis=-1)
    np.testing.assert_allclose(np.abs(dots), 1.0, atol=1e-5)


def test_onb_matches_duff_formula():
    # spot-check exact formula at n = +z and -z (the branch sign flip)
    t, b = math3.branchless_onb(jnp.asarray([[0.0, 0.0, 1.0]]))
    np.testing.assert_allclose(np.asarray(t)[0], [1, 0, 0], atol=1e-7)
    np.testing.assert_allclose(np.asarray(b)[0], [0, 1, 0], atol=1e-7)
    t, b = math3.branchless_onb(jnp.asarray([[0.0, 0.0, -1.0]]))
    np.testing.assert_allclose(np.asarray(t)[0], [1, 0, 0], atol=1e-7)
    np.testing.assert_allclose(np.asarray(b)[0], [0, -1, 0], atol=1e-7)


def test_reflect_refract_match_glsl():
    n = jnp.asarray([[0.0, 0.0, 1.0]])
    i = math3.normalize3(jnp.asarray([[1.0, 0.0, -1.0]]))
    r = np.asarray(math3.reflect(i, n))[0]
    np.testing.assert_allclose(r, np.asarray(math3.normalize3(jnp.asarray([[1.0, 0.0, 1.0]])))[0], atol=1e-6)
    # refraction into denser medium bends toward normal
    tr = np.asarray(math3.refract(i, n, 1.0 / 1.5))[0]
    assert tr[2] < 0
    # Snell: sin_out = sin_in / 1.5
    sin_in = abs(i[0, 0])
    sin_out = abs(tr[0]) / np.linalg.norm(tr)
    np.testing.assert_allclose(sin_out, sin_in / 1.5, rtol=1e-5)
    # total internal reflection -> zero vector
    graze = math3.normalize3(jnp.asarray([[0.99, 0.0, -np.sqrt(1 - 0.99**2)]]))
    tir = np.asarray(math3.refract(graze, n, 1.5))
    np.testing.assert_array_equal(tir, 0.0)


def test_tangent_roundtrip():
    n = jnp.asarray(rand_unit(64, 1))
    t, b = math3.branchless_onb(n)
    v = jnp.asarray(rand_unit(64, 2))
    tv = math3.to_tangent(v, t, b, n)
    back = math3.from_tangent(tv, t, b, n)
    np.testing.assert_allclose(np.asarray(back), np.asarray(v), atol=1e-5)


def test_reinhard_jodie():
    v = jnp.asarray([[1.0, 1.0, 1.0]])
    out = np.asarray(tonemap.reinhard_jodie(v))[0]
    # grey input: luminance==1, reinhard==0.5 -> mix(1/2, 0.5, 0.5) == 0.5
    np.testing.assert_allclose(out, 0.5, atol=1e-6)
    # non-negative and finite on random HDR values (NOTE: Reinhard-Jodie is
    # not bounded by 1 for saturated colours — matches the reference curve)
    x = jnp.asarray(np.random.default_rng(3).uniform(0, 50, (1000, 3)).astype(np.float32))
    y = np.asarray(tonemap.reinhard_jodie(x))
    assert (y >= 0).all() and np.isfinite(y).all() and (y <= 1.5).all()


def test_luminance_weights():
    np.testing.assert_allclose(
        float(tonemap.luminance(jnp.asarray([1.0, 1.0, 1.0]))), 1.0, atol=1e-6
    )


def test_spectral_fit_values():
    # peak of yFit at 568.8nm is 0.821 + 0.286*exp(-...)
    y = float(spectral.y_fit_1931(jnp.asarray(568.8)))
    assert abs(y - (0.821 + 0.286 * np.exp(-0.5 * ((568.8 - 530.9) * 0.0322) ** 2))) < 1e-5
    # white-ish: integrating the fit over 400-700 should give positive RGB
    waves = jnp.linspace(400.0, 700.0, 301)
    rgb = np.asarray(spectral.spectral_colour_1931(waves)).mean(axis=0)
    assert (rgb > 0).all()
    # red end of the spectrum maps to red-dominant RGB
    red = np.asarray(spectral.spectral_colour_1931(jnp.asarray(650.0)))
    assert red[0] > red[1] and red[0] > red[2]
    blue = np.asarray(spectral.spectral_colour_1931(jnp.asarray(450.0)))
    assert blue[2] > blue[0] and blue[2] > blue[1]
