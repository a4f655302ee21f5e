"""Bit-exactness tests for the TEA/LCG PRNG against pure-Python oracles.

Oracle implementations follow shaders/random.glsl with Python ints masked
to 32 bits, independently of the JAX code under test.
"""

import numpy as np
import jax.numpy as jnp

from vulkan_raytracer.ops import rng

M32 = 0xFFFFFFFF


def tea_oracle(v0, v1):
    s = 0
    for _ in range(16):
        s = (s + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) & M32) + 0xA341316C) ^ ((v1 + s) & M32) ^ ((v1 >> 5) + 0xC8013EA4))) & M32
        v1 = (v1 + ((((v0 << 4) & M32) + 0xAD90777D) ^ ((v0 + s) & M32) ^ ((v0 >> 5) + 0x7E95761E))) & M32
    return v0


def lcg_oracle(seed):
    seed = (1664525 * seed + 1013904223) & M32
    return seed & 0x00FFFFFF, seed


def rnd_oracle(seed):
    bits, seed = lcg_oracle(seed)
    return np.float32(bits) / np.float32(1 << 24), seed


def test_tea_bit_exact():
    pix = np.array([0, 1, 12345, 800 * 600 - 1, 0xDEADBEEF], np.uint32)
    smp = np.array([0, 1, 2, 63, 1024], np.uint32)
    got = np.asarray(rng.tea(jnp.asarray(pix), jnp.asarray(smp)))
    want = np.array([tea_oracle(int(a), int(b)) for a, b in zip(pix, smp)], np.uint32)
    np.testing.assert_array_equal(got, want)


def test_lcg_stream_bit_exact():
    seed = int(tea_oracle(7, 3))
    s = jnp.asarray(np.array([seed], np.uint32))
    py = seed
    for _ in range(100):
        u, s = rng.rnd(s)
        want, py = rnd_oracle(py)
        assert float(u[0]) == float(want)
    assert int(np.asarray(s)[0]) == py


def test_rnd_int_range():
    s = rng.tea(jnp.arange(4096, dtype=jnp.uint32), jnp.uint32(5))
    v, s2 = rng.rnd_int(s, 0, 6)
    v = np.asarray(v)
    assert v.min() >= 0 and v.max() <= 6
    # every bucket hit
    assert len(np.unique(v)) == 7
    # matches oracle construction
    bits = np.asarray(rng.lcg(s)[0])
    np.testing.assert_array_equal(v, (bits % 7).astype(np.int32))


def test_rnd_in_unit_interval_and_uniform():
    s = rng.tea(jnp.arange(1 << 14, dtype=jnp.uint32), jnp.uint32(0))
    u, _ = rng.rnd(s)
    u = np.asarray(u)
    assert (u >= 0).all() and (u < 1).all()
    assert abs(u.mean() - 0.5) < 0.01
    assert abs(np.var(u) - 1 / 12) < 0.005


def test_hemisphere_samplers_match_reference_formulas():
    s0 = rng.tea(jnp.arange(8, dtype=jnp.uint32), jnp.uint32(1))
    (x, y, z), s1 = rng.sample_uniform_hemisphere(s0)
    # reproduce by hand from the same seeds
    ux, t = rng.rnd(s0)
    uy, t = rng.rnd(t)
    r = np.sqrt(1 - np.asarray(ux) ** 2)
    np.testing.assert_allclose(np.asarray(x), r * np.cos(2 * np.pi * np.asarray(uy)), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(z), np.asarray(ux), rtol=1e-6)
    assert (np.asarray(z) >= 0).all()
    # unit length for the uniform sampler
    np.testing.assert_allclose(
        np.asarray(x) ** 2 + np.asarray(y) ** 2 + np.asarray(z) ** 2, 1.0, atol=1e-5
    )


def test_cosine_sampler_replicates_nonunit_quirk():
    # The reference returns non-unit vectors (shaders/random.glsl:87-94);
    # verify we reproduce p.z = 1 - r^2 with r = u.x and (sin, cos) order.
    s0 = rng.tea(jnp.arange(16, dtype=jnp.uint32), jnp.uint32(9))
    (x, y, z), _ = rng.sample_cosine_hemisphere(s0)
    ux, t = rng.rnd(s0)
    uy, _ = rng.rnd(t)
    ux, uy = np.asarray(ux), np.asarray(uy)
    np.testing.assert_allclose(np.asarray(x), ux * np.sin(2 * np.pi * uy), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(y), ux * np.cos(2 * np.pi * uy), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(z), 1 - ux**2, rtol=1e-5)
