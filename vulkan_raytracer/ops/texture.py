"""Bilinear texture sampling — replaces the Vulkan sampler objects.

The reference binds glTF textures as a bindless array of linear-filtered,
repeat-addressed UNORM samplers (texture.cpp:5-40, shaders/texture.glsl:1-4)
and the HDR skybox as an equirectangular sampler (shaders/skybox.rmiss:17-29).

Storage is a single flat buffer of RGBA8-packed uint32 texels with
per-texture offsets — the answer to the reference's bindless
variable-count descriptor array (raytracer.cpp:219-238):

* **zero padding waste** — the round-2 padded stack ``(NT, maxH, maxW, 4)``
  float32 allocated 16 bytes per *padded* texel (a real mixed-size asset
  set would spend gigabytes on padding); the flat buffer allocates exactly
  4 bytes per payload texel, the same bytes-per-texel the reference's
  R8G8B8A8Unorm images use (image.cpp:21-58);
* **1-D gathers only** — a fetch is four ``take`` gathers from a flat
  (S,) column (multi-dim gathers measured 336x slower, docs/DESIGN.md §3);
* **UNORM parity** — texels quantise to 8 bits at upload, exactly the
  precision the reference's stb-loaded images carry.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .gatherpack import packed_gather
from .math3 import PIINV, TWOPIINV


def _wrap(i, n):
    """Repeat addressing: floor-mod into [0, n)."""
    return jnp.mod(i, n)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    """All scene textures in one flat RGBA8-packed buffer.

    ``texels[off[i] + y * w[i] + x]`` is texture i's texel (y, x), packed
    ``r | g<<8 | b<<16 | a<<24``.  Columns are flat so every per-lane fetch
    lowers to a cheap 1-D gather.
    """

    texels: jax.Array  # (S,) uint32 packed RGBA8
    off: jax.Array  # (NT,) int32 flat start offsets
    h: jax.Array  # (NT,) int32 heights
    w: jax.Array  # (NT,) int32 widths


def pack_textures(textures) -> TextureAtlas:
    """Quantise + pack a list of (H, W, 4) float32 textures (host side).

    Quantisation is UNORM8 round-to-nearest (matching utils/image.py's
    write convention and the reference's 8-bit stb loads, image.cpp:30);
    textures decoded from 8-bit sources round-trip exactly.
    """
    offs, hs, ws, chunks = [], [], [], []
    off = 0
    for t in textures:
        th, tw = t.shape[0], t.shape[1]
        q = np.clip(np.round(np.asarray(t, np.float32) * 255.0), 0, 255).astype(
            np.uint32
        )
        packed = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
        chunks.append(packed.reshape(-1))
        offs.append(off)
        hs.append(th)
        ws.append(tw)
        off += th * tw
    if not chunks:  # degenerate 1-texel atlas, gated off by has_textures
        chunks = [np.full(1, 0xFFFFFFFF, np.uint32)]
        offs, hs, ws = [0], [1], [1]
    return TextureAtlas(
        texels=jnp.asarray(np.concatenate(chunks)),
        off=jnp.asarray(np.array(offs, np.int32)),
        h=jnp.asarray(np.array(hs, np.int32)),
        w=jnp.asarray(np.array(ws, np.int32)),
    )


def unpack_rgba8(p):
    """uint32 packed RGBA8 -> four float32 channels in [0, 1]."""
    f = jnp.float32(1.0 / 255.0)
    return (
        (p & 0xFF).astype(jnp.float32) * f,
        ((p >> 8) & 0xFF).astype(jnp.float32) * f,
        ((p >> 16) & 0xFF).astype(jnp.float32) * f,
        ((p >> 24) & 0xFF).astype(jnp.float32) * f,
    )


def sample_bilinear(atlas: TextureAtlas, tex_idx, uv):
    """Sample texture ``tex_idx`` (per lane) at ``uv`` with repeat+bilinear.

    Args:
      atlas: the scene :class:`TextureAtlas`.
      tex_idx: (N,) int32 texture index (callers mask out -1 lanes).
      uv: (N, 2) float32.

    Returns (N, 4) float32 texels.
    """
    ti = jnp.maximum(tex_idx, 0)
    off = jnp.take(atlas.off, ti, axis=0)
    hn = jnp.take(atlas.h, ti, axis=0)
    wn = jnp.take(atlas.w, ti, axis=0)
    h = hn.astype(jnp.float32)
    w = wn.astype(jnp.float32)
    # GL-style: texel centres at (i+0.5)/n
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = _wrap(x0.astype(jnp.int32), wn)
    x1i = _wrap(x0.astype(jnp.int32) + 1, wn)
    y0i = _wrap(y0.astype(jnp.int32), hn)
    y1i = _wrap(y0.astype(jnp.int32) + 1, hn)

    def fetch(yy, xx):
        p = jnp.take(atlas.texels, off + yy * wn + xx, axis=0)
        return jnp.stack(unpack_rgba8(p), axis=-1)

    c00 = fetch(y0i, x0i)
    c01 = fetch(y0i, x1i)
    c10 = fetch(y1i, x0i)
    c11 = fetch(y1i, x1i)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EnvMap:
    """Equirect HDR environment as flat float32 component columns.

    The skybox is HDR (Radiance RGBE source, main.cpp:138) so it keeps
    float32 texels — but row-major FLAT columns with static dims, so the
    four bilinear corner fetches are plain 1-D gathers (a 2-index fetch
    into (H, W, 3) is the multi-dim-gather slow path, docs/DESIGN.md §3).
    """

    r: jax.Array  # (H*W,) f32
    g: jax.Array
    b: jax.Array
    h: int = dataclasses.field(metadata=dict(static=True))
    w: int = dataclasses.field(metadata=dict(static=True))


def pack_envmap(env) -> EnvMap:
    """(H, W, 3) float32 numpy -> flat EnvMap columns (host side)."""
    env = np.asarray(env, np.float32)
    h, w = env.shape[0], env.shape[1]
    flat = env.reshape(h * w, 3)
    return EnvMap(
        r=jnp.asarray(flat[:, 0].copy()),
        g=jnp.asarray(flat[:, 1].copy()),
        b=jnp.asarray(flat[:, 2].copy()),
        h=h,
        w=w,
    )


def sample_equirect(env: EnvMap, direction):
    """Equirectangular environment lookup (shaders/skybox.rmiss:17-29).

    Replicates the reference exactly: uv = (atan2(z, x)/2pi + 0.5,
    -(asin(y)/pi + 0.5)) with repeat addressing (the negative v wraps).
    ``direction`` may be non-unit (the reference passes the raw ray
    direction); asin input is clamped for NaN safety.

    Args: env EnvMap; direction (N, 3).  Returns (N, 3).
    """
    h, w = env.h, env.w
    u = jnp.arctan2(direction[:, 2], direction[:, 0]) * TWOPIINV + 0.5
    v = -(jnp.arcsin(jnp.clip(direction[:, 1], -1.0, 1.0)) * PIINV + 0.5)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0.astype(jnp.int32) + 1, w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    y1i = jnp.mod(y0.astype(jnp.int32) + 1, h)

    # one packed (H*W, 3) row gather per bilinear corner instead of three
    # element gathers each; the trace-time stack is loop-invariant and
    # hoisted by XLA.  Tiny stub envmaps keep element
    # gathers (ops/gatherpack.py size gate).
    def fetch(yy, xx):
        g = packed_gather([env.r, env.g, env.b], yy * w + xx)
        return jnp.stack(g, axis=-1)

    c00 = fetch(y0i, x0i)
    c01 = fetch(y0i, x1i)
    c10 = fetch(y1i, x0i)
    c11 = fetch(y1i, x1i)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy
