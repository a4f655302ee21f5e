"""Small vector-math helpers shared by all kernels.

Vectors are jnp arrays with trailing dimension 3 (shape ``(..., 3)``), so a
wavefront of N rays stores directions as ``(N, 3)`` — SoA enough for the
lanes (the last dim unrolls into 3 lane-parallel planes under XLA).

Contains the branchless ONB of Duff et al. (reference: shaders/maths.glsl:13-19)
and GLSL intrinsic equivalents (reflect/refract/mix) used by the BSDF port.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

PI = 3.14159265358979323846
TWOPI = 2.0 * PI
PIINV = 1.0 / PI
TWOPIINV = 0.5 / PI

# Ray-march constants (shaders/constants.glsl:4-6).
BIAS = 1e-3
EPS = 1e-7
INF = 1e32

# Fraunhofer lines for dispersion (shaders/constants.glsl:8-13).
LAMBDA_F = 486.13
INV_LAMBDA_F_SQ = 0.00205706292555
LAMBDA_D = 587.56
INV_LAMBDA_D_SQ = 0.00170195384301
LAMBDA_C = 656.27
INV_LAMBDA_C_SQ = 0.00152376308532


def vec3(x, y, z):
    """Stack three lane arrays into a (..., 3) vector."""
    return jnp.stack(jnp.broadcast_arrays(x, y, z), axis=-1)


class V3(NamedTuple):
    """Component-form 3-vector: three (N,) lane arrays.

    Component arrays keep every elementwise op on full-width (N,) lanes
    instead of a trailing dimension of 3.  A NamedTuple is automatically a
    JAX pytree, so V3 flows through jit/scan/while_loop/shard_map.
    """

    x: object
    y: object
    z: object

    # -- arithmetic (elementwise; scalars broadcast) --
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- geometry --
    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o):
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self):
        return self.dot(self)

    def length(self):
        return jnp.sqrt(jnp.maximum(self.length_sq(), 0.0))

    def normalized(self, eps: float = 1e-20):
        inv = jax.lax.rsqrt(jnp.maximum(self.length_sq(), eps))
        return V3(self.x * inv, self.y * inv, self.z * inv)

    def where(self, cond, other):
        """Lane-select: cond ? self : other."""
        return V3(
            jnp.where(cond, self.x, other.x if isinstance(other, V3) else other),
            jnp.where(cond, self.y, other.y if isinstance(other, V3) else other),
            jnp.where(cond, self.z, other.z if isinstance(other, V3) else other),
        )

    def any_nonzero(self):
        return (self.x != 0.0) | (self.y != 0.0) | (self.z != 0.0)

    def max_exp_neg(self, t):
        """exp(-self * t) componentwise (Beer-Lambert helper)."""
        return V3(jnp.exp(-self.x * t), jnp.exp(-self.y * t), jnp.exp(-self.z * t))

    # -- conversions --
    @staticmethod
    def from_array(a):
        """(N, 3) -> V3."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def splat(v, shape=None):
        """Constant 3-vector (python/np) -> V3, optionally broadcast."""
        x, y, z = (jnp.asarray(c, jnp.float32) for c in v)
        if shape is not None:
            x = jnp.broadcast_to(x, shape)
            y = jnp.broadcast_to(y, shape)
            z = jnp.broadcast_to(z, shape)
        return V3(x, y, z)

    def to_array(self):
        """V3 -> (N, 3)."""
        return jnp.stack(jnp.broadcast_arrays(self.x, self.y, self.z), axis=-1)


def v3_reflect(i: V3, n: V3) -> V3:
    """GLSL reflect(I, N) = I - 2*dot(N, I)*N on component vectors."""
    return i - n * (2.0 * n.dot(i))


def v3_refract(i: V3, n: V3, eta) -> V3:
    """GLSL refract; zero vector on total internal reflection."""
    cosi = n.dot(i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    coef = eta * cosi + jnp.sqrt(jnp.maximum(k, 0.0))
    out = i * eta - n * coef
    return V3(
        jnp.where(tir, 0.0, out.x),
        jnp.where(tir, 0.0, out.y),
        jnp.where(tir, 0.0, out.z),
    )


def v3_gather(v: V3, idx) -> V3:
    """Gather rows of a V3-of-(T,) table by (N,) indices.

    Three flat 1-D gathers.
    """
    return V3(
        jnp.take(v.x, idx, axis=0),
        jnp.take(v.y, idx, axis=0),
        jnp.take(v.z, idx, axis=0),
    )


def v3_onb(n: V3):
    """Branchless ONB (Duff et al., shaders/maths.glsl:13-19) on components."""
    sign = jnp.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    tangent = V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bitangent = V3(b, sign + n.y * n.y * a, -n.y)
    return tangent, bitangent


def v3_to_tangent(v: V3, t: V3, b: V3, n: V3) -> V3:
    return V3(v.dot(t), v.dot(b), v.dot(n))


def v3_from_tangent(v: V3, t: V3, b: V3, n: V3) -> V3:
    return t * v.x + b * v.y + n * v.z


def dot3(a, b):
    return jnp.sum(a * b, axis=-1)


def cross3(a, b):
    return jnp.cross(a, b)


def length3(a):
    return jnp.sqrt(jnp.maximum(dot3(a, a), 0.0))


def normalize3(a, eps: float = 0.0):
    """GLSL normalize; with eps=0 matches GLSL (inf/nan on zero vectors)."""
    n = length3(a)
    if eps:
        n = jnp.maximum(n, eps)
    return a / n[..., None]


def safe_normalize3(a):
    return normalize3(a, eps=1e-20)


def mix(a, b, t):
    """GLSL mix(a, b, t) = a*(1-t) + b*t."""
    return a * (1.0 - t) + b * t


def reflect(incident, n):
    """GLSL reflect(I, N) = I - 2*dot(N, I)*N."""
    return incident - 2.0 * dot3(n, incident)[..., None] * n


def refract(incident, n, eta):
    """GLSL refract(I, N, eta); returns zero vector on total internal reflection."""
    cosi = dot3(n, incident)
    eta = jnp.asarray(eta)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    k_safe = jnp.maximum(k, 0.0)
    out = eta[..., None] * incident - (eta * cosi + jnp.sqrt(k_safe))[..., None] * n
    return jnp.where(tir[..., None], 0.0, out)


def branchless_onb(n):
    """Orthonormal basis from a unit normal, Duff et al. (shaders/maths.glsl:13-19).

    Returns (tangent, bitangent) with the exact sign conventions of the
    reference so that sampled hemispheres line up bit-for-bit.
    """
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    tangent = vec3(
        1.0 + sign * n[..., 0] * n[..., 0] * a,
        sign * b,
        -sign * n[..., 0],
    )
    bitangent = vec3(b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1])
    return tangent, bitangent


def to_tangent(v, tangent, bitangent, normal):
    """world -> tangent space (rows of the orthonormal frame)."""
    return vec3(dot3(v, tangent), dot3(v, bitangent), dot3(v, normal))


def from_tangent(v, tangent, bitangent, normal):
    """tangent -> world space."""
    return (
        v[..., 0:1] * tangent + v[..., 1:2] * bitangent + v[..., 2:3] * normal
    )
