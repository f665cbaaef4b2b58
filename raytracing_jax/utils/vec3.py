"""Component-plane 3-vectors — the batch-minor vector layout.

The same struct-of-arrays discipline the C reference applies to its SIMD
registers (Vec3x8 = three f32x8, common.h:50-80): a vector batch is three
separate arrays whose minor dimension is the BATCH, so elementwise stages
fuse cleanly and no array carries a minor dimension of 3.

`Vec3` holds x/y/z component arrays of identical (arbitrary) shape and is a
pytree, so it flows through jit/scan/sharding like any array.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
from raytracing_jax.utils import pytree


@pytree.dataclass
class Vec3:
    x: Any
    y: Any
    z: Any

    # -- construction ------------------------------------------------------

    @staticmethod
    def of(x, y, z) -> "Vec3":
        return Vec3(x=x, y=y, z=z)

    @staticmethod
    def splat(v, shape=()) -> "Vec3":
        """Broadcast a python/np 3-tuple to the given component shape."""
        f = jnp.float32
        return Vec3(
            x=jnp.broadcast_to(f(v[0]), shape),
            y=jnp.broadcast_to(f(v[1]), shape),
            z=jnp.broadcast_to(f(v[2]), shape),
        )

    @staticmethod
    def zeros(shape=()) -> "Vec3":
        z = jnp.zeros(shape, jnp.float32)
        return Vec3(x=z, y=z, z=z)

    @staticmethod
    def full(shape, value) -> "Vec3":
        v = jnp.full(shape, value, jnp.float32)
        return Vec3(x=v, y=v, z=v)

    @staticmethod
    def from_array(a, axis: int = -1) -> "Vec3":
        """Split a (..., 3) array (host/staging use only — never on the hot
        path)."""
        parts = jnp.split(jnp.asarray(a), 3, axis=axis)
        sq = lambda p: jnp.squeeze(p, axis=axis)  # noqa: E731
        return Vec3(x=sq(parts[0]), y=sq(parts[1]), z=sq(parts[2]))

    def to_array(self, axis: int = -1):
        return jnp.stack([self.x, self.y, self.z], axis=axis)

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry -----------------------------------------------------------

    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            x=self.y * o.z - self.z * o.y,
            y=self.z * o.x - self.x * o.z,
            z=self.x * o.y - self.y * o.x,
        )

    def length2(self):
        return self.dot(self)

    def length(self):
        return jnp.sqrt(self.length2())

    def normalized(self) -> "Vec3":
        import jax

        return self * jax.lax.rsqrt(jnp.maximum(self.length2(), 1e-38))

    def reflect(self, n: "Vec3") -> "Vec3":
        """Reflect self about unit normal n."""
        return self - n * (2.0 * self.dot(n))

    def lerp(self, o: "Vec3", t) -> "Vec3":
        return self * (1.0 - t) + o * t

    # -- structural ---------------------------------------------------------

    @staticmethod
    def where(mask, a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(
            x=jnp.where(mask, a.x, b.x),
            y=jnp.where(mask, a.y, b.y),
            z=jnp.where(mask, a.z, b.z),
        )

    def gather(self, idx) -> "Vec3":
        """Index every component plane: Vec3(x[idx], y[idx], z[idx])."""
        return Vec3(x=self.x[idx], y=self.y[idx], z=self.z[idx])

    def map(self, fn) -> "Vec3":
        return Vec3(x=fn(self.x), y=fn(self.y), z=fn(self.z))

    def sum(self):
        return self.x + self.y + self.z

    def max_comp(self):
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def min_comp(self):
        return jnp.minimum(self.x, jnp.minimum(self.y, self.z))

    @property
    def shape(self):
        return jnp.shape(self.x)


def vmin(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        jnp.minimum(a.x, b.x), jnp.minimum(a.y, b.y), jnp.minimum(a.z, b.z)
    )


def vmax(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        jnp.maximum(a.x, b.x), jnp.maximum(a.y, b.y), jnp.maximum(a.z, b.z)
    )
