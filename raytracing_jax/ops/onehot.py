"""Exact one-hot row fetch — a per-ray row of a small table by matmul.

A per-ray row fetch from a small table can run as a matmul against a
one-hot of the row id: output lands batch-minor (no (R, W) -> (W, R)
relayout), and with full-f32 precision the reconstruction is BIT-exact
(1.0*x and +0 are exact). The precision matters: a platform-default
matmul may round f32 operands (TF32 on the GPU keeps 10 mantissa bits),
which perturbs values and ROUNDS integer ids above 2^11. Every
exactness-critical one-hot fetch goes through this helper so the
precision invariant lives in ONE place. chip_smoke.py checks it bit for
bit against a plain gather on the GPU.

Users: disney.shade (material rows), texture._tex_params (texture
parameters).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def fetch_rows_exact(table, ids, precision=jax.lax.Precision.HIGHEST):
    """table (W, K) x onehot(ids (R,)) -> (W, R) f32, bit-exact.

    Cost: W * K * R MACs * 6 passes (HIGHEST) — use for SMALL tables
    (K <= a few hundred); the one-hot build alone is K * R compares.
    Do not lower `precision` without an on-device check proving the
    platform default became exact."""
    k = table.shape[1]
    oh = (
        jax.lax.broadcasted_iota(jnp.int32, (k, ids.shape[0]), 0)
        == ids[None, :]
    ).astype(jnp.float32)
    return jax.lax.dot_general(
        table.astype(jnp.float32), oh, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=precision,
    )
