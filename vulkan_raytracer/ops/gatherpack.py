"""Size-gated row-gather packing.

A packed (R, K) axis-0 row gather fetches K columns of one row with a
single gather instead of K element gathers.  Tables below PACK_MIN_ROWS
rows keep per-column element gathers; whether the gate or the packing pays
on the GPU is not yet measured.

Both paths return the same values in the same arithmetic order, so
callers are bit-identical regardless of which side the gate picks.
"""

from __future__ import annotations

import jax.numpy as jnp

#: minimum table rows for the packed row gather
PACK_MIN_ROWS = 4096


def packed_gather(cols, idx):
    """Gather ``[c[idx] for c in cols]`` — one (R, K) row gather when the
    table is large enough, K element gathers otherwise.

    Args:
      cols: sequence of (R,) arrays (same R; dtypes may mix — the packed
        side stacks as f32 and exactly recovers bool/int32-as-float
        values only when they are representable; callers pass f32/bool).
      idx: (N,) int32 row indices.

    Returns: list of (N,) arrays, one per column, dtype preserved.
    """
    r = cols[0].shape[0]
    if r >= PACK_MIN_ROWS:
        packed = jnp.stack(
            [c.astype(jnp.float32) for c in cols], axis=1
        )  # trace-time, loop-invariant -> hoisted by XLA
        g = jnp.take(packed, idx, axis=0)
        return [
            g[:, k].astype(c.dtype) if g.dtype != c.dtype else g[:, k]
            for k, c in enumerate(cols)
        ]
    return [jnp.take(c, idx, axis=0) for c in cols]
