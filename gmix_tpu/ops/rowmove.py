"""Batched arena-row movers: gather/scatter rows of (S, N, W) tables.

The codec step moves ~260 rows per stream per byte between the model arenas
and its per-byte working registers (indirect blocks, mixer weight rows, PPM
count rows - see core/step.py). Both movers are XLA's own indexed gather and
scatter; everything is pure memory movement, with no float math.

Row indices must be unique within a stream (each model family owns a disjoint
offset range of its arena - meta.py builds them that way), which is the
`unique_indices=True` contract of the scatter.
"""
from __future__ import annotations

import jax.numpy as jnp


def gather_rows(tbl: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """(S, N, W)[s, idx[s, m]] -> (S, M, W)."""
    s_ix = jnp.arange(tbl.shape[0])[:, None]
    return tbl[s_ix, idx]


def scatter_rows(tbl: jnp.ndarray, idx: jnp.ndarray, upd: jnp.ndarray) -> jnp.ndarray:
    """tbl[s, idx[s, m]] = upd[s, m]; idx unique per stream. Returns tbl."""
    s_ix = jnp.arange(tbl.shape[0])[:, None]
    return tbl.at[s_ix, idx].set(upd, unique_indices=True)
