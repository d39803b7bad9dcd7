"""Vectorised MurmurHash3_x86_32 in uint32 JAX ops.

The reference hashes byte contexts with the public-domain MurmurHash3_x86_32
(reference: src/contexts/murmur-hash.cpp, seed 0xDEADBEEF everywhere), always
over fixed-size little-endian keys: 8-byte keys for skip/recent-byte contexts
(src/contexts/skip-context.cpp:17) and outer contexts
(src/contexts/indirect-hash.cpp:26), and a 4-byte key for the inner
indirect-hash context (src/contexts/indirect-hash.cpp:28).

Because key sizes are static we specialise the two cases to pure uint32
arithmetic (no byte loops), which vectorises across streams and across context
instances in one fused elementwise op.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

SEED = 0xDEADBEEF

# NumPy scalars, so that importing the module starts no JAX backend
_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.uint32)


def _rotl32(x: jnp.ndarray, r: int) -> jnp.ndarray:
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def _mix_block(h1: jnp.ndarray, k1: jnp.ndarray) -> jnp.ndarray:
    k1 = k1 * _C1
    k1 = _rotl32(k1, 15)
    k1 = k1 * _C2
    h1 = h1 ^ k1
    h1 = _rotl32(h1, 13)
    return h1 * jnp.uint32(5) + jnp.uint32(0xE6546B64)


def _fmix32(h: jnp.ndarray) -> jnp.ndarray:
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> jnp.uint32(16))


def murmur3_u64(lo, hi, seed: int = SEED) -> jnp.ndarray:
    """Hash an 8-byte little-endian key given as two uint32 halves.

    Equivalent to MurmurHash3_x86_32(&key, 8, seed) on a little-endian host,
    where key = (hi << 32) | lo.
    """
    h1 = _mix_block(_u32(seed), _u32(lo))
    h1 = _mix_block(h1, _u32(hi))
    h1 = h1 ^ jnp.uint32(8)
    return _fmix32(h1)


def murmur3_u32(x, seed: int = SEED) -> jnp.ndarray:
    """Hash a 4-byte key. Equivalent to MurmurHash3_x86_32(&key, 4, seed)."""
    h1 = _mix_block(_u32(seed), _u32(x))
    h1 = h1 ^ jnp.uint32(4)
    return _fmix32(h1)
