"""Carry-less binary arithmetic coder as branch-free uint32 lane math.

Re-design of the reference PAQ-style range coder (src/coder/encoder.cpp:8-34,
src/coder/decoder.cpp:17-39) for in-scan execution on an accelerator:

- All registers are (S,) uint32 lanes, one per independent stream.
- Encode and decode are ONE function: `mode` (traced bool) selects whether the
  bit comes from the caller (encode) or from the range comparison (decode).
  Because both paths run the identical compiled program, the model state the
  decoder evolves is bit-for-bit the state the encoder evolved - the absolute
  correctness requirement of the codec.
- The data-dependent renormalisation `while` loop (0-4 iterations per bit,
  monotone: once the top bytes differ it stays stopped) is unrolled to 4
  masked steps, each producing an (emit byte, emit?) pair for the encoder and
  consuming one lookahead byte for the decoder.

The probability is discretised exactly like the reference: p16 = 1 + 65534*p
truncated to uint (encoder.cpp:8).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# NumPy scalars, so that importing the module starts no JAX backend
_TOP_MASK = np.uint32(0xFF000000)
_LOW_MASK = np.uint32(0x0000FFFF)
_FF = np.uint32(255)


class CoderState(NamedTuple):
    """(S,) uint32 lanes. x is only meaningful in decode mode."""

    x1: jnp.ndarray
    x2: jnp.ndarray
    x: jnp.ndarray


def init_coder(num_streams: int) -> CoderState:
    return CoderState(
        x1=jnp.zeros((num_streams,), jnp.uint32),
        x2=jnp.full((num_streams,), 0xFFFFFFFF, jnp.uint32),
        x=jnp.zeros((num_streams,), jnp.uint32),
    )


def discretize(p: jnp.ndarray) -> jnp.ndarray:
    """f32 probability in (0,1) -> uint32 in [1, 65535] (encoder.cpp:8)."""
    return (jnp.float32(1.0) + jnp.float32(65534.0) * p).astype(jnp.uint32)


def coder_bit(
    st: CoderState,
    p16: jnp.ndarray,
    enc_bit: jnp.ndarray,
    in_bytes: jnp.ndarray,
    decode: jnp.ndarray,
):
    """One coder bit for all streams.

    Args:
      st: coder registers, (S,) uint32 each.
      p16: discretised probability of bit==1, (S,) uint32.
      enc_bit: the known bit in encode mode, (S,) uint32 in {0,1}.
      in_bytes: (S, 4) uint32 lookahead bytes of the code stream at the
        current read positions (decode mode; ignored for encode).
      decode: traced bool scalar - False: encode, True: decode.

    Returns:
      (bit (S,) uint32, new_state, emit_bytes (S,4) uint32, n_renorm (S,) int32)
      The encoder must append emit_bytes[:, :n_renorm] to the code stream; the
      decoder must advance its read position by n_renorm.
    """
    x1, x2, x = st
    d = x2 - x1
    xmid = x1 + (d >> jnp.uint32(16)) * p16 + (((d & _LOW_MASK) * p16) >> jnp.uint32(16))
    dec_bit = (x <= xmid).astype(jnp.uint32)
    bit = jnp.where(decode, dec_bit, enc_bit.astype(jnp.uint32))
    take = bit.astype(bool)
    x2 = jnp.where(take, xmid, x2)  # bit==1 keeps [x1, xmid]
    x1 = jnp.where(take, x1, xmid + jnp.uint32(1))  # bit==0 keeps [xmid+1, x2]

    emits = []
    counts = jnp.zeros(x1.shape, jnp.int32)
    for i in range(4):
        cond = ((x1 ^ x2) & _TOP_MASK) == 0
        emits.append(jnp.where(cond, x2 >> jnp.uint32(24), jnp.uint32(0)))
        x1 = jnp.where(cond, x1 << jnp.uint32(8), x1)
        x2 = jnp.where(cond, (x2 << jnp.uint32(8)) | _FF, x2)
        x = jnp.where(cond & decode, (x << jnp.uint32(8)) | in_bytes[:, i], x)
        counts = counts + cond.astype(jnp.int32)

    return bit, CoderState(x1, x2, x), jnp.stack(emits, axis=1), counts


def flush_bytes(x1: np.ndarray, x2: np.ndarray) -> list[bytes]:
    """Host-side per-stream flush, identical to Encoder::Flush (encoder.cpp:27-34)."""
    out = []
    for a, b in zip(np.asarray(x1, np.uint64), np.asarray(x2, np.uint64)):
        a, b = int(a), int(b)
        tail = bytearray()
        while ((a ^ b) & 0xFF000000) == 0:
            tail.append((b >> 24) & 0xFF)
            a = (a << 8) & 0xFFFFFFFF
            b = ((b << 8) + 255) & 0xFFFFFFFF
        tail.append((b >> 24) & 0xFF)
        out.append(bytes(tail))
    return out
