"""Clamped logistic/logit, the probability<->logit bridge of the whole codec.

Matches the reference contract (src/mixer/sigmoid.cpp:5-13): Logit clamps the
probability to [1e-4, 1-1e-4] before log-odds; Logistic is the plain sigmoid.
The final predictor output is additionally clamped to the same range
(src/predictor.cpp:370-375).

DETERMINISM BY CONSTRUCTION: every transcendental here is built
from IEEE-exact primitives only (+, *, /, floor, compares, integer bit ops),
via explicit polynomials. Backend transcendental kernels (XLA:CPU libm vs
SIMD polynomials, GPU fast-math approximations) round differently depending on
array SHAPE: a (1,)-shaped jnp.log takes the scalar libm path while a
(8,)-shaped one takes an 8-wide SIMD path, so the same per-stream computation
produced different floats at different stream-batch sizes. That broke
cross-topology archive portability: a stream encoded inside an S=8 program
could fail to decode in an S=1 program (observed as a 1-ulp divergence in the
APM chain, whose logit/logistic operate on (S,)-shaped values). Fixed
polynomials make every per-stream float a function of per-stream inputs only,
for any batch shape, on any backend. Encoder/decoder bit-exactness within one
program was already structural (one compiled program serves both modes);
this extends it to bit-exactness ACROSS program shapes.

All constants are PYTHON literals, not jnp scalars: weak typing rounds them
to f32 identically, and importing the module creates no device array.

All math is float32. Accuracy vs libm: |rel err| < ~3e-7 for exp/log in the
used ranges - indistinguishable at the codec's 16-bit probability
discretization and irrelevant to learning (the reference's own libm values
are not a contract; self-consistency is).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

F32 = jnp.float32
I32 = jnp.int32

LOGIT_EPS = 1e-4

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_SQRT2 = 1.4142135623730951
# Cody-Waite split of ln2: C1 exact in f32, C1 + C2 = ln2 to ~1e-11
_LN2_HI = 0.693359375
_LN2_LO = -2.12194440e-4


def _exp_scaled(u, n) -> jnp.ndarray:
    """e**u * 2**n for |u| <= ln2/2 and integer-valued f32 n in [-126, 126]:
    degree-7 Taylor (|rel err| < 5e-9) + exact exponent-field scaling."""
    p = u * (1.0 / 5040.0) + (1.0 / 720.0)
    for c in (1.0 / 120, 1.0 / 24, 1.0 / 6, 0.5, 1.0, 1.0):
        p = p * u + c
    scale = jax.lax.bitcast_convert_type((n.astype(I32) + 127) << 23, F32)
    return p * scale


def exp2_det(t) -> jnp.ndarray:
    """2**t for f32 t in [-126, 126], deterministic across shapes/backends."""
    t = jnp.clip(jnp.asarray(t, F32), -126.0, 126.0)
    n = jnp.round(t)
    u = (t - n) * _LN2  # |u| <= ln2/2, exact difference then one rounding
    return _exp_scaled(u, n)


def exp_det(x) -> jnp.ndarray:
    """e**x, deterministic; underflows to ~1e-38 below -87. Cody-Waite
    reduction keeps |rel err| < ~3e-7 over the full range (a bare x*log2e
    conversion loses ~4e-6 near |x|=87)."""
    x = jnp.clip(jnp.asarray(x, F32), -87.0, 87.0)
    n = jnp.round(x * _LOG2E)
    u = (x - n * _LN2_HI) - n * _LN2_LO
    return _exp_scaled(u, n)


def log2_det(x) -> jnp.ndarray:
    """log2(x) for finite x > 0, deterministic across shapes/backends.

    Mantissa/exponent split by integer bit ops; ln(m) for m in
    [1/sqrt2, sqrt2) via the atanh series in z=(m-1)/(m+1), degree 7
    (|err| < 2e-8)."""
    x = jnp.asarray(x, F32)
    xb = jax.lax.bitcast_convert_type(x, I32)
    e = ((xb >> 23) & 0xFF) - 127
    m = jax.lax.bitcast_convert_type((xb & 0x007FFFFF) | 0x3F800000, F32)  # [1, 2)
    big = m > _SQRT2
    m = jnp.where(big, m * 0.5, m)
    e = e + big.astype(I32)
    z = (m - 1.0) / (m + 1.0)
    z2 = z * z
    p = z2 * (2.0 / 7.0) + (2.0 / 5.0)
    for c in (2.0 / 3.0, 2.0):
        p = p * z2 + c
    lnm = p * z
    return e.astype(F32) + lnm * _LOG2E


def log_det(x) -> jnp.ndarray:
    """ln(x) for finite x > 0, deterministic."""
    return log2_det(x) * _LN2


def pow_det(x, a: float) -> jnp.ndarray:
    """x**a for x > 0 and a STATIC python exponent, deterministic."""
    return exp2_det(log2_det(x) * float(a))


def powc_det(base: float, t) -> jnp.ndarray:
    """base**t for a STATIC python base > 0 and traced exponent t,
    deterministic (the host computes log2(base) in f64)."""
    return exp2_det(jnp.asarray(t, F32) * math.log2(base))


def tanh_det(x) -> jnp.ndarray:
    """tanh(x) as 1 - 2/(e**2x + 1), deterministic. Relative error grows to
    ~1e-5 for |x| < 1e-2 (cancellation) - harmless where it is used (LSTM
    gate/cell nonlinearities; the values feed learned weights, not the coder
    discretization directly)."""
    x = jnp.asarray(x, F32)
    return 1.0 - 2.0 / (exp_det(x + x) + 1.0)


def logistic(x) -> jnp.ndarray:
    x = jnp.asarray(x, dtype=jnp.float32)
    return 1.0 / (1.0 + exp_det(-x))


def logit(p) -> jnp.ndarray:
    p = jnp.clip(jnp.asarray(p, dtype=jnp.float32), LOGIT_EPS, 1.0 - LOGIT_EPS)
    return log_det(p / (1.0 - p))


def clamp_prob(p) -> jnp.ndarray:
    """Clamp the final mixed probability like Predictor::Predict."""
    return jnp.clip(jnp.asarray(p, dtype=jnp.float32), LOGIT_EPS, 1.0 - LOGIT_EPS)
