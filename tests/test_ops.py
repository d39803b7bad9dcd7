"""Unit tests for the low-level ops: murmur hash, state tables, coder, arena
row movers, fixed-tree sums."""
import numpy as np
import pytest


def _py_murmur3_32(data: bytes, seed: int) -> int:
    """Straightforward MurmurHash3_x86_32 (public-domain algorithm)."""

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF

    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data) & ~3
    for i in range(0, n, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = rotl(k, 15)
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = rotl(h, 13)
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[n:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = rotl(k, 15)
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def test_murmur_u64_matches_reference():
    from gmix_tpu.ops.murmur import murmur3_u64

    rng = np.random.RandomState(0)
    vals = rng.randint(0, 2**63, size=256).astype(np.uint64)
    lo = (vals & 0xFFFFFFFF).astype(np.uint32)
    hi = (vals >> np.uint64(32)).astype(np.uint32)
    got = np.asarray(murmur3_u64(lo, hi))
    want = np.array(
        [_py_murmur3_32(int(v).to_bytes(8, "little"), 0xDEADBEEF) for v in vals],
        np.uint32,
    )
    assert np.array_equal(got, want)


def test_murmur_u32_matches_reference():
    from gmix_tpu.ops.murmur import murmur3_u32

    rng = np.random.RandomState(1)
    vals = rng.randint(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
    got = np.asarray(murmur3_u32(vals))
    want = np.array(
        [_py_murmur3_32(int(v).to_bytes(4, "little"), 0xDEADBEEF) for v in vals],
        np.uint32,
    )
    assert np.array_equal(got, want)


def test_run_map_table():
    from gmix_tpu.ops.tables import run_map_table

    t = run_map_table()
    # 0 = unseen; a zero-bit from unseen goes to state 1 (count one zero)
    assert t[0 * 2 + 0] == 1
    # runs of zeros count up to 127
    assert t[1 * 2 + 0] == 2 and t[127 * 2 + 0] == 127
    # a one-bit from a zero-run jumps to 128
    assert t[5 * 2 + 1] == 128
    # runs of ones count up to 255
    assert t[128 * 2 + 1] == 129 and t[255 * 2 + 1] == 255
    # a zero-bit from a one-run resets to 1
    assert t[200 * 2 + 0] == 1


def test_nonstationary_table_shape():
    from gmix_tpu.ops.tables import nonstationary_table

    t = nonstationary_table()
    assert t.shape == (512,)
    assert t.min() >= 0 and t.max() <= 255
    # state 0 transitions (first entry of the reference table)
    assert t[0] == 2 and t[1] == 12


class PyCoder:
    """Pure-python carry-less coder mirroring encoder.cpp/decoder.cpp."""

    M = 0xFFFFFFFF

    @staticmethod
    def disc(p):
        """float32 discretisation, matching Encoder::Discretize exactly."""
        import numpy as _np
        return int(_np.float32(1.0) + _np.float32(65534.0) * _np.float32(p)) & PyCoder.M

    @staticmethod
    def encode(bits, probs):
        x1, x2, out = 0, PyCoder.M, bytearray()
        for b, p in zip(bits, probs):
            p16 = PyCoder.disc(p)
            d = (x2 - x1) & PyCoder.M
            xmid = (x1 + (d >> 16) * p16 + (((d & 0xFFFF) * p16) >> 16)) & PyCoder.M
            if b:
                x2 = xmid
            else:
                x1 = (xmid + 1) & PyCoder.M
            while ((x1 ^ x2) & 0xFF000000) == 0:
                out.append((x2 >> 24) & 0xFF)
                x1 = (x1 << 8) & PyCoder.M
                x2 = ((x2 << 8) + 255) & PyCoder.M
        while ((x1 ^ x2) & 0xFF000000) == 0:
            out.append((x2 >> 24) & 0xFF)
            x1 = (x1 << 8) & PyCoder.M
            x2 = ((x2 << 8) + 255) & PyCoder.M
        out.append((x2 >> 24) & 0xFF)
        return bytes(out)

    @staticmethod
    def decode(code, probs, n):
        x1, x2, x, pos = 0, PyCoder.M, 0, 0

        def rd():
            nonlocal pos
            b = code[pos] if pos < len(code) else 0
            pos += 1
            return b

        for _ in range(4):
            x = ((x << 8) | rd()) & PyCoder.M
        bits = []
        for p in probs[:n]:
            p16 = PyCoder.disc(p)
            d = (x2 - x1) & PyCoder.M
            xmid = (x1 + (d >> 16) * p16 + (((d & 0xFFFF) * p16) >> 16)) & PyCoder.M
            if x <= xmid:
                bits.append(1)
                x2 = xmid
            else:
                bits.append(0)
                x1 = (xmid + 1) & PyCoder.M
            while ((x1 ^ x2) & 0xFF000000) == 0:
                x1 = (x1 << 8) & PyCoder.M
                x2 = ((x2 << 8) + 255) & PyCoder.M
                x = ((x << 8) | rd()) & PyCoder.M
        return bits


def test_py_coder_roundtrip():
    rng = np.random.RandomState(7)
    bits = rng.randint(0, 2, 5000).tolist()
    probs = rng.uniform(0.001, 0.999, 5000).astype(np.float32)
    code = PyCoder.encode(bits, probs)
    assert PyCoder.decode(code, probs, 5000) == bits


def test_jax_coder_matches_py_coder():
    """The in-scan uint32 coder must agree byte-for-byte with the scalar
    reference semantics, in both encode and decode mode."""
    import jax
    import jax.numpy as jnp

    from gmix_tpu.ops import coder as C

    rng = np.random.RandomState(3)
    N = 512
    bits = rng.randint(0, 2, N)
    probs = rng.uniform(0.01, 0.99, N).astype(np.float32)
    code = PyCoder.encode(bits.tolist(), probs)

    @jax.jit
    def enc_all(bits_a, probs_a):
        def step(st, xs):
            b, p = xs
            bit, st, emits, cnt = C.coder_bit(
                st,
                C.discretize(p[None]),
                b[None].astype(jnp.uint32),
                jnp.zeros((1, 4), jnp.uint32),
                jnp.asarray(False),
            )
            return st, (emits[0], cnt[0])

        st = C.init_coder(1)
        st, (emits, cnts) = jax.lax.scan(step, st, (bits_a, probs_a))
        return st, emits, cnts

    st, emits, cnts = enc_all(jnp.asarray(bits), jnp.asarray(probs))
    out = bytearray()
    emits, cnts = np.asarray(emits), np.asarray(cnts)
    for e, c in zip(emits, cnts):
        out += bytes(int(x) for x in e[:c])
    out += C.flush_bytes(np.asarray(st.x1), np.asarray(st.x2))[0]
    assert bytes(out) == code

    @jax.jit
    def dec_all(code_a, probs_a):
        def step(carry, p):
            st, rpos = carry
            ib = jax.lax.dynamic_slice_in_dim(code_a, rpos, 4)[None, :].astype(jnp.uint32)
            bit, st, _, cnt = C.coder_bit(
                st, C.discretize(p[None]), jnp.zeros((1,), jnp.uint32), ib, jnp.asarray(True)
            )
            return (st, rpos + cnt[0]), bit[0]

        x0 = (
            (code_a[0].astype(jnp.uint32) << 24)
            | (code_a[1].astype(jnp.uint32) << 16)
            | (code_a[2].astype(jnp.uint32) << 8)
            | code_a[3].astype(jnp.uint32)
        )
        st = C.CoderState(
            jnp.zeros((1,), jnp.uint32),
            jnp.full((1,), 0xFFFFFFFF, jnp.uint32),
            x0[None],
        )
        (_, _), outbits = jax.lax.scan(step, (st, jnp.int32(4)), probs_a)
        return outbits

    pad = np.zeros(len(code) + 16, np.uint8)
    pad[: len(code)] = np.frombuffer(code, np.uint8)
    got = np.asarray(dec_all(jnp.asarray(pad), jnp.asarray(probs)))
    assert np.array_equal(got, bits)


def test_jax_coder_self_roundtrip():
    """decode(encode(bits)) == bits with the jax coder on both sides."""
    import jax
    import jax.numpy as jnp

    from gmix_tpu.ops import coder as C

    rng = np.random.RandomState(11)
    N = 2048
    bits = rng.randint(0, 2, N)
    probs = rng.uniform(0.001, 0.999, N).astype(np.float32)

    @jax.jit
    def enc_all(bits_a, probs_a):
        def step(st, xs):
            b, p = xs
            bit, st, emits, cnt = C.coder_bit(
                st, C.discretize(p[None]), b[None].astype(jnp.uint32),
                jnp.zeros((1, 4), jnp.uint32), jnp.asarray(False))
            return st, (emits[0], cnt[0])
        st = C.init_coder(1)
        st, out = jax.lax.scan(step, st, (bits_a, probs_a))
        return st, out

    st, (emits, cnts) = enc_all(jnp.asarray(bits), jnp.asarray(probs))
    out = bytearray()
    for e, c in zip(np.asarray(emits), np.asarray(cnts)):
        out += bytes(int(x) for x in e[:c])
    out += C.flush_bytes(np.asarray(st.x1), np.asarray(st.x2))[0]
    code = np.zeros(len(out) + 16, np.uint8)
    code[: len(out)] = np.frombuffer(bytes(out), np.uint8)

    @jax.jit
    def dec_all(code_a, probs_a):
        def step(carry, p):
            st, rpos = carry
            ib = jax.lax.dynamic_slice_in_dim(code_a, rpos, 4)[None, :].astype(jnp.uint32)
            bit, st, _, cnt = C.coder_bit(
                st, C.discretize(p[None]), jnp.zeros((1,), jnp.uint32), ib, jnp.asarray(True))
            return (st, rpos + cnt[0]), bit[0]
        x0 = (code_a[0].astype(jnp.uint32) << 24) | (code_a[1].astype(jnp.uint32) << 16) | \
             (code_a[2].astype(jnp.uint32) << 8) | code_a[3].astype(jnp.uint32)
        st = C.CoderState(jnp.zeros((1,), jnp.uint32), jnp.full((1,), 0xFFFFFFFF, jnp.uint32), x0[None])
        (_, _), outbits = jax.lax.scan(step, (st, jnp.int32(4)), probs_a)
        return outbits

    got = np.asarray(dec_all(jnp.asarray(code), jnp.asarray(probs)))
    assert np.array_equal(got, bits)


def test_indirect_rotation_optout_roundtrip():
    """IndirectModel.rotate=False pins a model's lane rotation to 0 (full
    collision sharing, the measured-better choice for sparse deep-order
    contexts) while other models keep the hash-derived derangement; the
    mixed-spec codec must still roundtrip exactly."""
    import dataclasses

    import numpy as np

    from gmix_tpu.config import tiny_spec
    from gmix_tpu.core.codec import compress_bytes, decompress_bytes
    from gmix_tpu.core.meta import build_meta

    spec = tiny_spec()
    spec = dataclasses.replace(
        spec,
        indirects=tuple(
            dataclasses.replace(m, rotate=(i % 2 == 0))
            for i, m in enumerate(spec.indirects)
        ),
    )
    meta = build_meta(spec)
    assert meta.ind_rotate.tolist() == [1, 0, 1, 0, 1, 0]
    data = bytes(np.random.default_rng(3).integers(0, 256, 600, np.uint8)) * 2
    blob = compress_bytes(data, spec, num_streams=2, chunk=50)
    assert decompress_bytes(blob, spec, chunk=50) == data
    # the spec hash must distinguish rotation choices (archive compatibility)
    assert spec.stable_hash() != tiny_spec().stable_hash()


def test_quality_variant_specs_build():
    """Every tools/quality.py variant name must build a valid spec (a
    typo'd variant must fail at parse time, not after a long compile on the
    accelerator)."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    try:
        from quality import make_variant
    finally:
        sys.path.pop(0)
    for name in ("ref-x4", "ref-x1", "ref-x4-noppm", "ref-x4-oldppm",
                 "scaled-14x16", "scaled-12x64", "boost-1-17x4", "boost-1-18x4",
                 "tuned-x4", "best-x4", "ppmtune-6-32000-20x4"):
        spec, S = make_variant(name)
        assert S >= 1
        spec.validate()


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_gather_scatter_rows_match_numpy(dtype):
    """gather_rows/scatter_rows against plain NumPy indexing on a (S, N, W)
    arena, with unique row indices per stream (the movers' contract)."""
    import jax.numpy as jnp

    from gmix_tpu.ops.rowmove import gather_rows, scatter_rows

    rng = np.random.default_rng(7)
    S, N, W, M = 3, 50, 272, 9
    tbl = rng.integers(0, 60000, (S, N, W)).astype(dtype)
    idx = np.stack([rng.permutation(N)[:M] for _ in range(S)]).astype(np.int32)
    upd = rng.integers(0, 60000, (S, M, W)).astype(dtype)

    got = np.asarray(gather_rows(jnp.asarray(tbl), jnp.asarray(idx)))
    assert got.dtype == dtype
    assert np.array_equal(got, tbl[np.arange(S)[:, None], idx])

    want = tbl.copy()
    want[np.arange(S)[:, None], idx] = upd
    got = np.asarray(scatter_rows(jnp.asarray(tbl), jnp.asarray(idx), jnp.asarray(upd)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_tree_sum_matches_numpy_and_batch_shape(axis):
    """_tree_sum sums over any axis (non-power-of-two lengths pad with exact
    zeros), and a stream's sum does not depend on how many streams share the
    batch."""
    import jax.numpy as jnp

    from gmix_tpu.core.step import _tree_sum

    rng = np.random.default_rng(axis % 3)
    x = rng.integers(-50, 50, (5, 3, 7)).astype(np.float32)  # exact in f32
    assert np.array_equal(np.asarray(_tree_sum(jnp.asarray(x), axis=axis)), x.sum(axis=axis))

    y = rng.standard_normal((6, 3, 37)).astype(np.float32)
    full = np.asarray(_tree_sum(jnp.asarray(y)))
    one = np.asarray(_tree_sum(jnp.asarray(y[2:3])))
    assert np.array_equal(full[2:3], one)


def test_onehot_row_copies_bit_patterns():
    """The dense-row selection is an exact bit copy, denormals included."""
    import jax.numpy as jnp

    from gmix_tpu.core.step import _onehot_row

    bits = np.arange(2 * 5 * 4, dtype=np.uint32).reshape(2, 5, 4) + 1  # denormal floats
    tbl = bits.view(np.float32)
    oh = np.zeros((2, 5), bool)
    oh[0, 3] = oh[1, 0] = True
    got = np.asarray(_onehot_row(jnp.asarray(oh), jnp.asarray(tbl))).view(np.uint32)
    assert np.array_equal(got, bits[[0, 1], [3, 0]])
