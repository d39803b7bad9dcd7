"""End-to-end roundtrip tests (reference: tester.cpp TestCompression /
TestDecompressionWithRestart)."""
import numpy as np
import pytest

import gmix_tpu as g

TEXT = (
    b"It is a truth universally acknowledged, that a single man in possession "
    b"of a good fortune, must be in want of a wife. " * 24
)


@pytest.mark.parametrize("streams,chunk", [(2, 128)])
def test_roundtrip_tiny(streams, chunk):
    spec = g.tiny_spec(with_lstm=False)
    data = TEXT[:1500]
    blob = g.compress_bytes(data, spec, num_streams=streams, chunk=chunk)
    assert g.decompress_bytes(blob, spec, chunk=chunk) == data
    # online learning must actually compress repetitive text
    assert len(blob) < len(data)


def test_roundtrip_lstm():
    spec = g.tiny_spec(with_lstm=True)
    data = TEXT[:1024]
    blob = g.compress_bytes(data, spec, num_streams=1, chunk=256)
    assert g.decompress_bytes(blob, spec, chunk=256) == data


def test_roundtrip_binary():
    rng = np.random.RandomState(0)
    data = rng.bytes(2048)
    spec = g.tiny_spec(with_lstm=False)
    blob = g.compress_bytes(data, spec, num_streams=2, chunk=128)
    assert g.decompress_bytes(blob, spec, chunk=128) == data


def test_roundtrip_empty_and_tiny_inputs():
    spec = g.tiny_spec(with_lstm=False)
    assert g.decompress_bytes(g.compress_bytes(b"", spec, 2, 128), spec, chunk=128) == b""
    for n in (1, 2, 127, 128, 129):
        data = TEXT[:n]
        blob = g.compress_bytes(data, spec, num_streams=2, chunk=128)
        assert g.decompress_bytes(blob, spec, chunk=128) == data


def test_encode_output_is_unbounded_by_code_buf():
    """The encoder's renorm bytes leave the scan as dense per-byte outputs
    (codec.run_chunks), so encoding cannot overflow a device buffer: a
    minimal code_buf produces the identical payload as a full-size one.
    (The pre-round-4 design scattered into code_buf and needed a sticky
    overflow flag; this test replaces the old overflow-raises test.)"""
    import jax.numpy as jnp

    from gmix_tpu.core.codec import Predictor, _pad_streams, run_chunks

    spec = g.tiny_spec(with_lstm=False)
    rng = np.random.RandomState(42)
    data = rng.bytes(1024)
    arr, per = _pad_streams(data, 1, 128)

    def encode(cap):
        pred = Predictor(spec, 1)
        _, _, bodies = run_chunks(
            pred, jnp.asarray(arr), jnp.zeros((1, cap), jnp.uint8), per,
            decode=False, chunk=128,
        )
        return bodies[0]

    big = encode(4096)
    small = encode(8)
    assert big == small and len(big) > 900  # random data is incompressible


def test_entropy_reported():
    from gmix_tpu.core.codec import Predictor, compress_bytes, entropy_bits

    spec = g.tiny_spec(with_lstm=False)
    pred = Predictor(spec, 2)
    data = TEXT[:1024]
    compress_bytes(data, spec, 2, 128, pred=pred)
    ent = entropy_bits(pred)
    assert 0 < ent < 8.0 * 1100  # less than 8 bits/byte incl. padding


def test_tiny_spec_covers_all_mixer_placement_classes():
    """Guard: the CPU suite's invariants are only as
    strong as tiny_spec's coverage. Every one of the five mixer placement
    classes (core/meta.py: stable / pos / ctx-dense / pos-dense / lm) must be
    populated, so roundtrip/checkpoint/copy tests exercise each arena path."""
    from gmix_tpu.core.meta import build_meta

    for lstm in (False, True):
        meta = build_meta(g.tiny_spec(with_lstm=lstm))
        assert len(meta.mix_st_ix) > 0, "no stable-arena mixer in tiny_spec"
        assert len(meta.mix_pos_ix) > 0, "no pos-arena (pos+table) mixer"
        assert len(meta.mix_cd_ix) > 0, "no ctx-dense mixer"
        assert len(meta.mix_pd_ix) > 0, "no pos-dense mixer"
        assert len(meta.mix_lm_ix) > 0, "no longest_match mixer"


def test_dense_mixer_step_counters_advance():
    """The steps lane of a mixer row is a bitcast u32 counter, a denormal
    float below 2^23. The dense-resident classes (ctx-dense, longest-match)
    select their rows every byte; a backend that flushes denormals to zero
    (XLA:CPU does) must still see the counters grow across bytes."""
    import jax

    from gmix_tpu.core.codec import Predictor, compress_bytes
    from gmix_tpu.core.meta import build_meta

    spec = g.tiny_spec(with_lstm=False)
    meta = build_meta(spec)
    pred = Predictor(spec, 1)
    n = 256
    compress_bytes(TEXT[:n], spec, 1, 128, pred=pred)
    dense = np.asarray(jax.device_get(pred.state["ltm"]["mix_dense"]))
    steps = dense[0, :, meta.mix_step_lane].view(np.uint32)
    # every bit updates exactly one row of each dense-selected table, so a
    # table's counters sum to the number of coded bits
    tables = list(zip(meta.mix_cd_offsets, meta.mix_cd_sizes)) + list(
        zip(meta.mix_lm_offsets, meta.mix_lm_sizes))
    assert any(t > 1 for _, t in tables)
    for off, t in tables:
        assert steps[int(off):int(off) + int(t)].sum() == 8 * n, (off, t)
