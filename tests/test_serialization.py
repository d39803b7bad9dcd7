"""Checkpoint format: sparse encoding + version gating
(reference: sparse/dense table serialization, long-term-memory.cpp:17-28,
92-103) and the two-instantiation bit-step equivalence."""
import os
import zipfile

import jax
import numpy as np
import pytest

import gmix_tpu as g
from gmix_tpu.utils.serialization import (
    CheckpointVersionError,
    load_state,
    save_state,
)


def test_sparse_roundtrip_and_size(tmp_path):
    """A mostly-sentinel state must be stored sparse (much smaller than dense)
    and reconstruct exactly; save . load . save is byte-identical."""
    rng = np.random.RandomState(7)
    big = np.full((4 << 20,), 0x00FF, np.uint16)  # 8 MiB of indirect sentinel
    touched = rng.choice(big.size, 1000, replace=False)
    big[touched] = rng.randint(0, 0xFFFF, 1000).astype(np.uint16)
    state = {
        "ltm": {
            "arena": big.reshape(2, -1),
            "weights": np.zeros((1 << 19,), np.float32),  # 2 MiB of zeros
            "dense": rng.rand(64, 64).astype(np.float32),  # small, stays dense
        },
        "scalar": np.int32(7),
    }
    p1 = os.path.join(tmp_path, "a.gxt")
    save_state(p1, state)
    dense_bytes = big.nbytes + state["ltm"]["weights"].nbytes
    assert os.path.getsize(p1) < dense_bytes // 10, "sparse encoding not applied"
    loaded = load_state(p1)
    for (pa, a), (_, b) in zip(
        jax.tree_util.tree_leaves_with_path(state),
        jax.tree_util.tree_leaves_with_path(loaded),
    ):
        assert np.array_equal(np.asarray(a), b), jax.tree_util.keystr(pa)
        assert np.asarray(a).dtype == b.dtype and np.asarray(a).shape == b.shape
    p2 = os.path.join(tmp_path, "b.gxt")
    save_state(p2, loaded)
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_dense_when_not_sparse(tmp_path):
    """A large array with no dominant value stays dense and roundtrips."""
    rng = np.random.RandomState(3)
    state = {"x": rng.randint(0, 2**31, (1 << 19,), np.int64)}  # 4 MiB, all distinct-ish
    p = os.path.join(tmp_path, "c.gxt")
    save_state(p, state)
    assert os.path.getsize(p) > state["x"].nbytes  # stored dense
    assert np.array_equal(load_state(p)["x"], state["x"])


def test_unversioned_checkpoint_rejected(tmp_path):
    p = os.path.join(tmp_path, "old.gxt")
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("stm/x.npy", b"\x93NUMPY junk")
    with pytest.raises(CheckpointVersionError, match="versioned format"):
        load_state(p)


def test_bit_scan_instantiations_identical():
    """The scanned (CPU default) and unrolled bit sub-step instantiations
    must produce bit-identical streams and state: an archive written by one
    form must decode with the other. Runs eagerly - the unrolled jit
    compile is too slow on small CI hosts."""
    import jax.numpy as jnp

    from gmix_tpu.core.meta import build_meta
    from gmix_tpu.core.step import make_chunk_fn_raw
    from gmix_tpu.state import init_state

    spec = g.tiny_spec(with_lstm=True)
    meta = build_meta(spec)
    chunk = 2 * spec.lstm.horizon  # exercise the deferred-BPTT segment path
    data = np.frombuffer(
        (b"abracadabra, abracadabra! " * 4)[: chunk], np.uint8
    ).reshape(1, -1)

    outs = []
    with jax.disable_jit():
        for bit_scan in (False, True):
            fn = make_chunk_fn_raw(meta, chunk, learn=True, bit_scan=bit_scan)
            st = init_state(meta, 1)
            db = jnp.asarray(data)
            cb = jnp.zeros((1, 4096), jnp.uint8)
            outs.append(fn(st, db, cb, jnp.int32(0), jnp.asarray(False)))
    (st_a, db_a, cb_a, w_a, n_a), (st_b, db_b, cb_b, w_b, n_b) = outs
    assert np.array_equal(np.asarray(w_a), np.asarray(w_b))
    assert np.array_equal(np.asarray(n_a), np.asarray(n_b))
    assert np.array_equal(np.asarray(db_a), np.asarray(db_b))
    for (pa, a), (_, b) in zip(
        jax.tree_util.tree_leaves_with_path(st_a),
        jax.tree_util.tree_leaves_with_path(st_b),
    ):
        assert np.array_equal(np.asarray(a), np.asarray(b)), jax.tree_util.keystr(pa)
