"""Multi-device execution: data-parallel stream sharding over a jax Mesh.

The reference is single-threaded (SURVEY.md 2, parallelism inventory); the
codec's scaling axis is the stream dimension: every state array, the data
buffer, and the code buffer carry streams on axis 0, and the per-byte scan has
no cross-stream operations, so sharding axis 0 over a mesh makes the whole
codec embarrassingly data-parallel - XLA inserts zero collectives in the scan.
Collectives appear only at the edges: broadcast of pretrained weights
(replicate -> tile) and the ordered gather of per-stream outputs (device_get),
mirroring the reference's 5-byte-header framing (runner-utils.cpp:22-36).

Multi-host: the same mesh spans hosts via jax.distributed; per-host shards are
gathered in stream order by the container writer.
"""
from __future__ import annotations

import re
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "streams") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def stream_sharding(mesh: Mesh, axis: str = "streams") -> NamedSharding:
    """Shard axis 0 (streams) of every array; scalars replicate."""
    return NamedSharding(mesh, P(axis))


def shard_state(state, mesh: Mesh, axis: str = "streams"):
    """Place a state pytree on the mesh: stream-major arrays sharded on axis 0,
    scalar leaves (LSTM epoch counters) replicated."""
    sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def place(x):
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] % mesh.devices.size == 0:
            return jax.device_put(x, sh)
        return jax.device_put(x, rep)

    return jax.tree_util.tree_map(place, state)


def _state_specs(meta, S: int, axis: str):
    """Per-leaf PartitionSpecs for a codec state pytree: stream-major arrays
    shard on axis 0, scalar leaves (LSTM epoch counters) replicate."""
    import jax.numpy as jnp  # noqa: F401  (needed for eval_shape tracing)

    from ..state import init_state

    shaped = jax.eval_shape(lambda: init_state(meta, S))
    return jax.tree_util.tree_map(
        lambda x: P(axis) if x.ndim >= 1 and x.shape[0] == S else P(), shaped
    )


def collectives(compiled) -> list:
    """Names of the cross-device collectives in a compiled program. The
    stream-sharded chunk program must hold none: any would mean the
    partitioner inserted cross-stream communication into the per-byte scan."""
    return sorted(set(re.findall(
        r"all-reduce|all-gather|collective-permute|reduce-scatter|all-to-all",
        compiled.as_text(),
    )))


def make_sharded_chunk_fn(
    meta, chunk: int, mesh: Mesh, S: int,
    learn: bool = True, bit_scan: bool = False, axis: str = "streams",
):
    """Data-parallel chunk processor: shard_map of the per-shard program over
    the stream axis.

    This MUST be shard_map, not plain jit-with-sharded-inputs: feeding the
    jitted chunk fn stream-sharded arrays makes XLA's SPMD partitioner keep
    GLOBAL stream indices against LOCAL operand shards in the batched row
    scatters, whose out-of-bounds writes are silently dropped — mixer/indirect
    learning never persisted on 7 of 8 shards (caught by
    tests/test_parallel.py::test_sharded_matches_unsharded once it became a
    hard assertion). With shard_map each shard runs the unsharded program on
    its local block, which is also the strongest determinism statement
    available: identical per-shard programs => identical bytes.
    """
    from ..core.step import make_chunk_fn_raw

    raw = make_chunk_fn_raw(meta, chunk, learn, bit_scan)
    st_specs = _state_specs(meta, S, axis)
    fn = jax.shard_map(
        raw,
        mesh=mesh,
        in_specs=(st_specs, P(axis), P(axis), P(), P()),
        # (state, data, code, win, nw): the coder scan outputs carry the
        # stream axis second (chunk-major)
        out_specs=(st_specs, P(axis), P(axis), P(None, axis), P(None, axis)),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0, 1, 2))


def make_sharded_gen_fn(
    meta, chunk: int, mesh: Mesh, S: int, bit_scan: bool = False, axis: str = "streams"
):
    """shard_map'd generation chunk (see make_sharded_chunk_fn)."""
    from ..core.step import make_gen_chunk_fn_raw

    raw = make_gen_chunk_fn_raw(meta, chunk, bit_scan)
    st_specs = _state_specs(meta, S, axis)
    fn = jax.shard_map(
        raw,
        mesh=mesh,
        in_specs=(st_specs, P(axis), P(), P(None, axis), P()),
        out_specs=(st_specs, P(axis)),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0, 1))


def broadcast_pretrained(single_stream_state, num_streams: int, mesh: Optional[Mesh] = None):
    """Tile a 1-stream checkpoint's state to S streams (the 'broadcast
    pretrained weights' path for block-parallel compression). Scalar leaves
    pass through."""
    import jax.numpy as jnp

    def tile(x):
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] == 1:
            return jnp.broadcast_to(x, (num_streams,) + x.shape[1:]).copy()
        return x

    out = jax.tree_util.tree_map(tile, single_stream_state)
    if mesh is not None:
        out = shard_state(out, mesh)
    return out
