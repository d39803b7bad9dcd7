"""Multi-host execution: jax.distributed + a global device mesh.

The reference has no communication backend at all (SURVEY.md 2/5 - it is a
single CPU thread); this is the codec's scale-out layer. The model is
unchanged from the single-host case: streams are the data-parallel axis, each
device owns S/n_devices independent codec replicas, and the per-byte scan
contains no cross-stream operation. Multi-host therefore needs exactly three
pieces, all here:

1. `initialize()` - `jax.distributed.initialize` wrapper; the caller passes
   coordinator/num_processes/process_id explicitly.
2. Global-array construction: every process holds only its local shard of the
   state/data/code buffers; `_global_from_callback` builds the jax global
   arrays shard-by-shard (no process ever materialises another host's GBs of
   table state - callbacks produce only addressable shards).
3. Ordered gather of the variable-length per-stream payloads into ONE
   container, byte-identical to the single-process archive: stream payloads
   ride a replicating jit (an all-gather inserted by XLA) and the host
   container writer concatenates them in stream order, generalising the
   reference's 5-byte length framing (src/runner/runner-utils.cpp:22-36).

Compression is deterministic per stream regardless of process count, so an
N-host archive equals the 1-host archive for the same stream count -
asserted by tests/test_multihost.py with 2 spawned processes.
"""
from __future__ import annotations

import struct

import numpy as np


def initialize(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join the distributed runtime. Call before any jax op, with all three
    arguments (coordinator as `host:port`)."""
    import jax

    jax.distributed.initialize(coordinator_address, num_processes, process_id)


def global_mesh(axis: str = "streams"):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def _global_from_callback(mesh, pspec, global_shape, dtype, fill_cb):
    """Build a global array from per-shard callbacks (only addressable shards
    are materialised on this process)."""
    import jax
    from jax.sharding import NamedSharding

    sh = NamedSharding(mesh, pspec)

    def cb(index):
        shard_shape = tuple(
            len(range(*sl.indices(dim))) for sl, dim in zip(index, global_shape)
        )
        return fill_cb(index, shard_shape).astype(dtype, copy=False)

    return jax.make_array_from_callback(tuple(global_shape), sh, cb)


def make_global_state(meta, S: int, mesh, axis: str = "streams", seed=None):
    """Globally-sharded init state: stream-major leaves shard over the mesh,
    scalars replicate. Stream init is uniform (every stream starts from the
    same deterministic state), so each process builds only its local rows."""
    import jax
    from jax.sharding import PartitionSpec as P

    from ..state import DEFAULT_SEED, init_state

    n_dev = mesh.devices.size
    assert S % n_dev == 0, f"streams {S} must divide over {n_dev} devices"
    local_rows = S // n_dev
    # template holding one device-shard's worth of streams (init is uniform
    # across streams, so any shard equals the first local_rows of the init)
    template = jax.device_get(init_state(meta, local_rows, seed or DEFAULT_SEED))

    def build(leaf):
        leaf = np.asarray(leaf)
        if leaf.ndim >= 1 and leaf.shape[0] == local_rows:
            gshape = (S,) + leaf.shape[1:]
            return _global_from_callback(
                mesh, P(axis), gshape, leaf.dtype, lambda i, s, l=leaf: l
            )
        return _global_from_callback(
            mesh, P(), leaf.shape, leaf.dtype, lambda i, s, l=leaf: l
        )

    return jax.tree_util.tree_map(build, template)


def _replicate(mesh, tree):
    """Gather a stream-sharded pytree to every process (an XLA all-gather)
    and return it as host numpy."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    out = jax.jit(lambda x: x, out_shardings=rep)(tree)
    return jax.tree_util.tree_map(lambda x: np.asarray(jax.device_get(x)), out)


def compress_bytes_multihost(
    data: bytes,
    spec,
    num_streams: int,
    chunk: int = 4096,
    axis: str = "streams",
) -> bytes:
    """Full-file compression over every device of every process in the
    distributed runtime. All processes must call this with identical
    arguments (SPMD); every process returns the complete container.

    The archive is byte-identical to `compress_bytes(data, spec,
    num_streams, chunk)` run on a single host: stream semantics do not
    depend on where a stream's lane is placed.
    """
    import jax
    from jax.sharding import PartitionSpec as P

    from ..core.codec import MAGIC, VERSION, _WORST_PER_BYTE, _pad_streams
    from ..core.meta import build_meta
    from ..ops import coder as coder_ops
    from .mesh import make_sharded_chunk_fn

    orig = len(data)
    S = num_streams
    if orig == 0:
        return MAGIC + struct.pack(
            "<BBHQQQQ", VERSION, 0, S, 0, 0, spec.stable_hash(), 0
        )
    meta = build_meta(spec)
    mesh = global_mesh(axis)
    arr, per = _pad_streams(data, S, chunk)
    cap = int(per + per // 2 + _WORST_PER_BYTE * chunk + 4096)

    state = make_global_state(meta, S, mesh, axis)
    data_buf = _global_from_callback(
        mesh, P(axis), (S, per), np.uint8, lambda idx, shape: arr[idx[0]]
    )
    code_buf = _global_from_callback(
        mesh, P(axis), (S, cap), np.uint8, lambda idx, shape: np.zeros(shape, np.uint8)
    )

    from ..core.step import default_bit_scan

    fn = make_sharded_chunk_fn(
        meta, chunk, mesh, S, learn=True, bit_scan=default_bit_scan(), axis=axis
    )
    dec = False
    import jax.numpy as jnp

    decode = jnp.asarray(dec)
    emits = []
    for t in range(0, per, chunk):
        state, data_buf, code_buf, win, nw = fn(
            state, data_buf, code_buf, jnp.int32(t), decode
        )
        emits.append((win, nw))

    # ordered gather: coder registers + per-byte renorm emissions to every
    # host (the code stream leaves the scan as dense (chunk, S, 40) outputs;
    # see codec.run_chunks)
    gathered = _replicate(
        mesh,
        {
            "coder": state["coder"],
            "win": jnp.concatenate([w for w, _ in emits], axis=0),
            "nw": jnp.concatenate([n for _, n in emits], axis=0),
        },
    )
    coder = gathered["coder"]
    win_np, nw_np = gathered["win"], gathered["nw"]
    mask = np.arange(win_np.shape[2])[None, None, :] < nw_np[:, :, None]
    tails = coder_ops.flush_bytes(coder["x1"], coder["x2"])
    payloads = [
        win_np[:, s][mask[:, s]].tobytes() + tails[s] for s in range(S)
    ]
    header = MAGIC + struct.pack(
        "<BBHQQQQ", VERSION, 0, S, orig, per, spec.stable_hash(), 0
    )
    sizes = struct.pack(f"<{S}Q", *[len(p) for p in payloads])
    return header + sizes + b"".join(payloads)
