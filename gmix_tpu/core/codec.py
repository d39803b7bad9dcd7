"""Host-side codec driver: container format, chunked scans, flush, generation.

File-level parallelism model (SURVEY.md 2 "parallelism inventory"): the input
is split into `num_streams` contiguous blocks, each compressed by an
independent model replica (one lane of every batched state array). This is the
gmix-native analogue of sequence parallelism; chips/hosts then shard the
stream axis (gmix_tpu.parallel). Outputs are gathered in order with per-stream
sizes in the header, generalising the reference's 5-byte length framing
(src/runner/runner-utils.cpp:22-36).

Streams are padded to a common length that is a multiple of the scan chunk, so
exactly one compiled program shape covers the whole file and no per-bit
validity masking exists anywhere (padding zeros cost a few output bytes).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EnsembleSpec
from ..ops import coder as coder_ops
from ..state import init_state, state_bytes
from ..utils.serialization import copy_state, load_state, save_state
from .meta import Meta, build_meta
from .step import get_chunk_fn, get_gen_chunk_fn

MAGIC = b"GXTC"
# v2: indirect lane rotation + tag-verified PPM rows changed the model
# evolution, so v1 archives would decode to garbage - the version gate turns
# that into a clean error
# v3: deferred per-bit table writes (core/step.py) change float rounding of
# the state->logit and match-table updates (p+(d1+d2) vs (p+d1)+d2), so v2
# archives are not bit-compatible
# v4: deterministic polynomial transcendentals (ops/sigmoid.py) replace the
# backend exp/log/tanh/pow kernels, making archives invariant to the stream
# batch shape they were coded under (cross-topology portability); the
# rounding differs from v3's libm values
# v5: the LSTM's contractions and reductions and the mixer solve's A@A
# products are fixed-tree sums (core/step.py _tree_sum), and the LSTM's
# rsqrt is 1/sqrt, so no dot or backend approximation is left in the
# archive path; the rounding differs from v4's. The dense-resident mixer
# rows are selected on their bit pattern, so their step counters survive a
# flush-to-zero backend (v4 zeroed them on the CPU)
VERSION = 5
# worst-case output bytes per input byte (4 renorm bytes * 8 bits + slack)
_WORST_PER_BYTE = 33


class Predictor:
    """Owns the batched model state for S streams + compiled chunk programs.

    The reference Predictor (src/predictor.h:20-56) holds ~121 model objects;
    here the ensemble lives in the spec and the state pytree, and this class
    is the lifecycle/checkpoint/compile-cache wrapper.
    """

    def __init__(
        self,
        spec: EnsembleSpec,
        num_streams: int = 1,
        seed: int = 0xDEADBEEF,
        sharding=None,
        analysis: bool = True,
    ):
        self.spec = spec
        self.meta: Meta = build_meta(spec)
        self.num_streams = num_streams
        self.seed = seed
        self.sharding = sharding
        # trace-time choice: analysis=False compiles chunk programs with no
        # per-column entropy-EMA ops (reference: enable_analysis flags)
        self.analysis = analysis
        self._fn_cache: Dict = {}
        self.state = init_state(self.meta, num_streams, seed)
        if sharding is not None:
            self.state = self._place(self.state)

    def _place(self, state):
        from ..parallel.mesh import shard_state

        return shard_state(state, self.sharding.mesh, self._axis())

    def _axis(self) -> str:
        return self.sharding.spec[0]

    def chunk_fn(self, n: int, learn: bool = True):
        if self.sharding is None:
            return get_chunk_fn(self.spec, n, learn, self.analysis)
        # sharded execution must go through shard_map (see
        # parallel.mesh.make_sharded_chunk_fn for why plain jit is wrong)
        key = ("chunk", n, learn)
        if key not in self._fn_cache:
            from ..parallel.mesh import make_sharded_chunk_fn
            from .step import default_bit_scan

            self._fn_cache[key] = make_sharded_chunk_fn(
                self.meta, n, self.sharding.mesh, self.num_streams,
                learn, default_bit_scan(), self._axis(),
            )
        return self._fn_cache[key]

    def gen_fn(self, n: int):
        if self.sharding is None:
            return get_gen_chunk_fn(self.spec, n)
        key = ("gen", n)
        if key not in self._fn_cache:
            from ..parallel.mesh import make_sharded_gen_fn
            from .step import default_bit_scan

            self._fn_cache[key] = make_sharded_gen_fn(
                self.meta, n, self.sharding.mesh, self.num_streams,
                default_bit_scan(), self._axis(),
            )
        return self._fn_cache[key]

    # --- checkpoint / copy (contract: tester.cpp invariants 2-3) ---
    def save(self, path: str) -> None:
        save_state(path, self.state)

    def load(self, path: str) -> None:
        loaded = load_state(path)
        # shape-check against current state to catch spec mismatches early
        cur = jax.tree_util.tree_leaves(self.state)
        new = jax.tree_util.tree_leaves(loaded)
        assert len(cur) == len(new), "checkpoint does not match spec"
        for a, b in zip(cur, new):
            assert a.shape == b.shape and a.dtype == b.dtype, (
                f"checkpoint mismatch: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}"
            )
        loaded = jax.tree_util.tree_map(jnp.asarray, loaded)
        self.state = self._place(loaded) if self.sharding else loaded

    def copy(self) -> "Predictor":
        p = object.__new__(Predictor)
        p.spec, p.meta, p.num_streams, p.seed = self.spec, self.meta, self.num_streams, self.seed
        p.sharding = self.sharding
        p.analysis = self.analysis
        p._fn_cache = self._fn_cache
        p.state = copy_state(self.state)
        return p

    def memory_bytes(self) -> int:
        return state_bytes(self.state)


@dataclass
class CodecResult:
    payloads: list  # list[bytes] per stream
    entropy_bits: float  # total cross-entropy over all coded bits


def _pad_streams(data: bytes, num_streams: int, chunk: int):
    orig = len(data)
    per = -(-max(orig, 1) // num_streams)  # ceil, >=1
    per = -(-per // chunk) * chunk  # round up to chunk multiple
    arr = np.zeros((num_streams, per), np.uint8)
    flat = np.frombuffer(data, np.uint8)
    for s in range(num_streams):
        seg = flat[s * per : (s + 1) * per]
        arr[s, : len(seg)] = seg
    return arr, per


def _compact_emits(emits, S: int):
    """Assemble per-stream code bytes from the per-chunk (win, nw) scan
    outputs: stream s's bytes are the concatenation over input bytes t of
    win[t, s, :nw[t, s]]."""
    outs = [[] for _ in range(S)]
    for win_d, nw_d in emits:
        win = np.asarray(jax.device_get(win_d))  # (chunk, S, 40) u8
        nw = np.asarray(jax.device_get(nw_d))  # (chunk, S) u8
        mask = np.arange(win.shape[2])[None, None, :] < nw[:, :, None]
        for s in range(S):
            outs[s].append(win[:, s][mask[:, s]].tobytes())
    return [b"".join(o) for o in outs]


def run_chunks(
    pred: Predictor,
    data_buf,
    code_buf,
    n_bytes: int,
    decode: bool,
    learn: bool = True,
    t0: int = 0,
    chunk: int = 4096,
    progress=None,
):
    """Drive the jitted chunk program over [t0, t0+n_bytes). Buffers stay on
    device across chunks; returns (data_buf, code_buf, payloads) where
    payloads is the list of per-stream code bytes emitted by THIS call
    (encode; empty byte strings for decode). The encoder's renorm bytes leave
    the device as dense per-byte scan outputs and are compacted on the host
    (no per-byte element scatter into code_buf inside the scan)."""
    assert n_bytes % chunk == 0, "n_bytes must be a chunk multiple"
    fn = pred.chunk_fn(chunk, learn=learn)
    dec = jnp.asarray(bool(decode))
    S = data_buf.shape[0]
    emits = []
    for t in range(t0, t0 + n_bytes, chunk):
        pred.state, data_buf, code_buf, win, nw = fn(
            pred.state, data_buf, code_buf, jnp.int32(t), dec
        )
        if not decode:
            emits.append((win, nw))
        if progress is not None:
            progress(t + chunk)
    payloads = _compact_emits(emits, S) if not decode else [b""] * S
    return data_buf, code_buf, payloads


def compress_bytes(
    data: bytes,
    spec: EnsembleSpec,
    num_streams: int = 1,
    chunk: int = 4096,
    pred: Optional[Predictor] = None,
    progress=None,
) -> bytes:
    """Full-file compression into the GXTC container."""
    orig = len(data)
    if orig == 0:
        return MAGIC + struct.pack("<BBHQQQQ", VERSION, 0, num_streams, 0, 0, spec.stable_hash(), 0)
    arr, per = _pad_streams(data, num_streams, chunk)
    S = num_streams
    if pred is None:
        pred = Predictor(spec, S)
    cap = int(per + per // 2 + _WORST_PER_BYTE * chunk + 4096)
    data_buf = jnp.asarray(arr)
    code_buf = jnp.zeros((S, cap), jnp.uint8)
    if pred.sharding is not None:
        data_buf = jax.device_put(data_buf, pred.sharding)
        code_buf = jax.device_put(code_buf, pred.sharding)
    data_buf, code_buf, bodies = run_chunks(
        pred, data_buf, code_buf, per, decode=False, chunk=chunk, progress=progress
    )
    coder = jax.device_get(pred.state["coder"])
    tails = coder_ops.flush_bytes(coder["x1"], coder["x2"])
    for s in range(S):
        assert len(bodies[s]) == int(coder["wpos"][s]), (
            "emitted byte count disagrees with the coder's write cursor"
        )
    payloads = [bodies[s] + tails[s] for s in range(S)]
    header = MAGIC + struct.pack(
        "<BBHQQQQ", VERSION, 0, S, orig, per, spec.stable_hash(), 0
    )
    sizes = struct.pack(f"<{S}Q", *[len(p) for p in payloads])
    return header + sizes + b"".join(payloads)


def decompress_bytes(
    blob: bytes,
    spec: EnsembleSpec,
    chunk: int = 4096,
    pred: Optional[Predictor] = None,
    progress=None,
) -> bytes:
    if len(blob) < 40 or blob[:4] != MAGIC:
        raise ValueError("not a GXTC archive (bad magic or truncated header)")
    ver, _flags, S, orig, per, spec_hash, _rsv = struct.unpack("<BBHQQQQ", blob[4:40])
    if ver != VERSION:
        raise ValueError(f"unsupported GXTC container version {ver}")
    if spec_hash != spec.stable_hash():
        raise ValueError("spec mismatch: wrong profile for this archive")
    if orig == 0:
        return b""
    # container sanity: every size/offset must be provable from the blob itself
    # before any allocation is sized from it (a malformed container must raise,
    # not drive multi-GB allocations)
    if S == 0 or per == 0 or per % chunk != 0:
        raise ValueError(f"malformed GXTC header: streams={S} per={per} chunk={chunk}")
    if orig > S * per:
        raise ValueError(f"malformed GXTC header: orig {orig} > streams*per {S * per}")
    off = 40
    if len(blob) < off + 8 * S:
        raise ValueError("truncated GXTC size table")
    sizes = struct.unpack(f"<{S}Q", blob[off : off + 8 * S])
    off += 8 * S
    if sum(sizes) != len(blob) - off:
        raise ValueError(
            f"malformed GXTC size table: payloads claim {sum(sizes)} bytes, "
            f"{len(blob) - off} present"
        )
    payloads = []
    for sz in sizes:
        payloads.append(blob[off : off + sz])
        off += sz
    # SAME capacity formula as compress_bytes: encode and decode then share one
    # compiled program shape (and one persistent-cache entry)
    cap = int(per + per // 2 + _WORST_PER_BYTE * chunk + 4096)
    if max(sizes) + 8 > cap:
        raise ValueError(
            f"malformed GXTC payload: stream size {max(sizes)} exceeds the "
            f"coder's worst-case bound {cap - 8} for per={per}"
        )
    if pred is None:
        pred = Predictor(spec, S)
    codes = np.zeros((S, cap), np.uint8)
    for s, p in enumerate(payloads):
        codes[s, : len(p)] = np.frombuffer(p, np.uint8)
    # prime the decoder window with the first 4 code bytes (decoder.cpp:5-8)
    x0 = np.zeros((S,), np.uint32)
    for s in range(S):
        for i in range(4):
            x0[s] = (x0[s] << np.uint32(8)) | np.uint32(codes[s, i] if i < cap else 0)
    st = pred.state
    st = dict(st)
    st["coder"] = dict(st["coder"])
    st["coder"]["x"] = jnp.asarray(x0)
    st["coder"]["rpos"] = jnp.full((S,), 4, jnp.uint32)
    pred.state = st
    data_buf = jnp.zeros((S, per), jnp.uint8)
    code_buf = jnp.asarray(codes)
    if pred.sharding is not None:
        data_buf = jax.device_put(data_buf, pred.sharding)
        code_buf = jax.device_put(code_buf, pred.sharding)
    data_buf, code_buf, _ = run_chunks(
        pred, data_buf, code_buf, per, decode=True, chunk=chunk, progress=progress
    )
    out = np.asarray(jax.device_get(data_buf)).reshape(-1)[:orig]
    return out.tobytes()


def generate_bytes(
    pred: Predictor,
    prompt: bytes,
    out_size: int,
    temperature: float = 1.0,
    chunk: int = 256,
    seed: int = 1234,
    progress=None,
    return_all: bool = False,
):
    """Learning-disabled temperature sampling (runner-utils.cpp:158-221).

    The prompt is replayed WITH learning (the reference learns during the
    prompt, runner-utils.cpp:187-194); sampling then runs with every Learn
    gated off, so long-term memory is provably frozen (tester invariant 5).

    The replay buffer is padded at the FRONT to a chunk multiple, so the
    prompt's last byte sits exactly at the boundary where sampling starts:
    the model's recency state (recent bytes, contexts, match pointers) at the
    first sampled byte reflects the true prompt tail, not padding. (Leading
    zero-padding perturbs only the cold-start phase of the replay; this is
    the documented deviation from the reference's exact-length replay.)

    Batched: generates num_streams independent samples. Returns stream 0's
    bytes, or all streams' as a list with return_all=True.
    """
    S = pred.num_streams
    temperature = max(temperature, 0.001)
    # --- prompt replay (encode mode, learning on; code output discarded) ---
    if prompt:
        per = -(-len(prompt) // chunk) * chunk
        arr = np.zeros((1, per), np.uint8)
        arr[0, per - len(prompt):] = np.frombuffer(prompt, np.uint8)
        arr = np.broadcast_to(arr, (S, per)).copy()
        cap = int(per * 2 + _WORST_PER_BYTE * chunk + 4096)
        data_buf = jnp.asarray(arr)
        code_buf = jnp.zeros((S, cap), jnp.uint8)
        run_chunks(pred, data_buf, code_buf, per, decode=False, chunk=chunk)
        t0 = per
    else:
        t0 = 0
    # --- sampling ---
    n = -(-out_size // chunk) * chunk
    fn = pred.gen_fn(chunk)
    data_buf = jnp.zeros((S, t0 + n), jnp.uint8)
    key = jax.random.PRNGKey(seed)
    inv_temp = jnp.float32(1.0 / temperature)
    for t in range(t0, t0 + n, chunk):
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, (chunk * 8, S), jnp.float32)
        pred.state, data_buf = fn(pred.state, data_buf, jnp.int32(t), u, inv_temp)
        if progress is not None:
            progress(t - t0 + chunk)
    out = np.asarray(jax.device_get(data_buf))
    if return_all:
        return [out[s, t0 : t0 + out_size].tobytes() for s in range(S)]
    return out[0, t0 : t0 + out_size].tobytes()


def entropy_bits(pred: Predictor) -> float:
    return float(np.sum(jax.device_get(pred.state["metrics"]["ent"])))


def analysis_columns(spec: EnsembleSpec):
    from .meta import analysis_names

    return analysis_names(spec)


def analysis_snapshot(pred: Predictor) -> np.ndarray:
    """(S, C) per-column entropy EMA in bits (reference: analysis/entropy.tsv,
    predictor.cpp:471-503)."""
    return np.asarray(jax.device_get(pred.state["metrics"]["ema"]))


def memory_report(pred: Predictor):
    """(component, bytes) rows (reference: analysis/memory.tsv via
    Model::GetMemoryUsage, predictor.cpp:488-503). Dense allocation makes the
    sizes static per spec."""
    rows = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(pred.state):
        rows.append((jax.tree_util.keystr(path), leaf.size * leaf.dtype.itemsize))
    return rows
