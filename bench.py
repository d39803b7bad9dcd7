"""Throughput benchmark: encode+decode at roundtrip-exactness on the
accelerator. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "MB/s", "vs_baseline": N}

Baseline = the reference gmix binary (single CPU core, measured locally and
recorded in data/baseline_measured.json by tools/measure_reference.py; the
upstream publishes no numbers - BASELINE.md).

- exactly ONE model state is live at any time;
- each (profile, streams) configuration runs in its own child process (the
  parent never opens the device), walking down a fallback ladder only when a
  child runs out of device memory;
- the scan chunk is a multiple of the LSTM horizon (100) so the deferred-BPTT
  program is used.

Environment knobs:
  GMIX_BENCH_BYTES    corpus size          (default 4194304)
  GMIX_BENCH_WARM     pretrain-prefix bytes for the broadcast warm-start
                      checkpoint (default 131072; 0 disables)
  GMIX_BENCH_CHUNK    scan chunk bytes     (default 4000)
  GMIX_BENCH_PROFILE  "scaled-<B>x<S>" ladder override, e.g. "scaled-14x16"
"""
import json
import os
import sys
import time

# (profile_bits, streams) ladder, first entry first: streams are the
# designed throughput axis (SURVEY.md 7). The operating point on the H100 is
# not measured yet (ROADMAP A3).
LADDER = [(11, 128), (11, 64), (10, 128), (10, 64), (10, 16), (8, 8)]


def _corpus(n: int) -> bytes:
    path = os.path.join(os.path.dirname(__file__), "data", "corpus_1m.bin")
    data = open(path, "rb").read()
    while len(data) < n:
        data += data
    return data[:n]


def _spec_for(bits: int):
    import dataclasses

    from gmix_tpu.config import ApmStage, reference_spec, scale_tables

    spec = reference_spec()
    # the two SSE/APM stages from the measured-best quality config
    # (config.best_spec): ~2 extra arena rows per byte for -0.015 bpb at x4
    spec = dataclasses.replace(
        spec,
        apm=(
            ApmStage("apm_lb", "last_byte", 8, lr=0.010, weight=0.50),
            ApmStage("apm_h2", "h2", 16, lr=0.010, weight=0.25),
        ),
    )
    return scale_tables(spec, bits, history_bits=min(24, bits + 4))


def _pretrain_host_state(spec, warm_bytes: int, chunk: int):
    """Pretrain ONE stream on the corpus' first warm_bytes and return its
    state as HOST numpy (so broadcasting to S streams for encode and again
    for decode never holds two full S-stream states on the chip). This is
    the reference's pretrained-checkpoint flow (runner-utils.cpp:95-99):
    the checkpoint is an input to both sides, its creation is offline.

    Runs as an S=2 program with an IDLE second lane and slices stream 0
    (lane 0 evolves bit-identically to the sequential mode, since streams
    are independent); S=1 programs are not yet checked on the GPU
    (ROADMAP B4)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gmix_tpu.core.codec import Predictor, _WORST_PER_BYTE, run_chunks

    data = _corpus(warm_bytes)
    wchunk = min(chunk, 1000)
    wb = (warm_bytes // wchunk) * wchunk
    pred = Predictor(spec, 2, analysis=False)
    arr = np.zeros((2, wb), np.uint8)
    arr[0] = np.frombuffer(data[:wb], np.uint8)
    cap = int(wb + wb // 2 + _WORST_PER_BYTE * wchunk + 4096)
    run_chunks(
        pred, jnp.asarray(arr), jnp.zeros((2, cap), jnp.uint8), wb,
        decode=False, chunk=wchunk,
    )
    host = jax.device_get(pred.state)
    del pred
    # slice lane 0 (scalar leaves like the LSTM epoch pass through)
    return jax.tree_util.tree_map(
        lambda x: x[0:1] if getattr(x, "ndim", 0) >= 1 and x.shape[0] == 2 else x,
        host,
    )


def _broadcast_warm(host_state, spec, S: int):
    import jax
    import jax.numpy as jnp

    from gmix_tpu.core.codec import Predictor
    from gmix_tpu.core.meta import build_meta
    from gmix_tpu.parallel.mesh import broadcast_pretrained
    from gmix_tpu.state import init_state

    pred = Predictor.__new__(Predictor)
    pred.spec, pred.meta = spec, build_meta(spec)
    pred.num_streams, pred.seed = S, 0xDEADBEEF
    pred.sharding, pred.analysis, pred._fn_cache = None, False, {}
    st = broadcast_pretrained(
        jax.tree_util.tree_map(jnp.asarray, host_state), S
    )
    # stream-fresh coder registers and metrics; model state stays warm
    fresh = init_state(pred.meta, S)
    st = dict(st)
    st["coder"] = fresh["coder"]
    st["metrics"] = fresh["metrics"]
    pred.state = st
    return pred


def _run_once(spec, S: int, chunk: int, data: bytes, warm_bytes: int = 0):
    """One full encode+decode cycle; at most one S-stream state live at a
    time. Returns (mbps, bpb, model_bpb, exact, t_enc, t_dec, blob_len,
    t_warm)."""
    import jax
    import jax.numpy as jnp

    from gmix_tpu.core.codec import (
        Predictor,
        _WORST_PER_BYTE,
        compress_bytes,
        decompress_bytes,
        entropy_bits,
    )
    from gmix_tpu.core.step import get_chunk_fn

    n = len(data)
    per = -(-(-(-n // S)) // chunk) * chunk  # ceil(n/S) up to a chunk multiple
    per = max(per, chunk)
    cap = int(per + per // 2 + _WORST_PER_BYTE * chunk + 4096)

    # warm-up: compile the exact program shape on one chunk of zeros
    from gmix_tpu.core.meta import build_meta
    from gmix_tpu.state import init_state

    meta = build_meta(spec)
    fn = get_chunk_fn(spec, chunk, analysis=False)
    st = init_state(meta, S)
    db = jnp.zeros((S, per), jnp.uint8)
    cb = jnp.zeros((S, cap), jnp.uint8)
    st, db, cb, _w, _n = fn(st, db, cb, jnp.int32(0), jnp.asarray(False))
    jax.block_until_ready(st["metrics"]["ent"])
    del st, db, cb

    t_warm = 0.0
    warm_host = None
    if warm_bytes:
        t0 = time.time()
        warm_host = _pretrain_host_state(spec, warm_bytes, chunk)
        t_warm = time.time() - t0

    # Each direction is measured GMIX_BENCH_PASSES times (default 2) and the
    # minimum wall time reported; every pass is a full real encode or decode
    # and every decode must be exact.
    passes = max(1, int(os.environ.get("GMIX_BENCH_PASSES", 2)))

    def fresh_pred():
        return (
            _broadcast_warm(warm_host, spec, S)
            if warm_host is not None
            else Predictor(spec, S, analysis=False)
        )

    t_enc = t_dec = None
    blob, ent = None, 0.0
    for _ in range(passes):
        pred = fresh_pred()
        t0 = time.time()
        b = compress_bytes(data, spec, S, chunk, pred=pred)
        t = time.time() - t0
        assert blob is None or b == blob  # deterministic across passes
        blob = b
        sys.stderr.write(f"bench: enc pass {t:.1f}s\n")
        t_enc = t if t_enc is None else min(t_enc, t)
        ent = entropy_bits(pred) / n
        del pred

    exact = True
    for _ in range(passes):
        pred = fresh_pred()
        t0 = time.time()
        out = decompress_bytes(blob, spec, chunk, pred=pred)
        t = time.time() - t0
        sys.stderr.write(f"bench: dec pass {t:.1f}s\n")
        t_dec = t if t_dec is None else min(t_dec, t)
        del pred
        exact = exact and (out == data)
    mbps = 2 * n / (t_enc + t_dec) / 1e6
    return mbps, 8 * len(blob) / n, ent, exact, t_enc, t_dec, len(blob), t_warm


_OOM_KEYS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory", "OOM")


def child_main(bits: int, S: int) -> int:
    """Run ONE ladder config in this (sub)process and print a result line.
    Each attempt lives in its own process, so a failed one leaves no device
    memory or client state behind."""
    n = int(os.environ.get("GMIX_BENCH_BYTES", 1 << 22))
    chunk = int(os.environ.get("GMIX_BENCH_CHUNK", 4000))
    warm = int(os.environ.get("GMIX_BENCH_WARM", 1 << 17))
    data = _corpus(n)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":  # a timing off the GPU measures nothing users run
        print(f"CHILD_ERROR no GPU: JAX's first device is {dev.platform}", flush=True)
        return 1
    try:
        mbps, bpb, model_bpb, exact, t_enc, t_dec, blob_len, t_warm = _run_once(
            _spec_for(bits), S, chunk, data, warm_bytes=warm
        )
        print("CHILD_RESULT " + json.dumps({
            "mbps": mbps, "bpb": bpb, "model_bpb": model_bpb, "exact": exact,
            "t_enc": t_enc, "t_dec": t_dec, "blob_len": blob_len,
            "warm_bytes": warm, "t_warm": t_warm,
        }), flush=True)
        return 0
    except Exception as e:
        print("CHILD_ERROR " + f"{type(e).__name__}: {e}"[:800], flush=True)
        return 1


def main():
    child = os.environ.get("GMIX_BENCH_CHILD")
    if child:
        bits, S = child.split("x")
        return child_main(int(bits), int(S))

    import subprocess

    n = int(os.environ.get("GMIX_BENCH_BYTES", 1 << 22))
    chunk = int(os.environ.get("GMIX_BENCH_CHUNK", 4000))
    sys.stderr.write(f"bench: {n} bytes, chunk {chunk}\n")

    ladder = list(LADDER)
    prof = os.environ.get("GMIX_BENCH_PROFILE")
    if prof:  # e.g. "scaled-14x16": pin the ladder head
        bits, streams = prof.replace("scaled-", "").split("x")
        ladder.insert(0, (int(bits), int(streams)))

    result = None
    silent_deaths = 0
    for bits, S in ladder:
        for attempt in range(2):
            sys.stderr.write(f"bench: trying scaled-{bits}x{S} (attempt {attempt + 1})\n")
            try:
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__)],
                    env={**os.environ, "GMIX_BENCH_CHILD": f"{bits}x{S}"},
                    stdout=subprocess.PIPE, stderr=sys.stderr,
                    timeout=int(os.environ.get("GMIX_BENCH_ATTEMPT_TIMEOUT", 3000)),
                )
                out = proc.stdout.decode(errors="replace")
            except subprocess.TimeoutExpired:
                sys.stderr.write(f"bench: scaled-{bits}x{S} attempt timed out\n")
                continue
            res_line = [l for l in out.splitlines() if l.startswith("CHILD_RESULT ")]
            err_line = [l for l in out.splitlines() if l.startswith("CHILD_ERROR ")]
            if res_line:
                r = json.loads(res_line[-1][len("CHILD_RESULT "):])
                result = r
                break
            msg = (err_line[-1][len("CHILD_ERROR "):] if err_line
                   else f"child died without a message (returncode {proc.returncode})")
            # Downgrade ONLY on running out of device memory; any other
            # failure must surface, not be retried away.
            if err_line and not any(k in msg for k in _OOM_KEYS):
                raise RuntimeError(f"bench child failed: {msg}")
            if not err_line:
                silent_deaths += 1
                if silent_deaths >= 3:
                    # repeated messageless deaths (segfault/OOM-kill) across
                    # configs point at a native bug, not capacity - surface it
                    raise RuntimeError(
                        f"bench: {silent_deaths} consecutive messageless child "
                        f"deaths (last returncode {proc.returncode})"
                    )
            sys.stderr.write(f"bench: scaled-{bits}x{S} failed: {msg[:500]}\n")
        if result is not None:
            break
    if result is None:
        print(json.dumps({"metric": "corpus encode+decode MB/s (ALL CONFIGS FAILED)",
                          "value": 0.0, "unit": "MB/s", "vs_baseline": 0.0}))
        return 1

    mbps, bpb, model_bpb, exact = (result["mbps"], result["bpb"],
                                   result["model_bpb"], result["exact"])
    t_enc, t_dec, blob_len = result["t_enc"], result["t_dec"], result["blob_len"]
    base_path = os.path.join(os.path.dirname(__file__), "data", "baseline_measured.json")
    vs = 0.0
    if os.path.exists(base_path):
        base = json.load(open(base_path))
        ref_mbps = base.get("ref_encdec_mbps", 0.0)
        if ref_mbps > 0:
            vs = mbps / ref_mbps

    sys.stderr.write(
        f"bench: {n} -> {blob_len} bytes ({bpb:.4f} bpb, model {model_bpb:.4f} bpb), "
        f"enc {t_enc:.1f}s dec {t_dec:.1f}s, exact={exact}\n"
    )

    if not exact:
        print(json.dumps({"metric": "corpus encode+decode MB/s (ROUNDTRIP FAILED)",
                          "value": 0.0, "unit": "MB/s", "vs_baseline": 0.0}))
        return 1
    print(json.dumps({
        "metric": f"corpus-{n >> 20}M encode+decode MB/s per chip (scaled-{bits}, {S} streams)",
        "value": round(mbps, 4),
        "unit": "MB/s",
        "vs_baseline": round(vs, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
