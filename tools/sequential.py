"""S=1 sequential parity measurement on the accelerator.

The reference's basic operating mode is ONE stream with full tables
(reference src/runner/runner-utils.cpp:43-67); its measured bar on
corpus_1m is 1.9627 bpb (data/baseline_measured.json: ref_1m). All previous
quality records are conditioned on equal parallelism (split input); this tool
produces the UNCONDITIONAL comparison: encode + decode the 1 MB corpus as a
single sequential stream and record bpb / timings / roundtrip exactness under
"sequential_s1" in analysis/parity.json (read-modify-write).

`--compile-only` lowers + compiles the full ref-profile S=1 chunk program
and asserts success without running the 1 MB measurement.

Usage:
  python tools/sequential.py [ref|best] [--compile-only]
Env: GMIX_SEQ_BYTES (default 1<<20), GMIX_SEQ_CHUNK (default 4000).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# measurement records (gitignored): read-modify-written, one key per tool
PARITY = os.path.join(REPO, "analysis", "parity.json")


def _corpus(n: int) -> bytes:
    path = os.path.join(REPO, "data", "corpus_1m.bin")
    data = open(path, "rb").read()
    while len(data) < n:
        data += data
    return data[:n]


def _record(profile: str, rec: dict) -> None:
    merged = {}
    if os.path.exists(PARITY):
        try:
            merged = json.load(open(PARITY))
        except Exception:
            merged = {}
    seq = merged.get("sequential_s1")
    if not isinstance(seq, dict):
        seq = {}
    seq[profile] = rec
    merged["sequential_s1"] = seq
    os.makedirs(os.path.dirname(PARITY), exist_ok=True)
    json.dump(merged, open(PARITY, "w"), indent=1)


def _spec(profile: str):
    from gmix_tpu.config import best_spec, reference_spec

    return best_spec() if profile == "best" else reference_spec()


def compile_only(profile: str, chunk: int) -> int:
    """Lower + AOT-compile the full-profile S=1 chunk program; assert success.

    Run under `timeout`, it fails loudly if a step.py change makes the S=1
    compile hang, instead of the regression hiding until the next
    measurement attempt."""
    import jax
    import jax.numpy as jnp

    from gmix_tpu.core.codec import _WORST_PER_BYTE
    from gmix_tpu.core.step import get_chunk_fn

    spec = _spec(profile)
    per = chunk
    cap = int(per + per // 2 + _WORST_PER_BYTE * chunk + 4096)
    fn = get_chunk_fn(spec, chunk, analysis=False)
    from gmix_tpu.core.meta import build_meta
    from gmix_tpu.state import init_state

    meta = build_meta(spec)
    st = jax.eval_shape(lambda: init_state(meta, 1))
    db = jax.ShapeDtypeStruct((1, per), jnp.uint8)
    cb = jax.ShapeDtypeStruct((1, cap), jnp.uint8)
    t0 = time.time()
    lowered = jax.jit(fn).lower(
        st, db, cb, jax.ShapeDtypeStruct((), jnp.int32), jax.ShapeDtypeStruct((), jnp.bool_)
    )
    t_lower = time.time() - t0
    t0 = time.time()
    compiled = lowered.compile()
    t_compile = time.time() - t0
    print(
        f"S=1 {profile} chunk={chunk}: lowered in {t_lower:.1f}s, "
        f"compiled in {t_compile:.1f}s on {jax.devices()[0].platform}",
        flush=True,
    )
    assert compiled is not None
    return 0


def measure(profile: str, n: int, chunk: int) -> int:
    import jax

    from gmix_tpu.core.codec import (
        Predictor,
        compress_bytes,
        decompress_bytes,
        entropy_bits,
    )
    from gmix_tpu.state import state_bytes

    spec = _spec(profile)
    data = _corpus(n)
    rec = {
        "status": "running",
        "corpus_bytes": n,
        "chunk": chunk,
        "streams": 1,
        "ref_bpb_sequential": 1.9627,
    }
    _record(profile, rec)

    def progress(phase, total):
        t_start = time.time()

        def cb(done):
            el = time.time() - t_start
            sys.stderr.write(
                f"\r{profile} {phase}: {100.0*done/total:5.1f}%  "
                f"({done/el/1e3:.2f} KB/s, {el:.0f}s)"
            )
            sys.stderr.flush()

        return cb

    pred = Predictor(spec, 1, analysis=False)
    rec["state_gib"] = round(state_bytes(pred.state) / 2**30, 3)
    t0 = time.time()
    blob = compress_bytes(data, spec, 1, chunk, pred=pred, progress=progress("enc", n))
    t_enc = time.time() - t0
    sys.stderr.write("\n")
    ent = entropy_bits(pred) / n
    del pred
    rec.update(
        status="encoded",
        bpb=round(8 * len(blob) / n, 4),
        model_bpb=round(ent, 4),
        enc_s=round(t_enc, 1),
        enc_mbps=round(n / t_enc / 1e6, 5),
    )
    _record(profile, rec)
    print(f"{profile} S=1 encode: {rec['bpb']} bpb in {t_enc:.0f}s", flush=True)

    pred = Predictor(spec, 1, analysis=False)
    t0 = time.time()
    out = decompress_bytes(blob, spec, chunk, pred=pred, progress=progress("dec", n))
    t_dec = time.time() - t0
    sys.stderr.write("\n")
    del pred
    exact = out == data
    rec.update(
        status="done",
        dec_s=round(t_dec, 1),
        roundtrip_exact=bool(exact),
        encdec_mbps=round(2 * n / (t_enc + t_dec) / 1e6, 5),
        note=(
            "single sequential stream, full tables - the reference's own "
            "operating mode (runner-utils.cpp:43-67); unconditional "
            "comparison vs its 1.9627 bpb sequential bar"
        ),
    )
    _record(profile, rec)
    print(
        f"{profile} S=1: {rec['bpb']} bpb (model {rec['model_bpb']}), "
        f"enc {t_enc:.0f}s dec {t_dec:.0f}s exact={exact}",
        flush=True,
    )
    return 0 if exact else 1


def measure_idle_lane(profile: str, n: int, chunk: int, do_decode: bool) -> int:
    """Sequential measurement via an S=2 program with an IDLE second lane.

    S=1 programs are not yet checked on the GPU (ROADMAP B4), while S>=2
    programs are. Streams are independent, so a
    2-stream program whose second lane carries zero bytes evolves stream 0
    EXACTLY like the sequential reference mode (runner-utils.cpp:43-67);
    only stream 0's payload counts."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from gmix_tpu.core.codec import Predictor, _WORST_PER_BYTE, run_chunks
    from gmix_tpu.ops import coder as coder_ops
    from gmix_tpu.state import state_bytes

    spec = _spec(profile)
    data = _corpus(n)
    per = -(-n // chunk) * chunk
    cap = int(per + per // 2 + _WORST_PER_BYTE * chunk + 4096)
    arr = np.zeros((2, per), np.uint8)
    arr[0, :n] = np.frombuffer(data, np.uint8)
    key = profile + "_idle2"
    rec = {
        "status": "running", "corpus_bytes": n, "chunk": chunk,
        "streams": "2 (lane 1 idle)", "ref_bpb_sequential": 1.9627,
        "note": "S=2 program, idle second lane: stream 0's evolution is "
                "bit-identical to sequential S=1",
    }
    _record(key, rec)

    pred = Predictor(spec, 2, analysis=False)
    rec["state_gib"] = round(state_bytes(pred.state) / 2**30, 3)
    t0 = time.time()
    _, _, bodies = run_chunks(
        pred, jnp.asarray(arr), jnp.zeros((2, cap), jnp.uint8), per,
        decode=False, chunk=chunk,
    )
    coder = jax.device_get(pred.state["coder"])
    tails = coder_ops.flush_bytes(coder["x1"], coder["x2"])
    payload0 = bodies[0] + tails[0]
    payload1 = bodies[1] + tails[1]
    t_enc = time.time() - t0
    ent0 = float(jax.device_get(pred.state["metrics"]["ent"])[0])
    del pred
    rec.update(
        status="encoded",
        bpb=round(8 * len(payload0) / n, 4),
        model_bpb=round(ent0 / n, 4),
        enc_s=round(t_enc, 1),
    )
    _record(key, rec)
    print(f"{profile} idle-lane S=2: {rec['bpb']} bpb in {t_enc:.0f}s", flush=True)
    if not do_decode:
        rec["roundtrip"] = "not run (encode-only; see --decode)"
        _record(key, rec)
        return 0

    pred = Predictor(spec, 2, analysis=False)
    codes = np.zeros((2, cap), np.uint8)
    codes[0, : len(payload0)] = np.frombuffer(payload0, np.uint8)
    codes[1, : len(payload1)] = np.frombuffer(payload1, np.uint8)
    x0 = np.zeros((2,), np.uint32)
    for s in range(2):
        for i in range(4):
            x0[s] = (x0[s] << np.uint32(8)) | np.uint32(codes[s, i])
    st = dict(pred.state)
    st["coder"] = dict(st["coder"])
    st["coder"]["x"] = jnp.asarray(x0)
    st["coder"]["rpos"] = jnp.full((2,), 4, jnp.uint32)
    pred.state = st
    t0 = time.time()
    db, _, _ = run_chunks(
        pred, jnp.zeros((2, per), jnp.uint8), jnp.asarray(codes), per,
        decode=True, chunk=chunk,
    )
    out = np.asarray(jax.device_get(db))[0, :n].tobytes()
    t_dec = time.time() - t0  # device_get blocks: full decode wall time
    exact = out == data
    rec.update(status="done", dec_s=round(t_dec, 1), roundtrip_exact=bool(exact))
    _record(key, rec)
    print(f"{profile} idle-lane: dec {t_dec:.0f}s exact={exact}", flush=True)
    return 0 if exact else 1


def main():
    args = [a for a in sys.argv[1:]]
    co = "--compile-only" in args
    idle = "--idle-lane" in args
    do_decode = "--decode" in args
    args = [a for a in args if not a.startswith("--")]
    profile = args[0] if args else "ref"
    assert profile in ("ref", "best"), profile
    n = int(os.environ.get("GMIX_SEQ_BYTES", 1 << 20))
    chunk = int(os.environ.get("GMIX_SEQ_CHUNK", 4000))
    if co:
        return compile_only(profile, chunk)
    if idle:
        return measure_idle_lane(profile, n, chunk, do_decode)
    return measure(profile, n, chunk)


if __name__ == "__main__":
    sys.exit(main())
