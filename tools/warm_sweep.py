"""Warm-start sweep at the bench operating point.

The bench's throughput point splits the corpus into S short parallel streams;
each stream pays model warmup, which is why its bpb trails the sequential
reference. The reference's own answer is a
pretrained checkpoint loaded by both sides (runner-utils.cpp:95-99) - its
creation is offline. This tool measures HOW MUCH warm-start buys:

  phase 1: pretrain ONE stream over the corpus' first 1 MB, snapshotting the
           model state at 32 KB / 128 KB / 512 KB / 1 MB into /tmp;
  phase 2: for each snapshot, broadcast it to the bench stream count and
           encode the bench corpus, recording bpb (encode-only: exactness is
           bench.py's job).

Results append to analysis/parity.json under "warm_sweep" (read-modify-write).

Usage: python tools/warm_sweep.py [--sizes 32768,131072,524288,1048576]
Env: GMIX_WARM_BENCH_BYTES (default 1<<22), GMIX_WARM_PROFILE (default 11x128),
     GMIX_WARM_CHUNK (default 4000).
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


def _record(entry: dict) -> None:
    merged = {}
    if os.path.exists(PARITY):
        try:
            merged = json.load(open(PARITY))
        except Exception:
            merged = {}
    sweep = merged.get("warm_sweep")
    if not isinstance(sweep, list):
        sweep = []
    sweep = [r for r in sweep if r.get("warm_bytes") != entry.get("warm_bytes")
             or r.get("profile") != entry.get("profile")] + [entry]
    merged["warm_sweep"] = sorted(sweep, key=lambda r: (r.get("profile", ""), r.get("warm_bytes", 0)))
    os.makedirs(os.path.dirname(PARITY), exist_ok=True)
    json.dump(merged, open(PARITY, "w"), indent=1)


def main():
    sizes = [32768, 131072, 524288, 1048576]
    for a in sys.argv[1:]:
        if a.startswith("--sizes"):
            sizes = [int(x) for x in a.split("=", 1)[1].split(",")]
    import jax
    import jax.numpy as jnp

    import bench as bench_mod
    from gmix_tpu.core.codec import Predictor, compress_bytes, entropy_bits
    from gmix_tpu.utils.serialization import save_state, load_state

    prof = os.environ.get("GMIX_WARM_PROFILE", "11x128")
    bits, S = (int(x) for x in prof.split("x"))
    chunk = int(os.environ.get("GMIX_WARM_CHUNK", 4000))
    n_bench = int(os.environ.get("GMIX_WARM_BENCH_BYTES", 1 << 22))
    spec = bench_mod._spec_for(bits)

    # ---- phase 1: one sequential pretrain pass with snapshots. Runs as an
    # S=2 program with an idle second lane (S=1 is not yet checked on the
    # GPU, ROADMAP B4); lane 0 is sliced for the broadcast. ----
    import numpy as np

    data = _corpus(max(sizes))
    pred = Predictor(spec, 2, analysis=False)
    done = 0
    t0 = time.time()
    snap_paths = {}
    for target in sorted(sizes):
        seg = data[done:target]
        seg_n = (len(seg) // chunk) * chunk
        if seg_n:
            # continue the same predictor over the next prefix segment
            from gmix_tpu.core.codec import run_chunks, _WORST_PER_BYTE

            arr = np.zeros((2, seg_n), np.uint8)
            arr[0] = np.frombuffer(seg[:seg_n], np.uint8)
            cap = int(seg_n + seg_n // 2 + _WORST_PER_BYTE * chunk + 4096)
            run_chunks(
                pred, jnp.asarray(arr), jnp.zeros((2, cap), jnp.uint8), seg_n,
                decode=False, chunk=chunk,
            )
            done = target - (len(seg) - seg_n)
        path = f"/tmp/warm_{target}.gxt"
        jax.block_until_ready(pred.state["metrics"]["ent"])
        lane0 = jax.tree_util.tree_map(
            lambda x: x[0:1] if getattr(x, "ndim", 0) >= 1 and x.shape[0] == 2 else x,
            jax.device_get(pred.state),
        )
        save_state(path, lane0)
        snap_paths[target] = (path, done)
        sys.stderr.write(f"warm_sweep: snapshot {done} (~{target}) at {time.time()-t0:.0f}s\n")
    del pred

    # ---- phase 2: bench-point bpb per snapshot ----
    bdata = _corpus(n_bench)
    for target in sorted(sizes):
        path, actual = snap_paths[target]
        host = load_state(path)
        pred = bench_mod._broadcast_warm(host, spec, S)
        t1 = time.time()
        blob = compress_bytes(bdata, spec, S, chunk, pred=pred)
        t_enc = time.time() - t1
        bpb = 8 * len(blob) / n_bench
        model_bpb = entropy_bits(pred) / n_bench
        del pred
        entry = {
            "profile": f"scaled-{bits}x{S}",
            "warm_bytes": target,
            "warm_bytes_actual": actual,
            "bench_bytes": n_bench,
            "chunk": chunk,
            "bpb": round(bpb, 4),
            "model_bpb": round(model_bpb, 4),
            "enc_s": round(t_enc, 1),
            "pretrain_note": "single-stream pretrain over the corpus prefix, "
                             "broadcast to all streams (runner-utils.cpp:95-99)",
        }
        _record(entry)
        print(json.dumps(entry), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
