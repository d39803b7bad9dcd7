"""Throughput-frontier ladder: measured (encode MB/s, bpb) for trimmed
ensembles at the bench operating point.

The bench metric is MB/s at <= 2.1 bpb, so the
ensemble composition at the THROUGHPUT point is an operating-point choice,
not fixed wiring: dropping models buys per-byte latency (fewer scattered
rows + less vector work) at a measured bpb cost, and the warm-start lever
(tools/warm_sweep.py) buys bpb back for free at bench time. This tool
measures the frontier so the headline bench config is chosen from data.

Variants (all on top of bench._spec_for's scaled profile + APM stages):
  base           unmodified
  no4sel         drop the 4 four-byte-selector skip indirects (sparse, the
                 weakest columns of the entropy-EMA table)
  noskipind      drop all 15 skip-pattern indirect models (their contexts
                 stay: mixers gate on them)
  noih           drop the 9 double-indirect models (their IndirectHash
                 contexts stay: mix0_4 gates on ih_3_24_1)
  nolstm         drop the LSTM (removes the per-byte forward + BPTT)
  noskipind-noih combined
  lean           noskipind + noih + nolstm
Usage:
  python tools/fast_ladder.py VARIANT[@BITSxS] ...
Env: GMIX_FAST_BYTES (default 1<<22), GMIX_FAST_CHUNK (4000),
     GMIX_FAST_WARM (default 131072) - pretrain prefix for the broadcast
     warm start (offline, excluded from MB/s).
Results append to analysis/parity.json under "fast_ladder".
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# measurement records (gitignored): read-modify-written, one key per tool
PARITY = os.path.join(REPO, "analysis", "parity.json")


def _record(entry: dict) -> None:
    merged = {}
    if os.path.exists(PARITY):
        try:
            merged = json.load(open(PARITY))
        except Exception:
            merged = {}
    lad = merged.get("fast_ladder")
    if not isinstance(lad, list):
        lad = []
    key = (entry.get("variant"), entry.get("profile"))
    lad = [r for r in lad if (r.get("variant"), r.get("profile")) != key] + [entry]
    merged["fast_ladder"] = lad
    os.makedirs(os.path.dirname(PARITY), exist_ok=True)
    json.dump(merged, open(PARITY, "w"), indent=1)


def trim_spec(spec, variant: str):
    drop_names = set()
    if variant in ("no4sel",):
        drop_names = {"ind_skip_1_2_3_4", "ind_skip_0_2_3_4", "ind_skip_0_1_3_4",
                      "ind_skip_0_1_2_4"}
    elif variant in ("noskipind", "noskipind-noih", "lean"):
        drop_names = {m.name for m in spec.indirects if m.name.startswith("ind_skip_")}
    if variant in ("noih", "noskipind-noih", "lean"):
        drop_names |= {m.name for m in spec.indirects if m.name.startswith("ind_ih_")}
    out = spec
    if drop_names:
        out = dataclasses.replace(
            out, indirects=tuple(m for m in out.indirects if m.name not in drop_names)
        )
    if variant in ("nolstm", "lean"):
        out = dataclasses.replace(out, lstm=None)
        # the lstm_ctx context no longer exists: drop models/mixers gated on it
        out = dataclasses.replace(
            out,
            indirects=tuple(m for m in out.indirects if m.ctx != "lstm_ctx"),
            mixers=tuple(m for m in out.mixers if m.ctx != "lstm_ctx"),
        )
    out.validate()
    return out


def main():
    import jax

    import bench as bench_mod
    from gmix_tpu.core.codec import Predictor, compress_bytes, entropy_bits

    n = int(os.environ.get("GMIX_FAST_BYTES", 1 << 22))
    chunk = int(os.environ.get("GMIX_FAST_CHUNK", 4000))
    warm = int(os.environ.get("GMIX_FAST_WARM", 131072))
    data = bench_mod._corpus(n)

    for arg in sys.argv[1:]:
        if "@" in arg:
            variant, prof = arg.split("@")
        else:
            variant, prof = arg, "11x128"
        bits, S = (int(x) for x in prof.split("x"))
        spec = trim_spec(bench_mod._spec_for(bits), variant)
        try:
            t0 = time.time()
            warm_host = (
                bench_mod._pretrain_host_state(spec, warm, chunk) if warm else None
            )
            t_warm = time.time() - t0
            pred = (
                bench_mod._broadcast_warm(warm_host, spec, S)
                if warm_host is not None
                else Predictor(spec, S, analysis=False)
            )
            t0 = time.time()
            blob = compress_bytes(data, spec, S, chunk, pred=pred)
            t_enc = time.time() - t0
            entry = {
                "variant": variant,
                "profile": f"scaled-{bits}x{S}",
                "corpus_bytes": n,
                "warm_bytes": warm,
                "warm_s": round(t_warm, 1),
                "bpb": round(8 * len(blob) / n, 4),
                "model_bpb": round(entropy_bits(pred) / n, 4),
                "enc_s": round(t_enc, 1),
                "enc_mbps": round(n / t_enc / 1e6, 4),
            }
            del pred
        except Exception as e:
            entry = {"variant": variant, "profile": f"scaled-{bits}x{S}",
                     "error": f"{type(e).__name__}: {e}"[:300]}
        _record(entry)
        print(json.dumps(entry), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
