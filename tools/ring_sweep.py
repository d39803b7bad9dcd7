"""bpb vs match-history ring size on the 16 MB wiki corpus.

The reference's match history is unbounded with 5-byte pointers
(reference src/models/match.cpp:92-108); this codec bounds it to a
2^history_bits ring per stream (config.EnsembleSpec.history_bits; best_spec
uses 2^26 = 64 MB). This tool produces the measured bpb-vs-ring-size curve
that justifies the bound: encode the wiki corpus (dictionary-transformed,
the match-heavy input class) at a fixed profile while varying history_bits
around the per-stream block length, and record where the curve saturates -
a ring >= the per-stream block is lossless vs unbounded BY CONSTRUCTION
(pointers never wrap), so the interesting region is ring < block.

Usage: python tools/ring_sweep.py [BITS ...]   (history_bits values)
Env: GMIX_RING_PROFILE (default 11x16 -> ~1 MB dict-transformed per stream),
     GMIX_RING_CHUNK (4000).
Results append to analysis/parity.json under "ring_sweep".
"""
import dataclasses
import json
import os
import subprocess
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
    sweep = merged.get("ring_sweep")
    if not isinstance(sweep, list):
        sweep = []
    key = (entry.get("profile"), entry.get("history_bits"))
    sweep = [r for r in sweep if (r.get("profile"), r.get("history_bits")) != key] + [entry]
    merged["ring_sweep"] = sorted(
        sweep, key=lambda r: (r.get("profile", ""), r.get("history_bits", 0))
    )
    os.makedirs(os.path.dirname(PARITY), exist_ok=True)
    json.dump(merged, open(PARITY, "w"), indent=1)


def _wiki_dict_corpus() -> bytes:
    """Deterministic 16.78 MB mediawiki-shaped corpus -> wiki transform ->
    dictionary transform (the compression input of tools/wiki_e2e.py)."""
    cache = "/tmp/ring_sweep_corpus.bin"
    if os.path.exists(cache):
        return open(cache, "rb").read()
    from tools.make_wiki_corpus import make_corpus
    from gmix_tpu.preprocess import dictionary as D
    from gmix_tpu.preprocess import wiki

    raw = make_corpus(16 << 20)
    blob = D.load(None).encode(wiki.encode(raw))
    open(cache, "wb").write(blob)
    return blob


def main():
    bits_list = [int(a) for a in sys.argv[1:]] or [16, 17, 18, 19, 20]
    import bench as bench_mod
    from gmix_tpu.core.codec import Predictor, compress_bytes, entropy_bits

    prof = os.environ.get("GMIX_RING_PROFILE", "11x16")
    pbits, S = (int(x) for x in prof.split("x"))
    chunk = int(os.environ.get("GMIX_RING_CHUNK", 4000))
    data = _wiki_dict_corpus()
    n = len(data)
    per_stream = -(-n // S)
    for hb in bits_list:
        spec = dataclasses.replace(bench_mod._spec_for(pbits), history_bits=hb)
        spec.validate()
        try:
            pred = Predictor(spec, S, analysis=False)
            t0 = time.time()
            blob = compress_bytes(data, spec, S, chunk, pred=pred)
            t_enc = time.time() - t0
            entry = {
                "profile": f"scaled-{pbits}x{S}",
                "history_bits": hb,
                "ring_bytes": 1 << hb,
                "per_stream_bytes": per_stream,
                "corpus": f"wiki+dict transformed, {n} bytes",
                "bpb": round(8 * len(blob) / n, 4),
                "model_bpb": round(entropy_bits(pred) / n, 4),
                "enc_s": round(t_enc, 1),
            }
            del pred
        except Exception as e:
            entry = {"profile": f"scaled-{pbits}x{S}", "history_bits": hb,
                     "error": f"{type(e).__name__}: {e}"[:300]}
        _record(entry)
        print(json.dumps(entry), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
