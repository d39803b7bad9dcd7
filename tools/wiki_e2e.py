"""End-to-end enwik-style pipeline demonstration on the accelerator:

    synthetic MediaWiki dump (tools/make_wiki_corpus.py; real enwik is not
    obtainable in this zero-egress environment)
      -> wiki-encode   (STARLIT/phda9-equivalent transform, native C++)
      -> dict-encode   (cmix-style word-replacing transform, native C++)
      -> compress      (the codec)
      -> decompress
      -> dict-decode
      -> wiki-decode
      == byte-identical original (asserted)

Mirrors the reference flow src/runner/enwik9-prep.cpp:50-75
followed by gmix -c/-d. Records sizes/times per phase into analysis/parity.json
under "wiki_e2e".

Usage: python tools/wiki_e2e.py [SIZE_BYTES]
Env: GMIX_E2E_PROFILE (default scaled-11x128), GMIX_E2E_CHUNK (default 4000).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 16 << 20
    prof = os.environ.get("GMIX_E2E_PROFILE", "scaled-11x128")
    chunk = int(os.environ.get("GMIX_E2E_CHUNK", 4000))
    bits, S = prof.replace("scaled-", "").split("x")
    bits, S = int(bits), int(S)

    from tools.make_wiki_corpus import make_corpus

    t0 = time.time()
    data = make_corpus(size)
    t_gen = time.time() - t0
    sys.stderr.write(f"e2e: corpus {len(data)} bytes in {t_gen:.1f}s\n")

    from gmix_tpu.preprocess import dictionary as D
    from gmix_tpu.preprocess import wiki

    t0 = time.time()
    wblob = wiki.encode(data)
    t_wiki = time.time() - t0
    t0 = time.time()
    dblob = D.load(None).encode(wblob)
    t_dict = time.time() - t0
    sys.stderr.write(
        f"e2e: wiki {len(data)} -> {len(wblob)} ({t_wiki:.1f}s), "
        f"dict -> {len(dblob)} ({t_dict:.1f}s)\n"
    )

    from gmix_tpu.config import reference_spec, scale_tables
    from gmix_tpu.core.codec import Predictor, compress_bytes, decompress_bytes

    spec = scale_tables(reference_spec(), bits, history_bits=min(24, bits + 4))
    pred = Predictor(spec, S, analysis=False)
    t0 = time.time()
    blob = compress_bytes(dblob, spec, S, chunk, pred=pred)
    t_enc = time.time() - t0
    del pred
    pred = Predictor(spec, S, analysis=False)
    t0 = time.time()
    out = decompress_bytes(blob, spec, chunk, pred=pred)
    t_dec = time.time() - t0
    del pred
    assert out == dblob, "codec roundtrip mismatch"

    t0 = time.time()
    wback = D.load(None).decode(out)
    t_undict = time.time() - t0
    t0 = time.time()
    back = wiki.decode(wback)
    t_unwiki = time.time() - t0
    exact = back == data
    bpb = 8.0 * len(blob) / len(data)
    mbps = 2 * len(data) / (t_enc + t_dec) / 1e6

    rec = {
        "corpus": f"synthetic mediawiki dump, {len(data)} bytes "
                  "(real enwik unavailable: zero-egress environment)",
        "profile": f"scaled-{bits}x{S}",
        "chunk": chunk,
        "wiki_bytes": len(wblob),
        "dict_bytes": len(dblob),
        "compressed_bytes": len(blob),
        "bpb_vs_original": round(bpb, 4),
        "prep_s": round(t_wiki + t_dict, 1),
        "enc_s": round(t_enc, 1),
        "dec_s": round(t_dec, 1),
        "post_s": round(t_undict + t_unwiki, 1),
        "encdec_mbps_vs_original": round(mbps, 4),
        "chain_byte_identical": bool(exact),
    }
    print(json.dumps(rec), flush=True)
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "analysis", "parity.json",
    )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    parity = json.load(open(path)) if os.path.exists(path) else {}
    parity["wiki_e2e"] = rec
    json.dump(parity, open(path, "w"), indent=1)
    if not exact:
        sys.stderr.write("E2E CHAIN MISMATCH\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
