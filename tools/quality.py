"""Compression-QUALITY ablations on the accelerator: encode-only bpb per variant.

Each variant compresses the same corpus once and reports archive bpb + model
cross-entropy bpb (roundtrip exactness is covered by bench.py and the test
suite; decode adds nothing to a quality measurement). Results append to
analysis/quality_ablations.json (gitignored) so the parity gap vs the
reference is attributed component by component.

Usage:
  python tools/quality.py VARIANT [VARIANT ...]
Variants:
  ref-x4            full reference tables, 4 streams (the parity config)
  ref-x4-noppm      full tables, PPM removed
  ref-x4-oldppm     full tables, round-2 PPM (shallow orders, no excl/SEE)
  scaled-14x16      round-2 bench config with the new PPM
  scaled-14x16-noppm
  scaled-14x16-oldppm
  scaled-12x64      throughput-frontier candidate
Env: GMIX_QUAL_BYTES (default 1<<20), GMIX_QUAL_CHUNK (default 4000).
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _corpus(n: int) -> bytes:
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "corpus_1m.bin")
    data = open(path, "rb").read()
    while len(data) < n:
        data += data
    return data[:n]


def _old_ppm():
    """The round-2 PPM configuration: 5 shallow orders, lowest-first PPM-C
    blend semantics approximated by disabling exclusion/SEE/update-exclusion."""
    from gmix_tpu.config import PpmOrder, PpmSpec

    return PpmSpec(
        orders=(
            PpmOrder("last_byte", 8),
            PpmOrder("h2", 16),
            PpmOrder("h3", 16),
            PpmOrder("h4", 16),
            PpmOrder("h6", 16),
        ),
        see_lr=0.0,
        exclusion=False,
        update_exclusion=False,
    )


def _boost117():
    """An earlier measured-best table sizing, ppm capped at 17 bits: the
    272-lane tag-in-row widening puts 18-bit ppm arenas past 2^31 elements
    at 4 streams, beyond i32 element indexing (ROADMAP B5)."""
    from gmix_tpu.config import reference_spec

    spec = reference_spec()
    return dataclasses.replace(
        spec,
        indirects=tuple(
            dataclasses.replace(m, table_bits=min(m.table_bits + 1, 18))
            for m in spec.indirects
        ),
        ppm=dataclasses.replace(
            spec.ppm,
            orders=tuple(
                dataclasses.replace(o, table_bits=17) if o.table_bits >= 16 else o
                for o in spec.ppm.orders
            ),
        ),
    )


def make_variant(name: str):
    from gmix_tpu.config import ApmStage, PpmOrder, reference_spec, scale_tables

    if name.startswith("apm"):
        # apm-<lr_milli>-<wgt_pct>-<tb>x<S>: boost117 + one SSE/APM stage
        # gated on last_byte; apm2-...: + a second stage on h2 (tb+8 bits,
        # half weight). The model lever for the <=-reference bar: one extra
        # arena row per stage per byte.
        two = name.startswith("apm2")
        body = name.split("-", 1)[1]
        lr_milli, wgt_pct, rest = body.split("-")
        tb, S = rest.split("x")
        lr, wgt, tb = int(lr_milli) / 1000.0, int(wgt_pct) / 100.0, int(tb)
        stages = (ApmStage("apm_lb", "last_byte", tb, lr=lr, weight=wgt),)
        if two:
            stages += (ApmStage("apm_h2", "h2", tb + 8, lr=lr, weight=wgt / 2),)
        spec = dataclasses.replace(_boost117(), apm=stages)
        spec.validate()
        return spec, int(S)
    if name.startswith("shallowppm"):
        # shallowppm-<bits>x<S>: scaled profile with the round-2 SHALLOW
        # order set but the round-3 mechanisms (SEE, exclusion, update
        # exclusion) kept ON - deconfounds order set vs mechanisms for the
        # budget-adaptive PPM decision
        bits, S = name.split("-")[1].split("x")
        bits = int(bits)
        spec = scale_tables(reference_spec(), bits, history_bits=min(24, bits + 4))
        spec = dataclasses.replace(
            spec,
            ppm=dataclasses.replace(
                spec.ppm,
                orders=tuple(
                    PpmOrder(c, min(b, bits))
                    for c, b in (("last_byte", 8), ("h2", 16), ("h3", 16),
                                 ("h4", 16), ("h6", 16))
                ),
            ),
        )
        spec.validate()
        return spec, int(S)
    if name.startswith("boost"):
        # boost-<ind_add>-<ppm_bits>x<S>: reference wiring with indirect
        # tables raised by ind_add bits (cap 18) and hashed PPM orders raised
        # to ppm_bits - the ">= reference quality" configs (output-size
        # parity is the goal, not table-size parity)
        body = name.split("-", 1)[1]
        ind_add, rest = body.split("-")
        ppm_bits, S = rest.split("x")
        spec = reference_spec()
        spec = dataclasses.replace(
            spec,
            indirects=tuple(
                dataclasses.replace(m, table_bits=min(m.table_bits + int(ind_add), 18))
                for m in spec.indirects
            ),
            ppm=dataclasses.replace(
                spec.ppm,
                orders=tuple(
                    dataclasses.replace(o, table_bits=int(ppm_bits))
                    if o.table_bits >= 16
                    else o
                    for o in spec.ppm.orders
                ),
            ),
        )
        spec.validate()
        return spec, int(S)
    if name.startswith("best"):
        # best-x<S>: exactly config.best_spec() (the CLI --profile best
        # wiring), so the tool's measurement and the shipped profile share
        # one spec hash (round-3 advisor finding: they diverged by a
        # rescale_total tweak that measured as a no-op)
        from gmix_tpu.config import best_spec

        S = int(name.split("x")[1])
        return best_spec(), S
    if name.startswith("tuned"):
        # tuned-x<S>: the rotation-opt-out HYPOTHESIS config - it measured
        # WORSE than boost-1-18 (2.0383 vs 2.0338 bpb, round 3): the mixture
        # prefers sharper decorrelated signals even when the opted-out
        # models' own entropies improve. Kept for reproducibility.
        # Background: boost-1-17x4 showed that
        # +1 bit helps low-order indirect tables and the PPM (fewer
        # collisions) but HURTS sparse deep-order contexts (ind_5b/6b EMA
        # 0.50->0.55 / 0.55->0.74; 4-selector skips likewise): hash-collision
        # sharing acts as backoff smoothing when a context rarely repeats.
        # So: PPM orders at 17 bits, +1 bit for the dense indirect tables,
        # reference sizing for the sparse ones.
        S = int(name.split("x")[1])
        keep = {"ind_5b_15", "ind_6b_15", "ind_skip_1_2_3_4", "ind_skip_0_2_3_4",
                "ind_skip_0_1_3_4", "ind_skip_0_1_2_4"}
        spec = reference_spec()
        spec = dataclasses.replace(
            spec,
            indirects=tuple(
                dataclasses.replace(m, rotate=False) if m.name in keep
                else dataclasses.replace(m, table_bits=min(m.table_bits + 1, 18))
                for m in spec.indirects
            ),
            ppm=dataclasses.replace(
                spec.ppm,
                orders=tuple(
                    dataclasses.replace(o, table_bits=17) if o.table_bits >= 16 else o
                    for o in spec.ppm.orders
                ),
            ),
        )
        spec.validate()
        return spec, S
    if name.startswith("ppmtune"):
        # ppmtune-<inc>-<rescale_total>-<see_lr_milli>x<S>: reference wiring
        # with PPM count/escape hyperparameters overridden, for attributing
        # the PPM share of the parity gap
        body = name.split("-", 1)[1]
        inc, rescale, rest = body.split("-")
        see_milli, S = rest.split("x")
        spec = reference_spec()
        spec = dataclasses.replace(
            spec,
            ppm=dataclasses.replace(
                spec.ppm,
                inc=int(inc),
                rescale_total=int(rescale),
                see_lr=int(see_milli) / 1000.0,
            ),
        )
        spec.validate()
        return spec, int(S)
    if name.startswith("ref"):
        parts = name.split("-")
        S = int(parts[1][1:])  # xN
        spec = reference_spec()
        mod = parts[2] if len(parts) > 2 else ""
    else:
        parts = name.split("-")[1].split("x")
        bits, S = int(parts[0]), int(parts[1])
        spec = scale_tables(reference_spec(), bits, history_bits=min(24, bits + 4))
        mod = name.split("-")[2] if name.count("-") > 1 else ""
    if mod == "noppm":
        spec = dataclasses.replace(spec, ppm=None)
    elif mod == "oldppm":
        spec = dataclasses.replace(spec, ppm=_old_ppm())
    spec.validate()
    return spec, S


def run_variant(name: str, data: bytes, chunk: int):
    import jax

    from gmix_tpu.core.codec import (
        Predictor,
        analysis_columns,
        analysis_snapshot,
        compress_bytes,
        entropy_bits,
    )
    from gmix_tpu.state import state_bytes

    spec, S = make_variant(name)
    n = len(data)
    # warm the compile cache outside the timed region (the jit happens on the
    # first chunk, and the compile can dwarf the encode); at most ONE state
    # is live at any moment
    import jax.numpy as jnp

    from gmix_tpu.core.codec import _WORST_PER_BYTE, _pad_streams, run_chunks

    _, per = _pad_streams(data, S, chunk)
    cap = int(per + per // 2 + _WORST_PER_BYTE * chunk + 4096)
    wpred = Predictor(spec, S)
    mem = state_bytes(wpred.state)
    sys.stderr.write(f"quality: {name} state={mem/2**30:.2f} GiB S={S}\n")
    run_chunks(
        wpred,
        jnp.zeros((S, per), jnp.uint8),
        jnp.zeros((S, cap), jnp.uint8),
        chunk,
        decode=False,
        chunk=chunk,
    )
    del wpred
    pred = Predictor(spec, S)
    t0 = time.time()
    blob = compress_bytes(data, spec, S, chunk, pred=pred)
    t_enc = time.time() - t0
    ent = entropy_bits(pred) / n
    # final per-column entropy EMA (bits/bit), stream-averaged: the per-model
    # attribution table (compare against the reference's analysis/entropy.tsv)
    ema = analysis_snapshot(pred).mean(axis=0)
    cols = analysis_columns(spec)
    res = {
        "variant": name,
        "corpus_bytes": n,
        "chunk": chunk,
        "streams": S,
        "state_gib": round(mem / 2**30, 3),
        "bpb": round(8 * len(blob) / n, 4),
        "model_bpb": round(ent, 4),
        "enc_s": round(t_enc, 1),
        "enc_mbps": round(n / t_enc / 1e6, 4),
        "model_ema": {c: round(float(v), 5) for c, v in zip(cols, ema)},
    }
    del pred
    return res


def main():
    n = int(os.environ.get("GMIX_QUAL_BYTES", 1 << 20))
    chunk = int(os.environ.get("GMIX_QUAL_CHUNK", 4000))
    data = _corpus(n)
    out_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "analysis", "quality_ablations.json",
    )
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    results = []
    if os.path.exists(out_path):
        results = json.load(open(out_path))
    for name in sys.argv[1:]:
        try:
            res = run_variant(name, data, chunk)
        except Exception as e:
            res = {"variant": name, "error": f"{type(e).__name__}: {e}"[:300]}
        print(json.dumps(res), flush=True)
        results = [r for r in results if r.get("variant") != name] + [res]
        json.dump(results, open(out_path, "w"), indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
