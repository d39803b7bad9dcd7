"""Command-line runner with reference-parity modes (src/runner/runner.cpp):

  gmix_tpu compress   [-k ckpt] IN OUT      (reference: gmix -c)
  gmix_tpu decompress [-k ckpt] IN OUT      (reference: gmix -d)
  gmix_tpu train      [-k ckpt] TRAIN TEST  (reference: gmix -t)
  gmix_tpu generate   -k ckpt PROMPT OUT SIZE TEMP   (reference: gmix -g)

plus knobs the reference lacks: --streams (block-parallel lanes),
--chunk (scan granularity), --profile (ensemble preset), --save/--load
(model checkpoints at any point).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _spec(args):
    from .config import best_spec, reference_spec, scale_tables, tiny_spec

    if args.profile == "ref":
        s = reference_spec()
    elif args.profile == "best":
        s = best_spec()
    elif args.profile == "tiny":
        s = tiny_spec(with_lstm=True)
    else:
        # scaled-N: reference wiring with tables clamped to 2^N entries
        import re

        m = re.fullmatch(r"scaled-(\d+)", args.profile)
        if not m:
            raise SystemExit(
                f"unknown profile {args.profile!r}: use 'ref', 'best', 'tiny', "
                "or 'scaled-<bits>'"
            )
        bits = int(m.group(1))
        s = scale_tables(reference_spec(), bits, history_bits=min(24, bits + 4))
    return s


def _progress(total, label):
    t0 = time.time()

    def cb(done):
        frac = 100.0 * done / max(total, 1)
        rate = done / max(time.time() - t0, 1e-9) / 1e6
        sys.stderr.write(f"\r{label}: {frac:6.2f}%  ({rate:.3f} MB/s)")
        sys.stderr.flush()

    return cb


def main(argv=None):
    p = argparse.ArgumentParser(prog="gmix_tpu")
    p.add_argument("--profile", default="scaled-12",
                   help="ref | best (highest measured quality) | tiny | "
                        "scaled-N (tables capped at 2^N)")
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--chunk", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0xDEADBEEF)
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("compress")
    pc.add_argument("-k", "--checkpoint", default=None)
    pc.add_argument("--analysis", default=None, metavar="DIR",
                    help="write per-model entropy.tsv + memory.tsv to DIR "
                         "(reference: Predictor::EnableAnalysis)")
    pc.add_argument("input")
    pc.add_argument("output")

    pd = sub.add_parser("decompress")
    pd.add_argument("-k", "--checkpoint", default=None)
    pd.add_argument("input")
    pd.add_argument("output")

    pt = sub.add_parser("train")
    pt.add_argument("-k", "--checkpoint", default=None)
    pt.add_argument("--out-checkpoint", default="data/trained_checkpoint.gxt")
    pt.add_argument("--eval-every", type=int, default=0,
                    help="evaluate test entropy every N bytes (0: only at end)")
    pt.add_argument("train")
    pt.add_argument("test")

    pg = sub.add_parser("generate")
    pg.add_argument("-k", "--checkpoint", required=True)
    pg.add_argument("prompt")
    pg.add_argument("output")
    pg.add_argument("size", type=int)
    pg.add_argument("temperature", type=float)

    # dictionary transform (reference: dictionary-prep -e/-d)
    for name in ("dict-encode", "dict-decode"):
        pde = sub.add_parser(name)
        pde.add_argument("--dictionary", default=None)  # None -> vendored asset
        pde.add_argument("input")
        pde.add_argument("output")

    # enwik9 STARLIT-pipeline equivalent (reference: enwik9-prep c/d)
    pw = sub.add_parser("wiki-encode")
    pw.add_argument("--order", default=None,
                    help="similarity-order file (default: the reference asset)")
    pw.add_argument("--no-verify", action="store_true",
                    help="skip the decode(encode(x))==x self-check")
    pw.add_argument("input")
    pw.add_argument("output")
    pwd = sub.add_parser("wiki-decode")
    pwd.add_argument("input")
    pwd.add_argument("output")

    args = p.parse_args(argv)

    if args.cmd == "wiki-encode":
        from .preprocess import wiki

        n = wiki.encode_file(args.input, args.output, order_path=args.order,
                             verify=not args.no_verify)
        print(f"{os.path.getsize(args.input)} -> {n} bytes")
        return 0
    if args.cmd == "wiki-decode":
        from .preprocess import wiki

        n = wiki.decode_file(args.input, args.output)
        print(f"{os.path.getsize(args.input)} -> {n} bytes")
        return 0

    if args.cmd in ("dict-encode", "dict-decode"):
        from .preprocess import dictionary as D

        d = D.load(args.dictionary)
        data = open(args.input, "rb").read()
        out = d.encode(data) if args.cmd == "dict-encode" else d.decode(data)
        open(args.output, "wb").write(out)
        print(f"{len(data)} -> {len(out)} bytes")
        return 0

    spec = _spec(args)

    from .core.codec import (
        Predictor,
        compress_bytes,
        decompress_bytes,
        entropy_bits,
        generate_bytes,
    )

    t0 = time.time()
    if args.cmd == "compress":
        data = open(args.input, "rb").read()
        pred = Predictor(spec, args.streams, args.seed)
        if args.checkpoint:
            pred.load(args.checkpoint)
        progress = _progress(len(data) // max(args.streams, 1), "compress")
        if args.analysis:
            from .core.codec import analysis_columns, analysis_snapshot, memory_report

            os.makedirs(args.analysis, exist_ok=True)
            with open(os.path.join(args.analysis, "memory.tsv"), "w") as f:
                f.write("component\tbytes\n")
                for name, nbytes in memory_report(pred):
                    f.write(f"{name}\t{nbytes}\n")
                f.write(f"TOTAL\t{pred.memory_bytes()}\n")
            # The per-column entropy EMA itself updates EVERY BIT in-model
            # (alpha=1e-5, as predictor.cpp:439-469); only the snapshot
            # cadence differs from the reference: rows are sampled once per
            # scan chunk (the host cannot observe mid-chunk state without
            # stalling the device pipeline) and labelled with the exact
            # per-stream bit counter from the model state.
            ent_f = open(os.path.join(args.analysis, "entropy.tsv"), "w")
            ent_f.write("bits\t" + "\t".join(analysis_columns(spec)) + "\n")
            base_progress = progress

            def progress(done, _pred=pred, _f=ent_f):
                base_progress(done)
                import jax

                bits = int(np.mean(jax.device_get(_pred.state["stm"]["bits_seen"])))
                row = analysis_snapshot(_pred).mean(axis=0)
                _f.write(f"{bits}\t" + "\t".join(f"{v:.5f}" for v in row) + "\n")
                _f.flush()

        blob = compress_bytes(data, spec, args.streams, args.chunk, pred=pred,
                              progress=progress)
        open(args.output, "wb").write(blob)
        ent = entropy_bits(pred) / max(len(data), 1)
        sys.stderr.write("\n")
        print(f"{len(data)} -> {len(blob)} bytes ({8*len(blob)/max(len(data),1):.4f} bits/byte, "
              f"model entropy {ent:.4f} bits/byte) in {time.time()-t0:.1f}s")
    elif args.cmd == "decompress":
        blob = open(args.input, "rb").read()
        pred = None
        if args.checkpoint:
            import struct

            S = struct.unpack("<H", blob[6:8])[0]
            pred = Predictor(spec, S, args.seed)
            pred.load(args.checkpoint)
        out = decompress_bytes(blob, spec, args.chunk, pred=pred)
        open(args.output, "wb").write(out)
        print(f"{len(blob)} -> {len(out)} bytes in {time.time()-t0:.1f}s")
    elif args.cmd == "train":
        _train(args, spec)
    elif args.cmd == "generate":
        prompt = open(args.prompt, "rb").read()
        pred = Predictor(spec, args.streams, args.seed)
        pred.load(args.checkpoint)
        out = generate_bytes(pred, prompt, args.size,
                             args.temperature, chunk=min(args.chunk, 256))
        open(args.output, "wb").write(out)
        print(f"generated {len(out)} bytes in {time.time()-t0:.1f}s")
    return 0


def _train(args, spec):
    """Training mode (runner-utils.cpp:223-322): compress the train file while
    learning; periodically deep-copy the predictor and measure test-set
    cross-entropy without touching the live model; save a checkpoint."""
    import jax
    import jax.numpy as jnp

    from .core import codec as C

    train = open(args.train, "rb").read()
    test = open(args.test, "rb").read()
    S, chunk = args.streams, args.chunk
    pred = C.Predictor(spec, S, args.seed)
    if args.checkpoint:
        pred.load(args.checkpoint)

    arr, per = C._pad_streams(train, S, chunk)
    cap = int(per + per // 2 + C._WORST_PER_BYTE * chunk + 4096)
    data_buf = jnp.asarray(arr)
    code_buf = jnp.zeros((S, cap), jnp.uint8)
    tarr, tper = C._pad_streams(test, S, chunk)
    tcap = int(tper + tper // 2 + C._WORST_PER_BYTE * chunk + 4096)

    os.makedirs("analysis", exist_ok=True)
    tsv = open("analysis/training.tsv", "w")
    tsv.write("bytes\ttrain_entropy\ttest_entropy\n")

    eval_every = args.eval_every or per  # bytes per stream between evals
    eval_every = max(chunk, (eval_every // chunk) * chunk)
    done = 0
    while done < per:
        n = min(eval_every, per - done)
        data_buf, code_buf, _ = C.run_chunks(pred, data_buf, code_buf, n, decode=False,
                                             t0=done, chunk=chunk)
        done += n
        train_ent = C.entropy_bits(pred) / max(done * S, 1)
        # deep copy + test evaluation (Predictor::Copy, predictor.cpp:42-48)
        p2 = pred.copy()
        ent0 = C.entropy_bits(p2)
        tdata = jnp.asarray(tarr)
        tcode = jnp.zeros((S, tcap), jnp.uint8)
        C.run_chunks(p2, tdata, tcode, tper, decode=False, chunk=chunk)
        test_ent = (C.entropy_bits(p2) - ent0) / max(len(test), 1)
        tsv.write(f"{done * S}\t{train_ent:.5f}\t{test_ent:.5f}\n")
        tsv.flush()
        print(f"trained {done*S} bytes: train {train_ent:.4f} test {test_ent:.4f} bits/byte")

    os.makedirs(os.path.dirname(args.out_checkpoint) or ".", exist_ok=True)
    pred.save(args.out_checkpoint)
    print(f"checkpoint saved to {args.out_checkpoint}")


if __name__ == "__main__":
    sys.exit(main())
