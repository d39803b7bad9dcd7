"""Smoke run of the codec's main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the stream-sharded path only

One card, in this order, each phase in its own child process (the parent never
opens the card, so only one JAX process holds it at a time):

  device          fails unless JAX's first device is a GPU
  cpu_parity      `tiny` profile (LSTM, PPM, APM), 2 streams, 4 KiB: the GPU
                  compresses and decodes its own archive exactly; a child with
                  JAX_PLATFORMS=cpu compresses the same input; the GPU's bpb
                  must be within 0.1% of the CPU's (the two compilers
                  contract multiply-adds into FMAs in different places, which
                  moves a few coded bits but not the model)
  compress        `best` profile (the full ensemble at its full table sizes,
                  ~2.5 GiB of state per stream), 4 streams, chunk 1000 (a
                  multiple of the LSTM horizon, so the deferred-BPTT program
                  runs), on the first 131072 bytes of data/corpus_1m.bin;
                  the model entropy must be finite and bpb below 8
  decompress      the same archive in a fresh process with the persistent
                  compile cache off, so the decoder compiles and autotunes on
                  its own as a user's decoder does; must reproduce the input
  train_generate  `cli train` on 16 KiB with --out-checkpoint, then
                  `cli generate -k` 512 bytes at temperature 0.5 (the
                  generation program holds no learning code)

Four cards (`--four-cards`): `scaled-12`, 16 streams sharded over a 4-device
mesh, 64 KiB, chunk 1000. The sharded archive must equal the archive of the
same 16-stream program on one card in the same process, the sharded decode
must be exact, and the compiled chunk program must hold no collective.

Earlier lines report the card's name and power limit (from nvidia-smi), the
device kind, and each phase's seconds, compile seconds, peak device bytes,
bpb and byte counts. The last line is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}, printed
only when every phase passed; otherwise the exit code is non-zero. Work files
go to `.smoke_work/` in the checkout and are removed at the end.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(REPO, "data", "corpus_1m.bin")
WORK = os.path.join(REPO, ".smoke_work")

MAIN = dict(profile="best", streams=4, chunk=1000, n_bytes=131072)
TRAIN = dict(n_bytes=16384, gen_bytes=512, temperature=0.5, prompt_bytes=64)
PARITY = dict(profile="tiny", streams=2, chunk=40, n_bytes=4096, bpb_rel_tol=1e-3)
FOUR = dict(profile="scaled-12", streams=16, chunk=1000, n_bytes=65536, n_devices=4)
BUDGET_S = 1150  # the whole one-card run, compiles included


# ---------------------------------------------------------------------------
# helpers shared by the phases (run inside a child process)
# ---------------------------------------------------------------------------


def _corpus(n: int) -> bytes:
    with open(CORPUS, "rb") as f:
        data = f.read(n)
    assert len(data) == n, f"{CORPUS} holds fewer than {n} bytes"
    return data


def _spec(profile: str):
    from gmix_tpu.cli import _spec

    return _spec(argparse.Namespace(profile=profile))


class _CompileClock:
    """Sums XLA backend-compile seconds reported by JAX's monitoring hooks."""

    def __init__(self):
        from jax import monitoring

        self.seconds = 0.0
        monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, secs, **_):
        if name == "/jax/core/compile/backend_compile_duration":
            self.seconds += secs


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _compress(data: bytes, profile: str, streams: int, chunk: int, sharding=None):
    """Compress as `cli compress` does; returns (archive, model entropy bits)."""
    from gmix_tpu.core.codec import Predictor, compress_bytes, entropy_bits

    spec = _spec(profile)
    pred = Predictor(spec, streams, sharding=sharding)
    blob = compress_bytes(data, spec, streams, chunk, pred=pred)
    return blob, entropy_bits(pred)


def _decompress(blob: bytes, profile: str, chunk: int, streams: int, sharding=None) -> bytes:
    from gmix_tpu.core.codec import Predictor, decompress_bytes

    spec = _spec(profile)
    return decompress_bytes(blob, spec, chunk, pred=Predictor(spec, streams, sharding=sharding))


# ---------------------------------------------------------------------------
# phases: each returns a JSON-able dict; `ok` False fails the run
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    import jax

    d = jax.devices()
    dev = {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}
    return {"ok": dev["platform"] == "gpu", "device": dev}


def phase_cpu_parity_encode(n_bytes: int = PARITY["n_bytes"]) -> dict:
    """One side of cpu_parity: compress the tiny input and decode it again."""
    import jax

    p = PARITY
    data = _corpus(n_bytes)
    blob, ent = _compress(data, p["profile"], p["streams"], p["chunk"])
    exact = _decompress(blob, p["profile"], p["chunk"], p["streams"]) == data
    return {"ok": exact, "exact": exact, "platform": jax.devices()[0].platform,
            "archive": blob.hex(), "bpb": 8 * len(blob) / n_bytes, "model_bpb": ent / n_bytes}


def compare_parity(dev: dict, cpu: dict, rel_tol: float = PARITY["bpb_rel_tol"]) -> dict:
    rel = abs(dev["bpb"] - cpu["bpb"]) / cpu["bpb"]
    return {
        "ok": dev["exact"] and cpu["exact"] and rel <= rel_tol,
        "bpb_dev": dev["bpb"],
        "bpb_cpu": cpu["bpb"],
        "bpb_rel_diff": rel,
        "archive_equal_cpu": dev["archive"] == cpu["archive"],
    }


def phase_compress() -> dict:
    import jax

    m = MAIN
    clock = _CompileClock()
    data = _corpus(m["n_bytes"])
    t0 = time.time()
    blob, ent = _compress(data, m["profile"], m["streams"], m["chunk"])
    secs = time.time() - t0
    os.makedirs(WORK, exist_ok=True)
    with open(os.path.join(WORK, "main.gxtc"), "wb") as f:
        f.write(blob)
    bpb = 8 * len(blob) / len(data)
    model_bpb = ent / len(data)
    return {
        "ok": math.isfinite(ent) and bpb < 8.0,
        "seconds": secs, "compile_s": clock.seconds, "peak_bytes": _peak_bytes(),
        "bytes_in": len(data), "bytes_out": len(blob), "bpb": bpb, "model_bpb": model_bpb,
        "kind": jax.devices()[0].device_kind,
    }


def phase_decompress() -> dict:
    m = MAIN
    clock = _CompileClock()
    with open(os.path.join(WORK, "main.gxtc"), "rb") as f:
        blob = f.read()
    t0 = time.time()
    out = _decompress(blob, m["profile"], m["chunk"], m["streams"])
    secs = time.time() - t0
    exact = out == _corpus(m["n_bytes"])
    return {"ok": exact, "exact": exact, "seconds": secs, "compile_s": clock.seconds,
            "peak_bytes": _peak_bytes(), "bytes_in": len(blob), "bytes_out": len(out)}


def phase_train_generate() -> dict:
    from gmix_tpu import cli

    m, t = MAIN, TRAIN
    clock = _CompileClock()
    os.makedirs(WORK, exist_ok=True)
    train = os.path.join(WORK, "train.bin")
    prompt = os.path.join(WORK, "prompt.bin")
    ckpt = os.path.join(WORK, "trained.gxt")
    gen = os.path.join(WORK, "generated.bin")
    with open(train, "wb") as f:
        f.write(_corpus(t["n_bytes"]))
    with open(prompt, "wb") as f:
        f.write(_corpus(t["prompt_bytes"]))
    common = ["--profile", m["profile"], "--streams", str(m["streams"]), "--chunk", str(m["chunk"])]
    t0 = time.time()
    # cli.main prints its own progress lines; keep this phase's stdout to the
    # one JSON line the parent reads
    with open(os.path.join(WORK, "cli.log"), "w") as log:
        stdout, sys.stdout = sys.stdout, log
        try:
            rc_train = cli.main(common + ["train", train, train, "--out-checkpoint", ckpt])
            t_train = time.time() - t0
            rc_gen = cli.main(common + ["generate", "-k", ckpt, prompt, gen,
                                        str(t["gen_bytes"]), str(t["temperature"])])
        finally:
            sys.stdout = stdout
    with open(gen, "rb") as f:
        out = f.read()
    ok = rc_train == 0 and rc_gen == 0 and len(out) == t["gen_bytes"]
    return {"ok": ok, "seconds": time.time() - t0, "train_s": t_train,
            "compile_s": clock.seconds, "peak_bytes": _peak_bytes(),
            "checkpoint_bytes": os.path.getsize(ckpt), "generated_bytes": len(out)}


def phase_four_cards(n_devices: int = FOUR["n_devices"], profile: str = FOUR["profile"],
                     streams: int = FOUR["streams"], n_bytes: int = FOUR["n_bytes"],
                     chunk: int = FOUR["chunk"]) -> dict:
    """The stream-sharded path over an n-device mesh against the same program
    on one device."""
    import jax
    import jax.numpy as jnp

    from gmix_tpu.core.codec import _WORST_PER_BYTE, Predictor, _pad_streams
    from gmix_tpu.parallel.mesh import collectives, make_mesh, stream_sharding

    devs = jax.devices()
    assert len(devs) >= n_devices, f"need {n_devices} devices, have {len(devs)}"
    clock = _CompileClock()
    data = _corpus(n_bytes)
    sh = stream_sharding(make_mesh(n_devices))
    t0 = time.time()
    blob_mesh, ent = _compress(data, profile, streams, chunk, sharding=sh)
    t_mesh = time.time() - t0

    # the compiled sharded chunk program (the one compress_bytes ran, at its
    # buffer shapes) must hold no collective
    pred = Predictor(_spec(profile), streams, sharding=sh)
    _, per = _pad_streams(data, streams, chunk)
    cap = per + per // 2 + _WORST_PER_BYTE * chunk + 4096
    data_buf = jax.device_put(jnp.zeros((streams, per), jnp.uint8), sh)
    code_buf = jax.device_put(jnp.zeros((streams, cap), jnp.uint8), sh)
    compiled = pred.chunk_fn(chunk).lower(
        pred.state, data_buf, code_buf, jnp.int32(0), jnp.asarray(False)).compile()
    colls = collectives(compiled)
    del pred, data_buf, code_buf, compiled

    t0 = time.time()
    blob_one, _ = _compress(data, profile, streams, chunk)
    t_one = time.time() - t0
    t0 = time.time()
    exact = _decompress(blob_mesh, profile, chunk, streams, sharding=sh) == data
    t_dec = time.time() - t0
    same = blob_mesh == blob_one
    return {
        "ok": same and exact and not colls and math.isfinite(ent),
        "archive_equal_one_card": same, "exact": exact, "collectives": colls,
        "bpb": 8 * len(blob_mesh) / len(data), "bytes_in": len(data),
        "bytes_out": len(blob_mesh), "sharded_s": t_mesh, "one_card_s": t_one,
        "decode_s": t_dec, "compile_s": clock.seconds, "peak_bytes": _peak_bytes(),
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": n_devices},
    }


PHASES = {
    "device": phase_device,
    "cpu_parity_encode": phase_cpu_parity_encode,
    "compress": phase_compress,
    "decompress": phase_decompress,
    "train_generate": phase_train_generate,
    "four_cards": phase_four_cards,
}


# ---------------------------------------------------------------------------
# parent: runs the phases as sequential children and checks them
# ---------------------------------------------------------------------------


class PhaseFailed(Exception):
    pass


def _run_child(name: str, deadline: float, env=None) -> dict:
    timeout = deadline - time.time()
    if timeout <= 0:
        raise PhaseFailed(f"{name}: no time left")
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--phase", name],
            cwd=REPO, env={**os.environ, **(env or {})}, stdout=subprocess.PIPE,
            stderr=sys.stderr, timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        raise PhaseFailed(f"{name}: timed out after {timeout:.0f}s") from None
    lines = proc.stdout.decode(errors="replace").strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise PhaseFailed(f"{name}: exit code {proc.returncode}")
    res = json.loads(lines[-1])
    if not res.get("ok"):
        raise PhaseFailed(f"{name}: {json.dumps(res)[:2000]}")
    return res


def _report(name: str, res: dict, skip=("ok", "archive", "device", "kind")) -> None:
    print(f"phase {name}: " + json.dumps({k: v for k, v in res.items() if k not in skip}),
          flush=True)


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=60, check=True,
    )
    return out.stdout.decode().strip()


def run_one_card() -> dict:
    deadline = time.time() + BUDGET_S
    dev = _run_child("device", deadline)["device"]
    print(f"gpu: {_gpu_line()}", flush=True)
    print(f"device_kind: {dev['kind']}", flush=True)

    gpu = _run_child("cpu_parity_encode", deadline)
    cpu = _run_child("cpu_parity_encode", deadline, env={"JAX_PLATFORMS": "cpu"})
    par = compare_parity(gpu, cpu)
    _report("cpu_parity", par)
    if not par["ok"]:
        raise PhaseFailed(f"cpu_parity: {json.dumps(par)}")

    _report("compress", _run_child("compress", deadline))
    _report("decompress", _run_child(
        "decompress", deadline, env={"JAX_ENABLE_COMPILATION_CACHE": "false"}))
    _report("train_generate", _run_child("train_generate", deadline))
    return dev


def run_four_cards() -> dict:
    res = _run_child("four_cards", time.time() + BUDGET_S)
    for line in _gpu_line().splitlines():
        print(f"gpu: {line}", flush=True)
    print(f"device_kind: {res['device']['kind']}", flush=True)
    _report("four_cards", res)
    return res["device"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the stream-sharded path over four cards")
    ap.add_argument("--phase", choices=sorted(PHASES), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.phase:  # child: one phase, one JSON line
        print(json.dumps(PHASES[args.phase]()), flush=True)
        return 0

    try:
        dev = run_four_cards() if args.four_cards else run_one_card()
    except PhaseFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
