"""Ablate ensemble components to locate per-bit latency cliffs on the accelerator.

Usage: python tools/ablate.py S [variant ...]
Variants: full, nolstm, noppm, nomatch, noih, nomix12, indonly, mixonly
"""
import dataclasses
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gmix_tpu.config import reference_spec, scale_tables
from gmix_tpu.core.codec import Predictor


def variant(name):
    bits = int(os.environ.get("GMIX_ABLATE_BITS", 8))
    s = scale_tables(reference_spec(), bits, history_bits=min(24, bits + 4))
    if name == "full":
        return s
    if name == "nolstm":
        return dataclasses.replace(s, lstm=None)
    if name == "noppm":
        return dataclasses.replace(s, ppm=None)
    if name == "nolstmppm":
        return dataclasses.replace(s, lstm=None, ppm=None)
    if name == "nomatch":
        return dataclasses.replace(s, matches=())
    if name == "noih":
        keep = tuple(m for m in s.indirects if not m.ctx.startswith("ih_"))
        mix = tuple(
            dataclasses.replace(m, ctx="last_byte") if m.ctx.startswith("ih_") else m
            for m in s.mixers
        )
        return dataclasses.replace(s, ihash_ctxs=(), indirects=keep, mixers=mix)
    if name == "nomix12":  # single mixer per layer
        keep = (
            tuple(m for m in s.mixers if m.layer == 0)[:1]
            + tuple(m for m in s.mixers if m.layer == 1)[:1]
            + tuple(m for m in s.mixers if m.layer == 2)
        )
        return dataclasses.replace(s, mixers=keep)
    if name == "mixtb0":  # full mixer stack, all gating tables collapsed to 1 row
        return dataclasses.replace(
            s, mixers=tuple(dataclasses.replace(m, table_bits=0) for m in s.mixers)
        )
    if name == "mixtb4":
        return dataclasses.replace(
            s, mixers=tuple(dataclasses.replace(m, table_bits=min(m.table_bits, 4)) for m in s.mixers)
        )
    if name == "mix6":  # 6 L0 mixers
        keep = (
            tuple(m for m in s.mixers if m.layer == 0)[:6]
            + tuple(m for m in s.mixers if m.layer == 1)[:2]
            + tuple(m for m in s.mixers if m.layer == 2)
        )
        return dataclasses.replace(s, mixers=keep)
    if name == "indonly":
        keep = (
            tuple(m for m in s.mixers if m.layer == 0)[:1]
            + tuple(m for m in s.mixers if m.layer == 1)[:1]
            + tuple(m for m in s.mixers if m.layer == 2)
        )
        keep = tuple(dataclasses.replace(m, ctx="last_byte") for m in keep)
        return dataclasses.replace(
            s, lstm=None, ppm=None, matches=(), ihash_ctxs=(),
            indirects=tuple(m for m in s.indirects if not m.ctx.startswith("ih_")),
            mixers=keep,
        )
    raise ValueError(name)


def run(name, streams, chunk=int(os.environ.get("GMIX_ABLATE_CHUNK", 256))):
    spec = variant(name)
    pred = Predictor(spec, streams)
    data = np.random.default_rng(0).integers(0, 256, (streams, chunk * 4), np.uint8)
    data_buf = jnp.asarray(data)
    code_buf = jnp.zeros((streams, chunk * 40 + 4096), jnp.uint8)
    fn = pred.chunk_fn(chunk)
    dec = jnp.asarray(False)
    t0 = time.time()
    state, data_buf, code_buf, _w, _n = fn(pred.state, data_buf, code_buf, jnp.int32(0), dec)
    jax.block_until_ready(state["metrics"]["ent"])
    compile_s = time.time() - t0
    t0 = time.time()
    state, data_buf, code_buf, _w, _n = fn(state, data_buf, code_buf, jnp.int32(chunk), dec)
    jax.block_until_ready(state["metrics"]["ent"])
    dt = time.time() - t0
    print(f"{name:12s} S={streams:4d} compile={compile_s:6.1f}s "
          f"bit={dt/(chunk*8)*1e6:8.1f}us enc={streams*chunk/dt/1e6:8.4f} MB/s",
          flush=True)
    del pred, state, data_buf, code_buf


if __name__ == "__main__":
    streams = int(sys.argv[1])
    names = sys.argv[2:] or ["full", "nolstm", "noppm", "nomatch", "noih", "nomix12", "indonly"]
    for n in names:
        run(n, streams)
