"""Measure steady-state chunk throughput vs stream count on the accelerator.

Times the jitted chunk program directly (compile excluded), reporting
encode MB/s and per-bit step latency. Usage:
  python tools/scaling.py [streams ...]
Env: GMIX_SCALE_PROFILE (default scaled-12), GMIX_SCALE_CHUNK (default 512).
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gmix_tpu.config import reference_spec, scale_tables
from gmix_tpu.core.codec import Predictor
from gmix_tpu.core.meta import build_meta
from gmix_tpu.state import state_bytes


def run(streams, spec, chunk):
    pred = Predictor(spec, streams)
    data = np.random.default_rng(0).integers(0, 256, (streams, chunk * 4), np.uint8)
    data_buf = jnp.asarray(data)
    cap = chunk * 40 + 4096
    code_buf = jnp.zeros((streams, cap), jnp.uint8)
    fn = pred.chunk_fn(chunk)
    dec = jnp.asarray(False)
    t_c0 = time.time()
    state, data_buf, code_buf, _w, _n = fn(pred.state, data_buf, code_buf, jnp.int32(0), dec)
    jax.block_until_ready(state["metrics"]["ent"])
    compile_s = time.time() - t_c0
    t0 = time.time()
    reps = 2
    for r in range(1, 1 + reps):
        state, data_buf, code_buf, _w, _n = fn(state, data_buf, code_buf, jnp.int32(chunk * r), dec)
    jax.block_until_ready(state["metrics"]["ent"])
    dt = (time.time() - t0) / reps
    mbps = streams * chunk / dt / 1e6
    bit_us = dt / (chunk * 8) * 1e6
    mem = state_bytes(pred.state) / 1e9
    print(f"S={streams:4d} chunk={chunk} mem={mem:6.2f}GB compile={compile_s:6.1f}s "
          f"chunk_t={dt*1e3:8.1f}ms bit={bit_us:7.1f}us enc={mbps:8.4f} MB/s",
          flush=True)
    del pred, state, data_buf, code_buf


if __name__ == "__main__":
    profile = os.environ.get("GMIX_SCALE_PROFILE", "scaled-12")
    chunk = int(os.environ.get("GMIX_SCALE_CHUNK", 512))
    bits = int(profile.split("-")[1])
    spec = scale_tables(reference_spec(), bits, history_bits=min(24, bits + 4))
    sizes = [int(a) for a in sys.argv[1:]] or [16, 64, 256]
    for s in sizes:
        run(s, spec, chunk)
