"""Multi-host (multi-process) execution: 2 spawned processes x 4 virtual CPU
devices run the distributed compression path end-to-end and must produce a
container byte-identical to the single-process archive (stream placement can
never change stream semantics). Exercises jax.distributed.initialize, the
global mesh, per-shard global-array construction, the shard_map chunk program
across processes, and the ordered cross-host payload gather."""
import os
import socket
import subprocess
import sys

import pytest

import gmix_tpu as g

RANK_SCRIPT = r"""
import os, sys
rank = int(sys.argv[1]); port = sys.argv[2]
data_path, out_path = sys.argv[3], sys.argv[4]
import jax
# initialize BEFORE importing gmix_tpu (whose import touches jnp constants and
# would initialise the XLA backend single-process)
jax.distributed.initialize(f"localhost:{port}", 2, rank)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, jax.devices()
from gmix_tpu.parallel.distributed import compress_bytes_multihost
import gmix_tpu as g
spec = g.tiny_spec(with_lstm=True)
data = open(data_path, "rb").read()
blob = compress_bytes_multihost(data, spec, num_streams=8, chunk=20)
if rank == 0:
    open(out_path, "wb").write(blob)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_archive_matches_single_process(tmp_path):
    data = (
        b"Multi-host compression must not depend on stream placement. " * 14
    )[:800]
    data_path = os.path.join(tmp_path, "in.bin")
    open(data_path, "wb").write(data)
    out_path = os.path.join(tmp_path, "multi.gxtc")
    script = os.path.join(tmp_path, "rank.py")
    open(script, "w").write(RANK_SCRIPT)

    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = [
        subprocess.Popen(
            [sys.executable, script, str(r), str(port), data_path, out_path],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        for r in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost ranks timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"rank failed:\n{err.decode()[-3000:]}"

    multi = open(out_path, "rb").read()
    spec = g.tiny_spec(with_lstm=True)
    single = g.compress_bytes(data, spec, num_streams=8, chunk=20)
    assert multi == single, (
        f"multi-host archive differs from single-process archive "
        f"({len(multi)} vs {len(single)} bytes)"
    )
    # and it decodes back to the input through the ordinary path
    assert g.decompress_bytes(multi, spec, chunk=20) == data
