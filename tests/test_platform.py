"""Process and platform behaviour: importing the package opens no device, the
compile cache location, the bit sub-step form per backend, and the GPU smoke
script's phases (run here on the CPU at tiny size; the script itself refuses
to report success without a GPU)."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _py(code: str, env_update=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update({"JAX_PLATFORMS": "cpu", **(env_update or {})})
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=300)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    return out.stdout.decode().strip().splitlines()[-1]


def test_import_opens_no_backend():
    """A JAX client reserves most of an accelerator's memory when it starts,
    so importing the package must not start one."""
    code = ("import gmix_tpu, gmix_tpu.cli, gmix_tpu.parallel.mesh\n"
            "from jax._src import xla_bridge\n"
            "print(xla_bridge.backends_are_initialized())")
    assert _py(code) == "False"


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_location(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins where it is set (and the package sets
    nothing); otherwise the cache is the fixed .jax_cache in the checkout."""
    code = "import gmix_tpu, jax; print(jax.config.jax_compilation_cache_dir)"
    if env_dir:
        d = str(tmp_path / "cc")
        assert _py(code, {"JAX_COMPILATION_CACHE_DIR": d}) == d
    else:
        got = _py(code, drop=("JAX_COMPILATION_CACHE_DIR",))
        assert got == os.path.join(REPO, ".jax_cache")


def test_default_bit_scan_on_cpu():
    """The CPU takes the scanned sub-steps (test compile time); the form is
    chosen by the backend alone, never by an environment option."""
    import inspect

    from gmix_tpu.core.step import default_bit_scan

    assert default_bit_scan() is True
    assert "environ" not in inspect.getsource(default_bit_scan)


def test_chip_smoke_fails_without_gpu():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"},
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout.decode()


def test_chip_smoke_cpu_parity_phase():
    import chip_smoke

    side = chip_smoke.phase_cpu_parity_encode(n_bytes=1024)
    assert side["ok"] and side["exact"] and side["platform"] == "cpu"
    par = chip_smoke.compare_parity(side, side)
    assert par["ok"] and par["archive_equal_cpu"] and par["bpb_rel_diff"] == 0.0
    off = dict(side, bpb=side["bpb"] * 1.01, archive="00")
    par = chip_smoke.compare_parity(off, side)
    assert not par["ok"] and not par["archive_equal_cpu"]
    json.dumps(par)


def test_chip_smoke_four_cards_phase():
    """The four-card phase on 4 of the 8 virtual CPU devices: sharded archive
    equals the one-device archive, sharded decode exact, no collective."""
    import chip_smoke

    res = chip_smoke.phase_four_cards(n_devices=4, profile="tiny", streams=8,
                                      n_bytes=2000, chunk=40)
    assert res["ok"], res
    assert res["archive_equal_one_card"] and res["exact"] and res["collectives"] == []
    assert res["device"]["count"] == 4
    json.dumps(res)
