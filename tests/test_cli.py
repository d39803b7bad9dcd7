"""CLI surface tests (reference mode surface: src/runner/runner.cpp:14-29).

Each reference mode (-c/-d/-t/-g) plus the analysis writers is driven through
cli.main(argv) on the tiny profile, pinning the user-facing behavior that was
previously exercised only by hand.
"""
import os

import numpy as np
import pytest

from gmix_tpu import cli

TEXT = (
    b"The quick brown fox jumps over the lazy dog; pack my box with five "
    b"dozen liquor jugs. " * 24
)
ARGS = ["--profile", "tiny", "--streams", "2", "--chunk", "40"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    (d / "in.txt").write_bytes(TEXT[:1600])
    return d


def test_cli_compress_decompress_roundtrip(workdir):
    d = str(workdir)
    rc = cli.main(ARGS + ["compress", f"{d}/in.txt", f"{d}/out.gxtc"])
    assert rc == 0
    assert os.path.getsize(f"{d}/out.gxtc") < 1600  # learned something
    rc = cli.main(ARGS + ["decompress", f"{d}/out.gxtc", f"{d}/back.txt"])
    assert rc == 0
    assert open(f"{d}/back.txt", "rb").read() == TEXT[:1600]


def test_cli_decompress_wrong_profile_rejected(workdir):
    d = str(workdir)
    if not os.path.exists(f"{d}/out.gxtc"):
        cli.main(ARGS + ["compress", f"{d}/in.txt", f"{d}/out.gxtc"])
    with pytest.raises(ValueError, match="spec mismatch"):
        cli.main(["--profile", "scaled-8", "--streams", "2", "--chunk", "40",
                  "decompress", f"{d}/out.gxtc", f"{d}/never.txt"])


def test_cli_compress_analysis_writers(workdir, tmp_path):
    d = str(workdir)
    adir = str(tmp_path / "analysis")
    rc = cli.main(ARGS + ["compress", "--analysis", adir,
                          f"{d}/in.txt", f"{d}/out2.gxtc"])
    assert rc == 0
    ent = open(os.path.join(adir, "entropy.tsv")).read().splitlines()
    assert ent[0].startswith("bits\t") and "final" in ent[0]
    assert len(ent) >= 2  # at least one sampled row
    last = np.array([float(v) for v in ent[-1].split("\t")[1:]])
    assert np.all(np.isfinite(last))
    mem = open(os.path.join(adir, "memory.tsv")).read().splitlines()
    assert mem[0] == "component\tbytes"
    assert mem[-1].startswith("TOTAL\t")
    total = int(mem[-1].split("\t")[1])
    assert total == sum(int(r.split("\t")[1]) for r in mem[1:-1])


def test_cli_train_writes_tsv_and_checkpoint(workdir, tmp_path, monkeypatch):
    d = str(workdir)
    monkeypatch.chdir(tmp_path)  # train writes analysis/training.tsv in cwd
    ck = str(tmp_path / "ck.gxt")
    rc = cli.main(ARGS + ["train", f"{d}/in.txt", f"{d}/in.txt",
                          "--out-checkpoint", ck])
    assert rc == 0
    assert os.path.exists(ck)
    rows = open("analysis/training.tsv").read().splitlines()
    assert rows[0] == "bytes\ttrain_entropy\ttest_entropy"
    assert len(rows) >= 2
    n_bytes, tr, te = rows[-1].split("\t")
    assert int(n_bytes) > 0 and float(tr) > 0
    # test entropy after a full pass over the identical file must be far
    # below the cold train entropy (the deep-copy evaluation path works)
    assert float(te) < float(tr)


def test_cli_generate_from_checkpoint(workdir, tmp_path, monkeypatch):
    d = str(workdir)
    monkeypatch.chdir(tmp_path)
    ck = str(tmp_path / "gck.gxt")
    cli.main(ARGS + ["train", f"{d}/in.txt", f"{d}/in.txt",
                     "--out-checkpoint", ck])
    (tmp_path / "prompt.txt").write_bytes(TEXT[:100])
    rc = cli.main(ARGS + ["generate", "-k", ck, str(tmp_path / "prompt.txt"),
                          str(tmp_path / "gen.txt"), "120", "0.5"])
    assert rc == 0
    out = open(str(tmp_path / "gen.txt"), "rb").read()
    assert len(out) == 120


def test_cli_dict_roundtrip(workdir, tmp_path):
    d = str(workdir)
    enc = str(tmp_path / "d.enc")
    dec = str(tmp_path / "d.dec")
    assert cli.main(["dict-encode", f"{d}/in.txt", enc]) == 0
    assert cli.main(["dict-decode", enc, dec]) == 0
    assert open(dec, "rb").read() == TEXT[:1600]


def test_cli_unknown_profile_errors(workdir):
    d = str(workdir)
    with pytest.raises(SystemExit):
        cli.main(["--profile", "nope", "compress", f"{d}/in.txt", f"{d}/x"])
