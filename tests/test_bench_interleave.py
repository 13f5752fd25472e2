"""benchmark_bop --interleave: the pure-jax vs BlockArray A/B artifact
(the dispatch-overhead table must trace to a CSV; this mode generates
it) and --device-resident."""

import csv
import sys

import pytest


@pytest.fixture()
def app_serial():
    from nums_tpu.core import application_manager, settings

    settings.backend_name = "serial"
    application_manager.destroy()
    app = application_manager.create()
    application_manager.set_instance(app)
    yield app
    application_manager.destroy()


def _bop():
    sys.path.insert(0, ".")
    from scripts import benchmark_bop

    return benchmark_bop


def test_interleave_writes_both_paths(tmp_path, app_serial):
    bop = _bop()
    out = str(tmp_path / "interleave.csv")
    rc = bop.main([
        "--interleave", "--out", out, "--ns", "512,256", "-d", "8",
        "--reps", "2", "--chain", "2",
    ])
    assert rc == 0
    rows = list(csv.DictReader(open(out)))
    # two Ns x two paths, interleaved per N
    assert [(r["N"], r["path"]) for r in rows] == [
        ("512", "pure_jax"), ("512", "blockarray"),
        ("256", "pure_jax"), ("256", "blockarray"),
    ]
    for r in rows:
        assert r["mode"] == "interleave"
        assert float(r["median_s"]) > 0.0
        assert float(r["min_s"]) > 0.0
        sweeps = [float(x) for x in r["sweeps_s"].split(";")]
        assert len(sweeps) == 2 and min(sweeps) > 0.0
        assert set(r) == {"mode", "N", "d", "path", "median_s", "min_s",
                          "sweeps_s", "chain"}


def test_device_resident_rows_per_route(tmp_path, app_serial):
    """--device-resident writes one XLA row per N with a positive
    difference-quotient per-iteration time, at the logical width."""
    bop = _bop()
    out = str(tmp_path / "dr.csv")
    rc = bop.main([
        "--device-resident", "--out", out, "--ns", "512", "-d", "128",
        "--reps", "1", "--iters-lo", "2", "--iters-hi", "4",
    ])
    assert rc == 0
    rows = list(csv.DictReader(open(out)))
    assert [r["route"] for r in rows] == ["xla"]
    for r in rows:
        assert r["mode"] == "device_resident"
        assert float(r["t_hi_median_s"]) > 0.0
        assert int(r["phys_d"]) == 128


def test_interleave_default_out_is_separate_csv(tmp_path, app_serial,
                                                monkeypatch):
    """Without --out the interleave rows must land in their own CSV,
    never schema-polluting result_bop.csv."""
    bop = _bop()
    monkeypatch.chdir(tmp_path)
    # keep scripts importable from the new cwd
    rc = bop.main(["--interleave", "--ns", "64", "-d", "8",
                   "--reps", "1", "--chain", "1"])
    assert rc == 0
    assert (tmp_path / "result_interleave.csv").exists()
    assert not (tmp_path / "result_bop.csv").exists()
