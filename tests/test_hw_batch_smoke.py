"""CPU smoke of the benchmark scripts' modes.

A latent script crash would waste a run on the device. Each mode here
runs tiny shapes in-process on the CPU backend — these validate
plumbing (arg parsing, CSV schema), not performance. bench.py itself is
covered by tests/test_bench_wedge.py and the interleave/device-resident
modes by tests/test_bench_interleave.
"""

import csv
import sys

import pytest


def _mod(name):
    sys.path.insert(0, ".")
    import importlib

    return importlib.import_module(f"scripts.{name}")


@pytest.fixture()
def serial_app():
    from nums_tpu.core import application_manager, settings

    settings.backend_name = "serial"
    application_manager.destroy()
    app = application_manager.create()
    application_manager.set_instance(app)
    yield app
    application_manager.destroy()


def test_benchmark_lr_smoke(tmp_path, serial_app):
    lr = _mod("benchmark_lr")
    out = str(tmp_path / "lr.csv")
    assert lr.main(["--out", out, "--ns", "1024", "-d", "32"]) == 0
    rows = list(csv.DictReader(open(out)))
    assert rows and float(rows[0]["min_s"]) > 0


def test_benchmark_bop_default_smoke(tmp_path, serial_app):
    bop = _mod("benchmark_bop")
    out = str(tmp_path / "bop.csv")
    assert bop.main(["--out", out, "--ns", "1024", "-d", "32"]) == 0
    rows = list(csv.DictReader(open(out)))
    assert rows and float(rows[0]["min_s"]) > 0


@pytest.mark.slow
def test_benchmark_models_smoke(tmp_path, serial_app):
    bm = _mod("benchmark_models")
    out = str(tmp_path / "models.csv")
    assert bm.main(["--smoke", "--out", out]) == 0
    assert list(csv.DictReader(open(out)))
