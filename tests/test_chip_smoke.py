"""The GPU tier, ``chip_smoke.py``.

On the CPU: its phase functions at tiny sizes, the exact last line, the
refusal to run anywhere but a GPU, and ``--cards 4`` selecting only the
mesh phase. On a machine with a GPU, ``test_chip_smoke_on_gpu`` runs
the script itself (marker ``gpu``; it skips where no GPU is found).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

TINY = {
    "gram": (3001, 40),
    "newton": (4000, 20),
    "newton_iters": 3,
    "tsqr": (8192 + 5, 16),
    "ooc": (3000, 24),
    "ooc_panel_rows": 1000,
    "mesh": (4000, 24),
    "mesh_ragged": (4003, 24),
    "mesh_gemm": 256,
    "ref_chunk_rows": 1000,
}


def _child_env():
    """The environment a user shell would give the script (no CPU
    forcing from this test process)."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    return env


def _ok_except(checks, allowed=()):
    bad = [c for c in checks if not c["ok"] and c["check"] not in allowed]
    assert checks and not bad, bad


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    env = _child_env()
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    if probe.stdout.strip() != "gpu":
        pytest.skip("no GPU visible to JAX here")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=1500,
    )
    sys.stdout.write(proc.stdout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"


@pytest.mark.parametrize("ok", [True, False])
@pytest.mark.parametrize("info", [
    {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    {"platform": "cpu", "kind": "cpu", "count": 8},
])
def test_last_line_format(ok, info):
    line = cs.last_line(ok, dict(info, extra="dropped"))
    assert json.loads(line) == {"ok": ok, "device": info}
    assert "\n" not in line


def test_main_on_cpu_fails_without_running_phases(capsys):
    assert cs.main([]) == 1
    out = capsys.readouterr().out.strip().splitlines()
    last = json.loads(out[-1])
    assert last["ok"] is False
    assert last["device"]["platform"] == "cpu"
    assert set(last) == {"ok", "device"}
    phases = [json.loads(x).get("phase") for x in out if x.startswith("{")]
    assert set(phases) - {None} == {"device"}  # nothing ran past it
    assert not any("warm_s" in x for x in out)


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script must exit non-zero and print no ok result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok": true, "device"' not in lines[-1]


@pytest.mark.parametrize("cards,names", [
    (1, ["gram", "newton", "tsqr", "ooc", "surface"]),
    (4, ["mesh"]),
])
def test_cards_select_phases(cards, names):
    assert [n for n, _ in cs.phases_for(cards)] == names


def test_device_phase_wants_gpu_and_card_count():
    checks = cs.phase_device(None, TINY, None, want_cards=4)
    assert [c["ok"] for c in checks] == [False, True]  # cpu, 8 devices
    checks = cs.phase_device(None, TINY, None, want_cards=16)
    assert not checks[1]["ok"]


@pytest.mark.parametrize("seed", [0, 3, 21])
def test_formula_host_and_device_agree(seed):
    import jax.numpy as jnp

    i = np.arange(0, 70_000, 997, dtype=np.uint32)[:, None]
    j = np.arange(0, 1000, 37, dtype=np.uint32)[None, :]
    host = cs.formula(np, i, j, seed)
    dev = np.asarray(cs.formula(jnp, jnp.asarray(i), jnp.asarray(j), seed))
    np.testing.assert_array_equal(host, dev)
    got = np.asarray(cs.gen_matrix((2000, 30), seed=seed))
    rows = np.arange(2000, dtype=np.uint32)[:, None]
    cols = np.arange(30, dtype=np.uint32)[None, :]
    np.testing.assert_array_equal(got, cs.formula(np, rows, cols, seed))


def test_formula_rounds_down_in_tf32():
    """Every entry loses magnitude when its mantissa is cut to 10 bits,
    so a TF32 contraction is biased, not averaged out."""
    x = cs.formula(np, np.arange(5000, dtype=np.uint32)[:, None],
                   np.arange(64, dtype=np.uint32)[None, :])
    bits = x.view(np.uint32)
    low = bits & np.uint32((1 << 13) - 1)
    tf32 = (bits - low).view(np.float32)  # truncation
    rne = np.where(low > (1 << 12), tf32 + np.sign(x) * 2.0 ** -10, tf32)
    for r in (tf32, rne):
        assert np.all(np.abs(r) < np.abs(x))
    assert 0.45 < np.mean(x > 0) < 0.55
    assert np.all((np.abs(x) >= 1.0) & (np.abs(x) < 1.25))


@pytest.mark.parametrize("got,want,expect", [
    ([1.0, 2.0], [1.0, 2.0], 0.0),
    ([1.0, 2.5], [1.0, 2.0], 0.25),
    ([1.0], [1.0, 2.0], float("inf")),
    ([np.nan, 2.0], [1.0, 2.0], float("inf")),
])
def test_scaled_err(got, want, expect):
    assert cs.scaled_err(got, want) == expect


def test_roofline_names_the_bound():
    kind = "NVIDIA H100 80GB HBM3"
    r = cs.roofline(kind, 495e12, 3.35e12 / 10, 2.0, "tf32_flops")
    assert r["bound"] == "compute" and r["roofline_share"] == 0.5
    r = cs.roofline(kind, 1.0, 3.35e12, 4.0, "tf32_flops")
    assert r["bound"] == "memory" and r["roofline_share"] == 0.25
    r = cs.roofline("cpu", 1.0, 1.0, 1.0, "tf32_flops")
    assert r["roofline_share"] is None and "not in PEAKS" in r["peak"]


@pytest.mark.parametrize("n", [4000, 4003])
def test_chunked_reference_gram(n):
    import jax

    d = 12
    G = np.asarray(cs.chunked_reference(n, d, 1000,
                                        jax.lax.Precision.HIGHEST))
    X = cs.formula(np, np.arange(n, dtype=np.uint32)[:, None],
                   np.arange(d, dtype=np.uint32)[None, :]).astype(np.float64)
    assert cs.scaled_err(G, X.T @ X) < 1e-6


def test_chunked_reference_newton_matches_plain():
    import jax

    n, d = 3003, 10
    X = cs.gen_matrix((n, d))
    y = cs.gen_labels(X)
    hi = jax.lax.Precision.HIGHEST
    plain = np.asarray(cs.plain_newton(X, y, 2, hi))
    chunked = np.asarray(cs.chunked_reference(n, d, 1000, hi, iters=2))
    assert cs.scaled_err(chunked, plain) < 1e-5


@pytest.fixture()
def serial_app():
    from nums_tpu.core import application_manager, settings

    settings.backend_name = "serial"
    application_manager.destroy()
    app = application_manager.create()
    application_manager.set_instance(app)
    yield app
    application_manager.destroy()


def test_phase_gram_tiny(app_inst):
    _ok_except(cs.phase_gram(app_inst, TINY, None))


def test_phase_newton_tiny(app_inst):
    _ok_except(cs.phase_newton(app_inst, TINY, None))


def test_phase_tsqr_tiny(serial_app):
    _ok_except(cs.phase_tsqr(serial_app, TINY, None))


def test_phase_ooc_tiny(serial_app, tmp_path):
    """All checks pass on the CPU except memory_stats, which the CPU
    lacks: there it is a failing check, never a skip."""
    work = tmp_path / "work"
    checks = cs.phase_ooc(serial_app, TINY, str(work))
    _ok_except(checks, allowed={"memory_stats available"})
    assert [c["ok"] for c in checks
            if c["check"] == "memory_stats available"] == [False]
    assert not work.exists()


def test_phase_surface_tiny(serial_app):
    _ok_except(cs.phase_surface(serial_app, TINY, None))


def test_phase_mesh_on_four_virtual_devices():
    import jax

    from nums_tpu.core import application_manager
    from nums_tpu.core.array.application import ArrayApplication
    from nums_tpu.core.backend import MeshBackend
    from nums_tpu.core.io.filesystem import FileSystem

    backend = MeshBackend(devices=jax.devices()[:4]).init()
    app = ArrayApplication(backend, FileSystem(backend))
    application_manager.destroy()
    application_manager.set_instance(app)
    try:
        checks = cs.phase_mesh(app, TINY, None)
    finally:
        application_manager.destroy()
    _ok_except(checks)
    names = [c["check"] for c in checks]
    assert "ring schedule ran" in names and "summa schedule ran" in names
    shards = [c for c in checks if c["check"].endswith("shards on 4 devices")]
    assert len(shards) == 2 and all(len(c["device_set"]) == 4
                                    for c in shards)


def test_run_phase_turns_an_exception_into_a_failed_phase(capsys):
    def boom(app, cfg, workdir):
        raise RuntimeError("device lost")

    assert cs.run_phase("boom", boom, None, TINY, None) is False
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["phase"] == "boom" and rec["ok"] is False
    assert "device lost" in rec["error"]
