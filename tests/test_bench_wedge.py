"""bench.py must survive a hang: a device runtime that stops answering
would otherwise leave a killed run with ZERO output. These tests run
the real bench.py in a subprocess on the CPU backend and simulate
deadline expiry / a mid-run hang."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FAST_ENV = {
    "NUMS_TPU_BENCH_PLATFORM": "cpu",  # in-process platform override
    "NUMS_TPU_BENCH_N": "20000",
    "NUMS_TPU_BENCH_D": "250",
    "NUMS_TPU_BENCH_REPS": "1",
    "NUMS_TPU_BENCH_SWEEPS": "3",
}


def _run(extra_env, timeout=240):
    env = {**os.environ, **_FAST_ENV, **extra_env}
    return subprocess.run(
        [sys.executable, "bench.py"], capture_output=True, text=True,
        timeout=timeout, cwd=REPO, env=env,
    )


def _final_json(out):
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out.stdout  # exactly ONE stdout JSON line
    return json.loads(lines[0])


def test_soft_deadline_emits_partial_json():
    """Deadline already expired when the first sweep finishes: bench
    must still emit a final JSON from that one sweep (>=1 guaranteed)."""
    out = _run({"NUMS_TPU_BENCH_DEADLINE_S": "0",
                "NUMS_TPU_BENCH_HARD_DEADLINE_S": "600"})
    assert out.returncode == 0, out.stderr[-2000:]
    rec = _final_json(out)
    assert rec["sweeps_completed"] == 1
    assert rec["partial"] is True
    assert rec["vs_baseline"] > 0
    assert rec["unit"] == "s"
    # Progress diagnostics went to stderr at every stage.
    stages = [json.loads(ln)["progress"]
              for ln in out.stderr.splitlines()
              if ln.startswith("{\"progress\"")]
    for stage in ("start", "init-done", "warmup-done", "sweep-done"):
        assert stage in stages, stages


def test_watchdog_emits_json_on_midrun_hang():
    """The hard watchdog: a hang AFTER one sweep (simulating a wedged
    device call) must still produce the final JSON and exit 0 instead
    of idling until the driver's SIGKILL."""
    out = _run({
        "NUMS_TPU_BENCH_DEADLINE_S": "600",
        "NUMS_TPU_BENCH_HARD_DEADLINE_S": "40",
        "NUMS_TPU_BENCH_TEST_HANG": "after_sweep",
    }, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = _final_json(out)
    assert rec["sweeps_completed"] >= 1
    assert rec["partial"] is True
    stages = [json.loads(ln)["progress"]
              for ln in out.stderr.splitlines()
              if ln.startswith("{\"progress\"")]
    assert "watchdog-partial-emit" in stages, stages


def test_normal_run_is_complete():
    out = _run({})
    assert out.returncode == 0, out.stderr[-2000:]
    rec = _final_json(out)
    assert rec["sweeps_completed"] == 3
    assert "partial" not in rec
    assert rec["metric"] == "xTx_N20000_d250_fp32_seconds"
