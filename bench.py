"""Headline benchmark: x.T @ x, N×1000 fp32 (reference benchmark 1).

Reference: scripts/benchmark_bop.py:97-161; baselines in BASELINE.md.
At N=2,500,000 the best reference config (CupyNcclActorSystem, 2 nodes /
8 GPUs, NCCL p2p) measures 0.0714 s. This benchmark runs the same
computation through the nums_tpu BlockArray path on the local device.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": speedup}
``value``/``vs_baseline`` are the MEDIAN of ``NUMS_TPU_BENCH_SWEEPS``
independent sweeps (default 5); ``min_s``/``p90_s``/``sweep_s`` carry
the distribution so run-to-run spread is an artifact, not an assertion.
Each sweep times ``NUMS_TPU_BENCH_REPS`` calls, each ending in
``block_until_ready``. The line also records the device kind and the
``nvidia-smi`` name and power limit. vs_baseline > 1.0 means faster
than the reference's best 8-GPU result.

Deadline defense (a device runtime that stops answering would
otherwise leave a killed run with zero output):

* Progress JSON lines go to **stderr** immediately after start, init,
  warmup, and every sweep, so a killed run still leaves a diagnosis of
  where it died.
* A **soft deadline** (``NUMS_TPU_BENCH_DEADLINE_S``, default 600 s)
  stops the sweep loop early and emits the final JSON from however
  many sweeps completed (always >= 1: the check runs after a sweep).
* A **hard watchdog** (``NUMS_TPU_BENCH_HARD_DEADLINE_S``, default
  soft + 180 s) runs in a daemon thread: if the process is still alive
  at the hard deadline it emits the final JSON from any completed
  sweeps and exits 0 — or, with zero sweeps, prints a loud diagnosis
  and exits 3 — instead of idling until an outer SIGKILL.

``NUMS_TPU_BENCH_PLATFORM=cpu`` forces the CPU backend in-process —
used by the simulated-timeout tests.
"""

import json
import os
import sys
import threading
import time

import numpy as np

_START = time.perf_counter()


def _elapsed():
    return time.perf_counter() - _START


def _progress(stage, **extra):
    rec = {"progress": stage, "elapsed_s": round(_elapsed(), 1)}
    rec.update(extra)
    print(json.dumps(rec), file=sys.stderr, flush=True)


class _State:
    """Shared between the main thread and the watchdog: enough to emit
    a valid final JSON line from whatever work completed."""

    def __init__(self, n, d):
        self.lock = threading.Lock()
        self.emitted = False
        self.sweep_times = []
        self.n = n
        self.d = d
        self.meta = {}

    def payload(self, partial):
        times = sorted(self.sweep_times)
        t = float(np.median(times))
        p90 = times[min(len(times) - 1, int(round(0.9 * (len(times) - 1))))]
        n, d = self.n, self.d
        baseline = 0.0714 * (n / 2_500_000)  # linear-scale 8-GPU baseline
        result = {
            "metric": f"xTx_N{n}_d{d}_fp32_seconds",
            "value": round(t, 5),
            "unit": "s",
            "vs_baseline": round(baseline / t, 3),
            "tflops": round(2.0 * n * d * d / t / 1e12, 1),
            "min_s": round(times[0], 5),
            "p90_s": round(p90, 5),
            "sweep_s": [round(x, 5) for x in times],
            "sweeps_completed": len(times),
            "baseline": "CupyNcclActorSystem 8xGPU (reference result_bop.csv)",
        }
        result.update(self.meta)
        if partial:
            result["partial"] = True
        return result

    def emit(self, partial=False):
        # The print happens INSIDE the lock: the watchdog calls
        # os._exit right after emit(), so `emitted` must never be
        # observable as True before the JSON actually reached stdout
        # (otherwise a hard-deadline _exit could land between the
        # main thread's flag-set and its print, erasing the output).
        with self.lock:
            if self.emitted:
                return False
            self.emitted = True
            print(json.dumps(self.payload(partial)), flush=True)
        return True


def _watchdog(state, hard_deadline_s):
    time.sleep(max(0.0, hard_deadline_s - _elapsed()))
    if state.emitted:
        return
    if state.sweep_times:
        _progress("watchdog-partial-emit",
                  sweeps=len(state.sweep_times))
        state.emit(partial=True)
        os._exit(0)
    _progress("watchdog-no-results")
    print(
        f"bench.py: hard deadline {hard_deadline_s:.0f}s reached with "
        "ZERO completed sweeps (device init/compile likely wedged); "
        "see progress lines above for the last completed stage",
        file=sys.stderr, flush=True,
    )
    os._exit(3)


def main():
    n = int(os.environ.get("NUMS_TPU_BENCH_N", 2_500_000))
    d = int(os.environ.get("NUMS_TPU_BENCH_D", 1000))
    reps = int(os.environ.get("NUMS_TPU_BENCH_REPS", 5))
    sweeps = int(os.environ.get("NUMS_TPU_BENCH_SWEEPS", 5))
    soft_s = float(os.environ.get("NUMS_TPU_BENCH_DEADLINE_S", 600))
    hard_s = float(os.environ.get(
        "NUMS_TPU_BENCH_HARD_DEADLINE_S", soft_s + 180
    ))
    test_hang = os.environ.get("NUMS_TPU_BENCH_TEST_HANG", "")

    state = _State(n, d)
    threading.Thread(
        target=_watchdog, args=(state, hard_s), daemon=True
    ).start()
    _progress("start", n=n, d=d, sweeps=sweeps,
              soft_deadline_s=soft_s, hard_deadline_s=hard_s)

    import jax

    if os.environ.get("NUMS_TPU_BENCH_PLATFORM"):
        jax.config.update(
            "jax_platforms", os.environ["NUMS_TPU_BENCH_PLATFORM"]
        )

    import nums_tpu
    from nums_tpu.core import settings
    from nums_tpu.core.array.blockarray import BlockArray
    from nums_tpu.core.grid import ArrayGrid
    from chip_smoke import TOL_TF32, nvidia_smi

    app = nums_tpu.init()
    backend = app.backend
    dev = jax.devices()[0]
    state.meta["device"] = str(dev)
    state.meta["device_kind"] = dev.device_kind
    state.meta["nvidia_smi"] = nvidia_smi()
    state.meta["matmul_precision"] = settings.matmul_precision
    _progress("init-done", device=state.meta["device"])

    # Deterministic fp32 data generated on-device in ONE buffer (sampling
    # via jax.random would transiently hold 2x = 20GB at this N).
    import jax.numpy as jnp

    def build():
        @jax.jit
        def gen():
            i = jax.lax.broadcasted_iota(jnp.float32, (n, d), 0)
            j = jax.lax.broadcasted_iota(jnp.float32, (n, d), 1)
            return jnp.sin(i * 1e-5) + jnp.cos(j * 0.37) * 0.5

        block_rows = max(1, n // max(1, backend.num_devices))
        grid = ArrayGrid((n, d), (block_rows, d), "float32")
        return BlockArray(gen(), grid, backend)

    def warmup_and_guard(X):
        # Compile + warmup, then a one-time numerics guard on the
        # headline op: spot-check G entries against a float64 host
        # oracle from the generator formula, at the TF32 class of XLA's
        # default f32 matmul precision on the GPU.
        Zc = (X.T @ X).raw
        i64 = np.arange(n, dtype=np.float64)
        for a, b in ((0, 0), (0, d - 1), (d - 1, d - 1)):
            ca = np.sin(i64 * 1e-5) + np.cos(a * 0.37) * 0.5
            cb = np.sin(i64 * 1e-5) + np.cos(b * 0.37) * 0.5
            oracle = float(ca @ cb)
            got = float(Zc[a, b])
            assert abs(got - oracle) / abs(oracle) < TOL_TF32, (
                a, b, got, oracle,
            )

    X = build()
    warmup_and_guard(X)
    _progress("warmup-done")

    def one_sweep():
        # .raw forces the lazy expression into dispatch; every call
        # ends in block_until_ready.
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready((X.T @ X).raw)
        return (time.perf_counter() - t0) / reps

    partial = False
    for i in range(max(1, sweeps)):
        t = one_sweep()
        state.sweep_times.append(t)
        _progress("sweep-done", i=i, s=round(t, 5))
        if test_hang == "after_sweep":
            _progress("test-hang")
            time.sleep(10_000)
        # Deadline check AFTER the sweep: at least one always completes.
        if _elapsed() > soft_s and i + 1 < max(1, sweeps):
            _progress("soft-deadline", completed=i + 1)
            partial = True
            break

    state.emit(partial=partial)
    return 0


if __name__ == "__main__":
    sys.exit(main())
