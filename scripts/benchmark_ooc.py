"""Out-of-core benchmark rows: xTx and 1-step Newton LR at N >= 5M.

The reference posts these rows on 8 GPUs holding the whole matrix in
device memory (`scripts/result_bop.csv` rows 5M-20M there). Here they
run through the OOC subsystem: the design matrix lives on disk as a
DiskArray and panels stream through the device with O(panel +
accumulator) device memory.

Two modes per op (both recorded in ``result_ooc.csv``):

- ``device``: panels are GENERATED on-device inside one scanned program
  — the device-resident per-pass figure (what the accumulate path
  sustains when the feed keeps up).
- ``disk``: the real end-to-end DiskArray path, host feed included.

Usage:
  python scripts/benchmark_ooc.py --n 5000000 --op gram --mode device
  python scripts/benchmark_ooc.py --n 5000000 --op lr --mode disk
"""

import argparse
import os
import shutil
import sys
import time

import numpy as np


def _gen_host_panel(start, rows, d, dtype):
    """Deterministic data: column j is a SAWTOOTH with its own
    irrational-step frequency, so columns are near-orthogonal and the
    design matrix is full rank with a healthy spectrum (measured
    cond(H) <= 3 across widths/offsets incl. the mod wrap — the Newton
    solve stays far above single-pass-MAC noise at any N). Two earlier
    forms each failed one requirement: the round-3 shared-frequency
    sawtooth had near-duplicate columns (H singular by construction),
    and a per-column SINUSOID fixed that but cost one transcendental
    per element, which dominated the very accumulate path the benchmark
    claims to measure."""
    i = (np.arange(start, start + rows, dtype=np.float32)[:, None]
         % 104729.0)
    j = np.arange(d, dtype=np.float32)[None, :]
    return (
        ((i * (0.6180339887 + j * 7.3e-4) + j * 0.2516) % 1.0) - 0.5
    ).astype(dtype)


def main(argv=None):
    sys.path.insert(0, ".")
    from scripts.utils import append_csv

    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=5_000_000)
    parser.add_argument("--d", type=int, default=1000)
    parser.add_argument("--op", choices=["gram", "lr"], default="gram")
    parser.add_argument("--mode", choices=["device", "disk"],
                        default="device")
    parser.add_argument("--panel-rows", type=int, default=250_000)
    parser.add_argument("--out", default="result_ooc.csv")
    parser.add_argument("--keep-disk", action="store_true")
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import nums_tpu

    app = nums_tpu.init()
    n, d, rows = args.n, args.d, args.panel_rows
    assert n % rows == 0, (n, rows)
    k_panels = n // rows
    dtype = jnp.float32

    if args.mode == "device":
        # One program: scan over panels generated in-kernel; measures
        # the pure accumulate path (gen cost is a few % of the GEMM).


        def gen_panel(pi, width, intercept=False):
            """Panel of ``width`` data columns (plus an intercept column
            if asked); the formula matches ``_gen_host_panel``
            column-for-column so device and disk modes compute the same
            statistics."""
            w = width + (1 if intercept else 0)
            i = (pi * rows + jax.lax.broadcasted_iota(
                jnp.float32, (rows, w), 0)) % 104729.0
            j = jax.lax.broadcasted_iota(jnp.float32, (rows, w), 1)
            vals = ((i * (0.6180339887 + j * 7.3e-4) + j * 0.2516)
                    % 1.0) - 0.5
            if intercept:
                jj = jax.lax.broadcasted_iota(jnp.int32, (rows, w), 1)
                vals = jnp.where(jj == width, 1.0, vals)
            return vals

        if args.op == "gram":

            @jax.jit
            def run():
                def body(G, pi):
                    p = gen_panel(pi, d)
                    return G + p.T @ p, None
                G, _ = jax.lax.scan(
                    body, jnp.zeros((d, d), dtype),
                    jnp.arange(k_panels, dtype=jnp.float32),
                )
                return G

        else:  # one Newton step of logistic regression
            da_ = d + 1

            @jax.jit
            def run():
                beta = jnp.zeros((da_,), dtype)

                def body(carry, pi):
                    g, H = carry
                    pa = gen_panel(pi, d, intercept=True)
                    eta = pa @ beta
                    mu = jax.nn.sigmoid(eta)
                    # beta is zeros here, so eta = 0 and the synthetic
                    # label y = (eta > 0) is identically zero.
                    y = (eta > 0).astype(dtype)
                    s = mu * (1.0 - mu)
                    g = g + pa.T @ (mu - y)
                    H = H + (pa * s[:, None]).T @ pa
                    return (g, H), None

                (g, H), _ = jax.lax.scan(
                    body,
                    (jnp.zeros((da_,), dtype),
                     jnp.zeros((da_, da_), dtype)),
                    jnp.arange(k_panels, dtype=jnp.float32),
                )
                ridge = 1e-6 * (jnp.trace(H) / da_ + 1.0)
                L = jnp.linalg.cholesky(
                    H + ridge * jnp.eye(da_, dtype=dtype))
                step = jax.scipy.linalg.cho_solve((L, True), g)
                return beta - step

        jax.block_until_ready(run())  # compile + warmup
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        t = time.perf_counter() - t0
        note = "device-resident per-pass (panels generated on device)"
    else:
        from nums_tpu.core.array.diskarray import DiskArray

        path = os.path.join(
            os.environ.get("NUMS_TPU_OOC_DIR", "/tmp/nums_tpu_ooc"),
            f"bench_{n}_{d}",
        )
        if not os.path.isdir(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            print(f"writing {n}x{d} fp32 DiskArray to {path} ...",
                  flush=True)
            panels = (
                _gen_host_panel(s, rows, d, np.float32)
                for s in range(0, n, rows)
            )
            DiskArray.from_panels(
                path, app.fs, panels, (n, d), np.float32, rows)
        da = app.open_fs(path)
        t0 = time.perf_counter()
        if args.op == "gram":
            jax.block_until_ready(app.gram_ooc(da).raw)
        else:
            from nums_tpu.models import fast_glm

            y = (np.arange(n) % 2).astype(np.float32)
            beta, gmax, _ = fast_glm.newton_fit_ooc(
                da, y, tol=0.0, kind="logistic", max_iter=1)
            jax.block_until_ready(beta)
        t = time.perf_counter() - t0
        note = "end-to-end DiskArray (host feed included)"
        if not args.keep_disk:
            shutil.rmtree(path, ignore_errors=True)

    # Both ops are dominated by one (d, n) @ (n, d) contraction per pass
    # (gram: XᵀX; LR: XᵀSX — the forward/gradient GEMVs are O(nd)).
    flops = 2.0 * n * d * d
    row = {
        "op": args.op, "N": n, "d": d, "mode": args.mode,
        "seconds": round(t, 4),
        "tflops": round(flops / t / 1e12, 1),
        "note": note,
    }
    print(row)
    append_csv(args.out, row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
