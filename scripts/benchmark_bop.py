"""x.T @ x sweep (parity: reference scripts/benchmark_bop.py:97-161).

Sweeps N with d=1000 fp32 and records wall-clock seconds per N to CSV,
comparable row-for-row with the reference's result_bop.csv.

Usage: python scripts/benchmark_bop.py [--out result_bop.csv]
"""

import argparse
import sys

import numpy as np

import jax
import jax.numpy as jnp


def make_x(n, d, backend):
    """Deterministic fp32 X generated on the device (same construction
    as bench.py)."""
    from nums_tpu.core.array.blockarray import BlockArray
    from nums_tpu.core.grid import ArrayGrid

    @jax.jit
    def gen():
        i = jax.lax.broadcasted_iota(jnp.float32, (n, d), 0)
        j = jax.lax.broadcasted_iota(jnp.float32, (n, d), 1)
        return jnp.sin(i * 1e-5) + jnp.cos(j * 0.37) * 0.5

    block_rows = max(1, n // max(1, backend.num_devices))
    grid = ArrayGrid((n, d), (block_rows, d), "float32")
    return BlockArray(gen(), grid, backend)


def interleave(args, app):
    """Interleaved same-device A/B: the identical xTx through (a) a raw
    ``jax.jit`` kernel on the BlockArray's own buffer and (b) the full
    BlockArray lazy-dispatch path.

    Path sweeps ALTERNATE (a,b,a,b,...) so device drift lands on both
    paths equally and the delta isolates framework dispatch overhead.
    Both paths ride the same XLA dot_general. Each call in a sweep ends
    in ``block_until_ready``.
    """
    import time

    from scripts.utils import append_csv

    d = args.d
    chain = args.chain

    def one_sweep(run):
        t0 = time.perf_counter()
        for _ in range(chain):
            jax.block_until_ready(run())
        return (time.perf_counter() - t0) / chain

    for n in [int(x) for x in args.ns.split(",")]:
        try:
            X = make_x(n, d, app.backend)
        except Exception as e:  # OOM etc: skip the N, keep the batch
            print(f"N={n}: build FAILED ({type(e).__name__})")
            continue
        pure = jax.jit(lambda a: jnp.matmul(a.T, a))

        def enq_pure():
            return pure(X.data)

        def enq_block():
            return (X.T @ X).raw

        jax.block_until_ready(enq_pure())  # compile + warmup both paths
        jax.block_until_ready(enq_block())
        t_pure, t_block = [], []
        for _ in range(args.reps):
            t_pure.append(one_sweep(enq_pure))
            t_block.append(one_sweep(enq_block))
        del X
        for path, times in (("pure_jax", t_pure), ("blockarray", t_block)):
            row = {
                "mode": "interleave", "N": n, "d": d, "path": path,
                "median_s": round(float(np.median(times)), 5),
                "min_s": round(float(np.min(times)), 5),
                "sweeps_s": ";".join(f"{t:.5f}" for t in times),
                "chain": chain,
            }
            append_csv(args.out, row)
            print(f"N={n} {path}: median {row['median_s']}s "
                  f"min {row['min_s']}s")
        overhead = np.median(t_block) / np.median(t_pure) - 1.0
        print(f"N={n}: BlockArray dispatch overhead {overhead * 100:+.2f}%")
    return 0


def device_resident(args, app):
    """In-program loop timing of the gram.

    Runs the gram inside ONE jitted ``fori_loop`` so the per-iteration
    cost excludes every host-side overhead (dispatch, the scalar
    fetch). Two defenses keep the measurement honest:

    * the gram input passes through ``lax.optimization_barrier``
      BUNDLED with the loop carry, so its per-iteration value depends
      on the carry and XLA cannot hoist the dot out of the loop (an
      identity fence — no copy, unlike carrying the 10 GB matrix in
      the loop state, which would double HBM and OOM at N=2.5M); the
      body consumes ``sum(G)`` (a [0,0] probe could legally be
      rewritten to a sliced dot);
    * per-iteration time is the DIFFERENCE quotient between a long and a
      short loop — (T(hi) - T(lo)) / (hi - lo) — which cancels the
      fixed costs (the input copy into the loop state, dispatch, and
      the fetch) that a single-loop average would smear in.
    """
    import time

    from scripts.utils import append_csv

    d = args.d
    lo, hi = args.iters_lo, args.iters_hi
    assert hi > lo > 0

    def loop_fn(op, iters):
        @jax.jit
        def run(X):
            def body(_, acc):
                Xc, acc = jax.lax.optimization_barrier((X, acc))
                G = op(Xc)
                return acc + jnp.sum(G).astype(jnp.float32)

            return jax.lax.fori_loop(0, iters, body, jnp.float32(0.0))

        return run

    for n in [int(x) for x in args.ns.split(",")]:
        try:
            X = make_x(n, d, app.backend).raw
        except Exception as e:  # OOM etc: skip the N, keep the batch
            print(f"N={n}: build FAILED ({type(e).__name__})")
            continue
        pn, pd = X.shape
        for route, op in (("xla", lambda a: jnp.matmul(a.T, a)),):
            try:
                run_lo, run_hi = loop_fn(op, lo), loop_fn(op, hi)
                float(run_lo(X)), float(run_hi(X))  # compile + warmup
                t_lo, t_hi = [], []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    float(run_lo(X))
                    t_lo.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    float(run_hi(X))
                    t_hi.append(time.perf_counter() - t0)
            except Exception as e:  # per-route isolation for the batch
                print(f"N={n} {route}: FAILED ({type(e).__name__})")
                continue
            per_iter = (float(np.median(t_hi)) - float(np.median(t_lo))) \
                / (hi - lo)
            row = {
                "mode": "device_resident", "N": n, "d": d,
                "phys_n": pn, "phys_d": pd, "route": route,
                "iters_lo": lo, "iters_hi": hi,
                "t_lo_median_s": round(float(np.median(t_lo)), 5),
                "t_hi_median_s": round(float(np.median(t_hi)), 5),
                "per_iter_s": round(per_iter, 6), "reps": args.reps,
            }
            append_csv(args.out, row)
            tf = 2.0 * pn * pd * pd / max(per_iter, 1e-12) / 1e12
            print(f"N={n} {route}: {per_iter * 1e3:.3f} ms/iter "
                  f"({tf:.1f} TFLOP/s)")
        del X
    return 0


def main(argv=None):
    sys.path.insert(0, ".")
    from scripts.utils import benchmark_ready, append_csv

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    parser.add_argument("-d", type=int, default=1000)
    parser.add_argument(
        "--ns", default="125000,250000,1250000,2500000",
        help="comma-separated N values",
    )
    parser.add_argument(
        "--interleave", action="store_true",
        help="alternating pure-jax vs BlockArray A/B rows "
             "(dispatch-overhead artifact; separate default CSV)",
    )
    parser.add_argument(
        "--device-resident", action="store_true",
        help="in-program fori_loop gram per route "
             "(device-resident throughput artifact; separate default CSV)",
    )
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--chain", type=int, default=5,
                        help="calls per interleave sweep")
    parser.add_argument("--iters-lo", type=int, default=5)
    parser.add_argument("--iters-hi", type=int, default=20)
    args = parser.parse_args(argv)
    if args.out is None:
        args.out = ("result_interleave.csv" if args.interleave
                    else "result_device_resident.csv"
                    if args.device_resident else "result_bop.csv")

    import nums_tpu

    app = nums_tpu.init()
    if args.interleave:
        return interleave(args, app)
    if args.device_resident:
        return device_resident(args, app)
    d = args.d
    for n in [int(x) for x in args.ns.split(",")]:
        try:
            X = make_x(n, d, app.backend)

            # .raw forces the lazy expression into dispatch.
            tmin, tmean, tstd = benchmark_ready(lambda: (X.T @ X).raw)
            del X
        except Exception as e:  # OOM etc: record failure like the reference
            print(f"N={n}: FAILED ({type(e).__name__})")
            append_csv(args.out, {"N": n, "d": d, "min_s": -1.0,
                                  "mean_s": -1.0, "std_s": -1.0})
            continue
        flops = 2.0 * n * d * d
        print(
            f"N={n}: min {tmin:.4f}s mean {tmean:.4f}s "
            f"({flops / tmin / 1e12:.1f} TFLOP/s)"
        )
        append_csv(args.out, {"N": n, "d": d, "min_s": round(tmin, 5),
                              "mean_s": round(tmean, 5),
                              "std_s": round(tstd, 5)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
