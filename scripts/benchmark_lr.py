"""One-step Newton logistic regression benchmark
(parity: reference scripts/benchmark_lr.py:56-150).

Times one full Newton step (forward + gradient + Hessian + solve) on
N×1000 fp32 data, via the fused train step (nums_tpu.models.fast_glm) —
the equivalent of the reference's hand-written per-system step.

Usage: python scripts/benchmark_lr.py [--out result_lr.csv]
"""

import argparse
import sys

import numpy as np

import jax
import jax.numpy as jnp


def main(argv=None):
    sys.path.insert(0, ".")
    from scripts.utils import benchmark_ready, append_csv
    from nums_tpu.models.fast_glm import logistic_newton_step_jit

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="result_lr.csv")
    parser.add_argument("-d", type=int, default=1000)
    parser.add_argument(
        "--ns", default="125000,250000,500000,750000,1250000,2500000"
    )
    args = parser.parse_args(argv)

    import nums_tpu

    nums_tpu.init()
    d = args.d
    for n in [int(x) for x in args.ns.split(",")]:
        try:
            @jax.jit
            def gen(n=n):
                i = jax.lax.broadcasted_iota(jnp.float32, (n, d), 0)
                j = jax.lax.broadcasted_iota(jnp.float32, (n, d), 1)
                X = jnp.sin(i * 1e-5) + jnp.cos(j * 0.37) * 0.5
                y = (jnp.sin(i[:, 0] * 0.77) > 0).astype(jnp.float32)
                return X, y

            X, y = gen()
            beta = jnp.zeros((d,), jnp.float32)
            tmin, tmean, tstd = benchmark_ready(
                lambda: logistic_newton_step_jit(X, y, beta)
            )
            del X, y
        except Exception as e:
            print(f"N={n}: FAILED ({type(e).__name__})")
            append_csv(args.out, {"N": n, "d": d, "min_s": -1.0,
                                  "mean_s": -1.0, "std_s": -1.0})
            continue
        print(f"N={n}: min {tmin:.4f}s mean {tmean:.4f}s")
        append_csv(args.out, {"N": n, "d": d, "min_s": round(tmin, 5),
                              "mean_s": round(tmean, 5),
                              "std_s": round(tstd, 5)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
