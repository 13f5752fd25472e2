"""TSQR benchmark at the north-star scale (BASELINE.md: 2^24×128
tall-skinny; reference analogue: application.py:772-933).

Times R-only (indirect_tsr) and full Q,R (direct_tsqr / CholeskyQR2).

Usage: python scripts/benchmark_tsqr.py [--m 16777216] [--n 128]
"""

import argparse
import sys


import jax
import jax.numpy as jnp


def main(argv=None):
    sys.path.insert(0, ".")
    from scripts.utils import benchmark_ready, append_csv

    parser = argparse.ArgumentParser()
    parser.add_argument("--m", type=int, default=2**24)
    parser.add_argument("--n", type=int, default=128)
    parser.add_argument("--out", default="result_tsqr.csv")
    args = parser.parse_args(argv)

    import nums_tpu
    from nums_tpu.core.array.blockarray import BlockArray

    app = nums_tpu.init()
    m, n = args.m, args.n

    @jax.jit
    def gen():
        i = jax.lax.broadcasted_iota(jnp.float32, (m, n), 0)
        j = jax.lax.broadcasted_iota(jnp.float32, (m, n), 1)
        # Distinct-frequency sinusoid per column: full-rank, well-conditioned
        # (a separable generator would be rank-3 and break factorizations).
        return jnp.sin(i * (7e-4 + 1e-5 * j) + 0.3 * j)

    block_rows = max(1, m // max(1, app.backend.num_devices))
    X = BlockArray.from_jax(gen(), block_shape=(block_rows, n),
                            backend=app.backend)

    tmin, tmean, _ = benchmark_ready(lambda: app.indirect_tsr(X).raw)
    print(f"indirect_tsr (R only) {m}x{n}: min {tmin:.4f}s mean {tmean:.4f}s")
    append_csv(args.out, {"op": "indirect_tsr", "m": m, "n": n,
                          "min_s": round(tmin, 5)})

    # When 2x X won't fit HBM, use the donating in-place variant (X is
    # consumed; chained re-runs then factorize the previous Q — same
    # shapes/flops, so timing stays representative).
    overwrite = 2 * X.nbytes > 12e9
    try:
        tmin, tmean, _ = benchmark_ready(
            lambda: tuple(
                a.raw for a in app.direct_tsqr(X, overwrite_x=overwrite)
            ),
            repeat=3,
        )
        print(f"direct_tsqr (Q,R) {m}x{n}: min {tmin:.4f}s mean {tmean:.4f}s")
        append_csv(args.out, {"op": "direct_tsqr", "m": m, "n": n,
                              "min_s": round(tmin, 5)})
    except Exception as e:
        print(f"direct_tsqr FAILED ({type(e).__name__}) — needs 2x X in HBM")
        append_csv(args.out, {"op": "direct_tsqr", "m": m, "n": n,
                              "min_s": -1.0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
