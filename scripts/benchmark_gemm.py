"""Square blocked-GEMM benchmark at 32k x 32k (the BASELINE.md GEMM
target).

Usage: python scripts/benchmark_gemm.py [--n 32768] [--dtype bfloat16|float32]
"""

import argparse
import sys

import jax
import jax.numpy as jnp


def main(argv=None):
    sys.path.insert(0, ".")
    from scripts.utils import benchmark_ready, append_csv

    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=32768)
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--out", default="result_gemm.csv")
    parser.add_argument("--repeat", type=int, default=10)
    args = parser.parse_args(argv)

    import nums_tpu
    from nums_tpu.core.array.blockarray import BlockArray

    app = nums_tpu.init()
    n = args.n
    dtype = jnp.dtype(args.dtype)

    @jax.jit
    def gen(seed):
        i = jax.lax.broadcasted_iota(jnp.float32, (n, n), 0)
        j = jax.lax.broadcasted_iota(jnp.float32, (n, n), 1)
        return (jnp.sin(i * (1e-4 + seed) + j * 0.7) * 0.1).astype(dtype)

    block = max(1, n // max(1, app.backend.num_devices))
    A = BlockArray.from_jax(gen(0.0), block_shape=(block, n), backend=app.backend)
    B = BlockArray.from_jax(gen(1e-5), block_shape=(block, n), backend=app.backend)

    # .raw forces dispatch (lazy mode). Best-of and the median are both
    # recorded.
    tmin, tmean, _, tmed = benchmark_ready(
        lambda: (A @ B).raw, repeat=args.repeat, with_median=True,
    )
    flops = 2.0 * n * n * n
    tflops = flops / tmin / 1e12
    kind = jax.devices()[0].device_kind
    print(f"GEMM {n}x{n} {args.dtype} on {kind}: min {tmin:.4f}s "
          f"median {tmed:.4f}s  {tflops:.1f} TFLOP/s")
    append_csv(args.out, {"n": n, "dtype": args.dtype,
                          "min_s": round(tmin, 5),
                          "median_s": round(tmed, 5),
                          "tflops": round(tflops, 1),
                          "device_kind": kind,
                          "repeat": args.repeat})
    return 0


if __name__ == "__main__":
    sys.exit(main())
