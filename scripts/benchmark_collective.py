"""Collective-matmul microbench: auto-SPMD vs hand-scheduled schedules.

Records per-schedule timings (auto XLA partitioning, explicit SUMMA,
double-buffered ppermute ring, TN reduce-scatter) for a sweep of GEMM
shapes on the CURRENT mesh, so a tuning round on real device links
starts with a harness instead of a blank page. On a virtual CPU mesh the absolute
numbers are meaningless but the harness, shardings, and CSV schema are
exercised end to end:

  NUMS_TPU_BACKEND=mesh python scripts/benchmark_collective.py \
      --cpu-devices 8 --reps 2

(`--cpu-devices` forces the virtual CPU mesh in-process, whatever
platform the environment would pick.) On real multi-device hardware run without the flag to get the
ring-vs-auto crossover table that drives a future auto-selection
heuristic (ROADMAP perf #1).
"""

import argparse
import os
import sys
import time


def _time(fn, sync, reps):
    fn()  # compile + warmup
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(out)
    return (time.perf_counter() - t0) / reps


def main(argv=None):
    sys.path.insert(0, ".")
    from scripts.utils import append_csv

    parser = argparse.ArgumentParser()
    parser.add_argument("--sizes", default="1024,2048,4096")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--out", default="result_collective.csv")
    parser.add_argument("--cpu-devices", type=int, default=0,
                        help="force an N-device virtual CPU mesh "
                             "(in-process; overrides the default platform)")
    args = parser.parse_args(argv)

    if args.cpu_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count="
                f"{args.cpu_devices}"
            ).strip()

    import jax

    if args.cpu_devices:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import nums_tpu
    from nums_tpu.core.ops import summa

    app = nums_tpu.init()
    be = app.backend
    if be.mesh is None:
        print("mesh backend required (NUMS_TPU_BACKEND=mesh)")
        return 1
    mesh = be.mesh
    p = be.device_grid.mesh_shape[0]
    dtype = jnp.dtype(args.dtype)

    auto = jax.jit(jnp.matmul)
    tn_auto = jax.jit(lambda a, b: jnp.matmul(a.T, b))

    for n in (int(s) for s in args.sizes.split(",")):
        if n % p:
            print(f"skip n={n} (not divisible by mesh axis {p})")
            continue
        key = jax.random.PRNGKey(0)
        a = jax.device_put(
            jax.random.normal(key, (n, n), jnp.float32).astype(dtype),
            NamedSharding(mesh, P("m0", None)),
        )
        b = jax.device_put(
            jax.random.normal(key, (n, n), jnp.float32).astype(dtype),
            NamedSharding(mesh, P("m0", None)),
        )

        def sync(x=None):
            (x if x is not None else a).block_until_ready()

        rows = {"n": n, "dtype": args.dtype, "mesh": "x".join(
            str(s) for s in be.device_grid.mesh_shape)}
        rows["auto_s"] = round(_time(lambda: auto(a, b), sync, args.reps), 5)
        if summa.ring_supported(be, a.shape, b.shape):
            ring = summa.ring_matmul(be)
            rows["ring_s"] = round(
                _time(lambda: ring(a, b), sync, args.reps), 5)
        if summa.supported(be, a.shape, b.shape):
            sm = summa.summa_matmul(be)
            a2 = jax.device_put(a, be.sharding_for_shape((n, n)))
            b2 = jax.device_put(b, be.sharding_for_shape((n, n)))
            rows["summa_s"] = round(
                _time(lambda: sm(a2, b2), sync, args.reps), 5)
        if summa.tn_supported(be, a.shape, b.shape):
            tn = summa.tn_matmul(be)
            rows["tn_auto_s"] = round(
                _time(lambda: tn_auto(a, b), sync, args.reps), 5)
            rows["tn_s"] = round(
                _time(lambda: tn(a, b), sync, args.reps), 5)
        print(rows)
        append_csv(args.out, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
