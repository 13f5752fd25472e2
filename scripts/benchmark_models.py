"""North-star rows for the beyond-reference models:
histogram GBDT (HIGGS-scale synthetic) and randomized SVD.

The reference has NO working trees model (nums/models/trees.py is an
empty file) and its SVD is a single-node fan-in (application.py:935-954
there), so these rows have no reference baseline — they make the
"beyond parity" claims auditable with measured numbers.

CSV schema: model,op,n,d,param,seconds,note
Run on the device: python scripts/benchmark_models.py
Schema smoke on CPU: --smoke
"""

import argparse
import os
import sys
import time


def main(argv=None):
    sys.path.insert(0, ".")
    from scripts.utils import append_csv

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="result_models.csv")
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--gbdt-n", type=int, default=1_000_000)
    parser.add_argument("--svd-n", type=int, default=2**21)
    parser.add_argument("--svd-d", type=int, default=1024)
    parser.add_argument("--svd-k", type=int, default=64)
    args = parser.parse_args(argv)

    if args.smoke:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=1"
            ).strip()

    import jax

    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
        args.gbdt_n = 20_000
        args.svd_n, args.svd_d, args.svd_k = 8192, 256, 16

    import jax.numpy as jnp
    import numpy as np

    import nums_tpu
    from nums_tpu.core.grid import ArrayGrid
    from nums_tpu.core.array.blockarray import BlockArray

    app = nums_tpu.init()
    backend = app.backend

    def record(model, op, n, d, param, seconds, note=""):
        append_csv(args.out, {
            "model": model, "op": op, "n": n, "d": d, "param": param,
            "seconds": round(seconds, 4), "note": note,
        })
        print(f"{model:14s} {op:8s} n={n:<9d} d={d:<5d} param={param} "
              f"{seconds:.4f}s {note}")

    def from_gen(gen_fn, n, d):
        pshape = backend.physical_shape((n, d))

        @jax.jit
        def gen():
            i = jax.lax.broadcasted_iota(jnp.float32, pshape, 0)
            j = jax.lax.broadcasted_iota(jnp.float32, pshape, 1)
            v = gen_fn(i, j)
            if pshape != (n, d):
                v = jnp.where((i < n) & (j < d), v, 0.0)
            return v

        rows = max(1, n // max(1, backend.num_devices))
        return BlockArray(gen(), ArrayGrid((n, d), (rows, d), "float32"),
                          backend)

    # --- GBDT: HIGGS-shaped synthetic (n x 28, nonlinear decision
    # boundary so trees actually earn their splits).
    n, d = args.gbdt_n, 28
    X = from_gen(
        lambda i, j: jnp.sin(i * 7e-4 + j * 0.7)
        + jnp.cos(i * 1.3e-3) * 0.5, n, d,
    )
    yv = (jnp.sin(X.data[:, 0] * 3.0) + X.data[:, 5] * X.data[:, 11]
          > 0.2).astype(jnp.float32)
    y = BlockArray(yv, ArrayGrid((n,), (X.grid.block_shape[0],),
                                 "float32"), backend)

    from nums_tpu.models.trees import GBTClassifier

    model = GBTClassifier(n_estimators=20, max_depth=4, n_bins=64,
                          learning_rate=0.3)
    t0 = time.perf_counter()
    model.fit(X, y)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = model.predict(X)
    acc = float((pred.data == yv).mean())  # syncs the predict
    pred_s = time.perf_counter() - t0
    record("gbdt", "fit", n, d, "trees=20xd4", fit_s,
           f"train acc {acc:.3f} (incl. compile)")
    record("gbdt", "predict", n, d, "trees=20xd4", pred_s,
           "incl. compile")
    assert acc > 0.8, acc
    # Warm rows: same shapes hit the whole-fit/predict program caches —
    # the steady-state numbers (the cold rows are dominated by the
    # remote compile of the 20-tree fused program).
    model2 = GBTClassifier(n_estimators=20, max_depth=4, n_bins=64,
                           learning_rate=0.3)
    t0 = time.perf_counter()
    model2.fit(X, y)
    float(np.asarray(model2._trees[2]).ravel()[0])  # sync the fit
    record("gbdt", "fit", n, d, "trees=20xd4",
           time.perf_counter() - t0, "warm")
    t0 = time.perf_counter()
    acc2 = float((model2.predict(X).data == yv).mean())
    record("gbdt", "predict", n, d, "trees=20xd4",
           time.perf_counter() - t0, "warm")
    assert acc2 > 0.8, acc2
    del X, y, model, model2, pred

    # --- Randomized SVD: both dims large, top-k.
    n, d, k = args.svd_n, args.svd_d, args.svd_k
    X = from_gen(
        lambda i, j: jnp.sin(i * 7e-6) * jnp.cos(j * 0.11)
        + 0.1 * jnp.sin(i * 1.3e-5 + j * 0.37), n, d,
    )
    # warmup/compile at full shape, then timed run
    for rep, note in ((0, "compile+run"), (1, "warm")):
        t0 = time.perf_counter()
        U, S, VT = app.randomized_svd(X, k, n_iter=2, seed=rep)
        s_host = np.asarray(S.data)  # sync
        dt = time.perf_counter() - t0
        record("randomized_svd", "fit", n, d, f"k={k}", dt, note)
    # Rank-revealing sanity: generator is near rank-2, so σ_3 << σ_1.
    assert s_host[0] > 0 and s_host[2] / s_host[0] < 0.5, s_host[:4]
    return 0


if __name__ == "__main__":
    sys.exit(main())
