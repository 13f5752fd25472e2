"""HIGGS-scale end-to-end pipeline (parity: reference scripts/cpu_higgs.py —
CSV ingest → train/test split → logistic regression → accuracy).

Works on the real HIGGS csv (11M×29: label + 28 features) or, with
--synthetic, on generated data of the same shape scaled by --rows.

Usage:
  python scripts/higgs.py --csv /path/HIGGS.csv
  python scripts/higgs.py --synthetic --rows 1000000
"""

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--csv", default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--rows", type=int, default=1_000_000)
    parser.add_argument("--solver", default="newton")
    parser.add_argument("--max-iter", type=int, default=10)
    args = parser.parse_args(argv)

    import nums_tpu
    from nums_tpu.models.glms import LogisticRegression

    app = nums_tpu.init()

    t_ingest = time.time()
    t0 = t_ingest
    if args.csv:
        import os

        # Stage-separated: host parse throughput is the framework
        # claim (native C parser, parallel byte ranges); the
        # host->device feed is timed as its own stage.
        host = app.fs.read_csv_host(args.csv, num_workers=16)
        t_parse = time.time() - t0
        mb = os.path.getsize(args.csv) / 1e6
        print(
            f"parse: {t_parse:.2f}s  {mb:.0f} MB "
            f"({mb / t_parse:.0f} MB/s host CSV parse)", flush=True,
        )
        t0 = time.time()
        from nums_tpu.core.array.blockarray import BlockArray

        data = BlockArray.from_np(
            host[:, 1:].astype(np.float32, copy=False),
            block_shape=(
                max(1, host.shape[0] // max(1, app.backend.num_devices)),
                host.shape[1] - 1,
            ),
            backend=app.backend,
        )
        y = app.array(
            host[:, 0].astype(np.float32, copy=False),
            block_shape=(host.shape[0],),
        )
        X = data
        del host
        X.touch(), y.touch()
        print(f"device feed: {time.time()-t0:.2f}s "
              f"(transport-bound here)", flush=True)
    elif args.synthetic:
        n, d = args.rows, 28
        rs = app.random_state(42)
        X = rs.normal(shape=(n, d), block_shape=(
            max(1, n // max(1, app.backend.num_devices)), d))
        w = rs.normal(shape=(d,), block_shape=(d,))
        logits = X @ w
        y = (logits > 0).astype(np.float64)
    else:
        parser.error("pass --csv PATH or --synthetic")
    X.touch(), y.touch()
    print(f"ingest total: {time.time()-t_ingest:.2f}s  X={X.shape}",
          flush=True)

    n = X.shape[0]
    split = int(n * 0.8)
    X_train, y_train = X[:split], y[:split]
    X_test, y_test = X[split:], y[split:]

    t0 = time.time()
    model = LogisticRegression(solver=args.solver, tol=1e-8,
                               max_iter=args.max_iter)
    model.fit(X_train, y_train)
    print(f"train ({args.solver}): {time.time()-t0:.2f}s", flush=True)

    t0 = time.time()
    acc = float((model.predict(X_test) == y_test.astype(np.int64)).mean())
    print(f"predict (cold, incl. compile): {time.time()-t0:.2f}s  "
          f"test accuracy: {acc:.4f}", flush=True)
    t0 = time.time()
    acc = float((model.predict(X_test) == y_test.astype(np.int64)).mean())
    print(f"predict (warm): {time.time()-t0:.2f}s  "
          f"test accuracy: {acc:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
