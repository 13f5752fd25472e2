"""Gradient-boosted trees (histogram GBDT, oblivious trees).

The reference ships an empty placeholder (``nums/models/trees.py`` is a
license header only); this implements the family for real, designed for
the hardware rather than ported:

- **Oblivious (symmetric) trees**: every level applies ONE shared
  (feature, bin-threshold) split, so a depth-D tree is a decision table
  with 2^D leaves and a sample's leaf index is D vectorized comparisons
  — no data-dependent control flow, perfectly jittable/SPMD.
- **Histogram splits**: per-level (leaf × feature × bin) gradient and
  hessian histograms built with ONE scatter-add over the whole (sharded)
  sample axis; split gain is a closed-form cumsum scan over the
  histogram (second-order/XGBoost-style gain with L2 regularization).
- **Whole-training-run fusion**: fit compiles to one XLA program
  (``lax.fori_loop`` over boosting rounds, unrolled static depth) — the
  same zero-sync design as ``fast_glm``.

Objectives: squared error (regression) and logistic (binary
classification), both with exact Newton leaf values.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp

from nums_tpu.core.application_manager import instance as _instance
from nums_tpu.core.array.blockarray import BlockArray

__all__ = ["GBTRegressor", "GBTClassifier", "GradientBoostedTrees"]


def _quantile_edges(x, n_bins):
    """(n_bins-1, d) per-feature bin edges from quantiles."""
    qs = jnp.linspace(0.0, 100.0, n_bins + 1)[1:-1]
    return jnp.percentile(x, qs, axis=0)


def _bin_features(x, edges):
    """(n, d) int32 bin ids: vmapped binary search per feature."""
    return jax.vmap(
        lambda col, e: jnp.searchsorted(e, col), in_axes=(1, 1), out_axes=1
    )(x, edges).astype(jnp.int32)


@functools.lru_cache(maxsize=None)
def _train_kernel(n_estimators, max_depth, n_bins, objective,
                  learning_rate, reg_lambda):
    # base_score is a TRACED argument (not part of this key): it is
    # data-dependent (y.mean()), so keying on it would recompile and
    # permanently cache one program per dataset.
    n_leaves = 1 << max_depth
    lr = float(learning_rate)
    lam = float(reg_lambda)

    def grad_hess(pred, y):
        if objective == "logistic":
            p = jax.nn.sigmoid(pred)
            return p - y, p * (1.0 - p)
        return pred - y, jnp.ones_like(pred)  # squared error

    def train(xb, y, base_score):
        n, d = xb.shape
        flat_cols = jnp.arange(d, dtype=jnp.int32)  # (d,)

        def one_round(carry, _):
            pred, = carry
            g, h = grad_hess(pred, y)
            leaf = jnp.zeros(n, jnp.int32)
            feats = jnp.zeros(max_depth, jnp.int32)
            cuts = jnp.zeros(max_depth, jnp.int32)

            for lvl in range(max_depth):
                width = 1 << lvl
                # One scatter-add builds every (leaf, feature, bin) cell:
                # index (n, d) -> flat (leaf*d + j)*n_bins + bin.
                idx = (
                    (leaf[:, None] * d + flat_cols[None, :]) * n_bins + xb
                ).reshape(-1)
                size = width * d * n_bins
                gh = jnp.zeros((size, 2), jnp.float32)
                vals = jnp.stack(
                    [
                        jnp.broadcast_to(g[:, None], (n, d)).reshape(-1),
                        jnp.broadcast_to(h[:, None], (n, d)).reshape(-1),
                    ],
                    axis=1,
                )
                gh = gh.at[idx].add(vals)
                gh = gh.reshape(width, d, n_bins, 2)
                cum_g = jnp.cumsum(gh[..., 0], axis=2)  # (L, d, B)
                cum_h = jnp.cumsum(gh[..., 1], axis=2)
                tot_g = cum_g[..., -1:]
                tot_h = cum_h[..., -1:]
                gl, hl = cum_g, cum_h
                gr, hr = tot_g - cum_g, tot_h - cum_h
                gain = (
                    gl**2 / (hl + lam)
                    + gr**2 / (hr + lam)
                    - tot_g**2 / (tot_h + lam)
                )  # (L, d, B)
                # Oblivious: one (feature, bin) shared by all level leaves.
                level_gain = gain.sum(axis=0).reshape(-1)  # (d*B,)
                best = jnp.argmax(level_gain)
                j = (best // n_bins).astype(jnp.int32)
                b = (best % n_bins).astype(jnp.int32)
                feats = feats.at[lvl].set(j)
                cuts = cuts.at[lvl].set(b)
                go_right = (jnp.take(xb, j, axis=1) > b).astype(jnp.int32)
                leaf = leaf * 2 + go_right

            # Newton leaf values from per-leaf grad/hess sums.
            gs = jnp.zeros(n_leaves, jnp.float32).at[leaf].add(g)
            hs = jnp.zeros(n_leaves, jnp.float32).at[leaf].add(h)
            leaf_vals = -lr * gs / (hs + lam)
            pred = pred + leaf_vals[leaf]
            return (pred,), (feats, cuts, leaf_vals)

        pred0 = jnp.full(n, base_score, jnp.float32)
        (pred,), (feats, cuts, leaf_vals) = jax.lax.scan(
            one_round, (pred0,), None, length=n_estimators
        )
        return feats, cuts, leaf_vals, pred

    return jax.jit(train)


@functools.lru_cache(maxsize=None)
def _predict_kernel(max_depth):
    def predict(xb, base_score, feats, cuts, leaf_vals):
        n = xb.shape[0]

        def one_tree(pred, tree):
            f, c, lv = tree
            leaf = jnp.zeros(n, jnp.int32)
            for lvl in range(max_depth):
                go_right = (
                    jnp.take(xb, f[lvl], axis=1) > c[lvl]
                ).astype(jnp.int32)
                leaf = leaf * 2 + go_right
            return pred + lv[leaf], None

        pred0 = jnp.full(n, base_score, jnp.float32)
        pred, _ = jax.lax.scan(one_tree, pred0, (feats, cuts, leaf_vals))
        return pred

    return jax.jit(predict)


class GradientBoostedTrees:
    """Histogram GBDT over BlockArrays; fit/predict are single XLA
    programs (compare: the reference's model layer issues one Ray task
    per block per op)."""

    def __init__(self, objective="squared", n_estimators=20, max_depth=4,
                 learning_rate=0.2, n_bins=64, reg_lambda=1.0):
        assert objective in ("squared", "logistic"), objective
        assert 1 <= max_depth <= 10
        self.objective = objective
        self.n_estimators = int(n_estimators)
        self.max_depth = int(max_depth)
        self.learning_rate = float(learning_rate)
        self.n_bins = int(n_bins)
        self.reg_lambda = float(reg_lambda)
        self._edges = None
        self._trees = None
        self._base = 0.0

    def fit(self, X: BlockArray, y: BlockArray, _binned=None):
        """``_binned=(edges, xb)`` lets one-vs-rest ensembles share the
        y-independent quantile edges + int binning across members
        instead of recomputing identical full-data passes per class."""
        app = _instance()
        X = X if isinstance(X, BlockArray) else app.array(np.asarray(X))
        y = y if isinstance(y, BlockArray) else app.array(np.asarray(y))
        yd = y.data.astype(jnp.float32)
        self._base = 0.0 if self.objective == "logistic" else float(
            yd.mean()
        )
        if _binned is not None:
            self._edges, xb = _binned
        else:
            xd = X.data.astype(jnp.float32)
            self._edges = _quantile_edges(xd, self.n_bins)
            xb = _bin_features(xd, self._edges)
        kern = _train_kernel(
            self.n_estimators, self.max_depth, self.n_bins, self.objective,
            self.learning_rate, self.reg_lambda,
        )
        feats, cuts, leaf_vals, _ = kern(
            xb, yd, jnp.float32(self._base)
        )
        self._trees = (feats, cuts, leaf_vals)
        return self

    def _raw_predict(self, X: BlockArray, _xb=None):
        assert self._trees is not None, "fit must be called before predict"
        if _xb is None:
            xd = X.data.astype(jnp.float32)
            _xb = _bin_features(xd, self._edges)
        kern = _predict_kernel(self.max_depth)
        return kern(_xb, jnp.float32(self._base), *self._trees)

    def _wrap(self, X, data):
        from nums_tpu.core.grid import ArrayGrid

        grid = ArrayGrid(
            (X.shape[0],), (X.block_shape[0],), data.dtype.name
        )
        return BlockArray(data, grid, X.backend)

    def predict(self, X: BlockArray) -> BlockArray:
        pred = self._raw_predict(X)
        if self.objective == "logistic":
            pred = (jax.nn.sigmoid(pred) > 0.5).astype(jnp.int64)
        return self._wrap(X, pred)

    def predict_proba(self, X: BlockArray) -> BlockArray:
        assert self.objective == "logistic"
        return self._wrap(X, jax.nn.sigmoid(self._raw_predict(X)))

    def save(self, path: str):
        from nums_tpu.models._common import save_model_arrays

        assert self._trees is not None, "fit before save"
        feats, cuts, leaf_vals = self._trees
        save_model_arrays(
            path,
            {"model": type(self).__name__, "objective": self.objective,
             "n_estimators": self.n_estimators,
             "max_depth": self.max_depth,
             "learning_rate": self.learning_rate, "n_bins": self.n_bins,
             "reg_lambda": self.reg_lambda, "base": self._base},
            {"edges": np.asarray(self._edges),
             "feats": np.asarray(feats), "cuts": np.asarray(cuts),
             "leaf_vals": np.asarray(leaf_vals)},
        )

    @classmethod
    def load(cls, path: str):
        from nums_tpu.models._common import load_model_arrays

        meta, arrays = load_model_arrays(path)
        m = cls(objective=meta["objective"],
                n_estimators=meta["n_estimators"],
                max_depth=meta["max_depth"],
                learning_rate=meta["learning_rate"],
                n_bins=meta["n_bins"], reg_lambda=meta["reg_lambda"])
        m._base = meta["base"]
        m._edges = jnp.asarray(arrays["edges"])
        m._trees = (
            jnp.asarray(arrays["feats"]), jnp.asarray(arrays["cuts"]),
            jnp.asarray(arrays["leaf_vals"]),
        )
        return m


class GBTRegressor(GradientBoostedTrees):
    def __init__(self, **kwargs):
        kwargs.setdefault("objective", "squared")
        super().__init__(**kwargs)


class GBTClassifier(GradientBoostedTrees):
    """Binary natively; MULTICLASS via one-vs-rest (one booster per
    class, sigmoid scores normalized, argmax decision — sklearn's OvR
    semantics). ``classes_`` carries the original labels."""

    def __init__(self, **kwargs):
        kwargs.setdefault("objective", "logistic")
        super().__init__(**kwargs)
        self.classes_ = None
        self._ovr = None

    def _params(self):
        return dict(
            objective="logistic", n_estimators=self.n_estimators,
            max_depth=self.max_depth, learning_rate=self.learning_rate,
            n_bins=self.n_bins, reg_lambda=self.reg_lambda,
        )

    def fit(self, X, y):
        app = _instance()
        X = X if isinstance(X, BlockArray) else app.array(np.asarray(X))
        y_host = np.asarray(y.get() if hasattr(y, "get") else y)
        self.classes_ = np.unique(y_host)
        if len(self.classes_) < 2:
            raise ValueError(
                "y contains a single class; classification needs >= 2."
            )
        bs = (X.block_shape[0],)
        if len(self.classes_) <= 2:
            self._ovr = None
            yb = (y_host == self.classes_[-1]).astype(np.float64)
            super().fit(X, app.array(yb, block_shape=bs))
            return self
        # Edges + binning depend only on X: compute once and share
        # across the per-class members (k-1 fewer full-data passes).
        xd = X.data.astype(jnp.float32)
        edges = _quantile_edges(xd, self.n_bins)
        xb = _bin_features(xd, edges)
        self._ovr = []
        for c in self.classes_:
            m = GradientBoostedTrees(**self._params())
            m.fit(X, app.array(
                (y_host == c).astype(np.float64), block_shape=bs
            ), _binned=(edges, xb))
            self._ovr.append(m)
        return self

    def predict(self, X):
        app = _instance()
        X = X if isinstance(X, BlockArray) else app.array(np.asarray(X))
        if self._ovr is None:
            idx = super().predict(X).get()
        else:
            xb = _bin_features(
                X.data.astype(jnp.float32), self._ovr[0]._edges
            )  # members share edges — bin once, not once per member
            scores = np.stack(
                [np.asarray(jax.device_get(
                    jax.nn.sigmoid(m._raw_predict(X, _xb=xb))
                )) for m in self._ovr], axis=1,
            )
            idx = scores.argmax(axis=1)
        return app.array(
            self.classes_[idx], block_shape=(X.block_shape[0],)
        )

    def predict_proba(self, X):
        app = _instance()
        X = X if isinstance(X, BlockArray) else app.array(np.asarray(X))
        if self._ovr is None:
            p1 = np.asarray(jax.device_get(
                jax.nn.sigmoid(self._raw_predict(X))
            ))
            out = np.stack([1.0 - p1, p1], axis=1)
        else:
            xb = _bin_features(
                X.data.astype(jnp.float32), self._ovr[0]._edges
            )
            scores = np.stack(
                [np.asarray(jax.device_get(
                    jax.nn.sigmoid(m._raw_predict(X, _xb=xb))
                )) for m in self._ovr], axis=1,
            )
            out = scores / scores.sum(axis=1, keepdims=True)
        return app.array(out, block_shape=(X.block_shape[0], out.shape[1]))

    def save(self, path: str):
        from nums_tpu.models._common import save_model_arrays

        if self._ovr is None:
            assert self._trees is not None, "fit before save"
            feats, cuts, leaf_vals = self._trees
            save_model_arrays(
                path,
                {**self._params(), "model": "GBTClassifier",
                 "classes": np.asarray(self.classes_).tolist(),
                 "base": self._base},
                {"edges": np.asarray(self._edges),
                 "feats": np.asarray(feats), "cuts": np.asarray(cuts),
                 "leaf_vals": np.asarray(leaf_vals)},
            )
            return
        arrays = {}
        for i, m in enumerate(self._ovr):
            f, c, lv = m._trees
            arrays[f"edges{i}"] = np.asarray(m._edges)
            arrays[f"feats{i}"] = np.asarray(f)
            arrays[f"cuts{i}"] = np.asarray(c)
            arrays[f"leaf_vals{i}"] = np.asarray(lv)
        save_model_arrays(
            path,
            {**self._params(), "model": "GBTClassifier",
             "classes": np.asarray(self.classes_).tolist(), "base": 0.0},
            arrays,
        )

    @classmethod
    def load(cls, path: str):
        from nums_tpu.models._common import load_model_arrays

        meta, arrays = load_model_arrays(path)
        assert meta["model"] == "GBTClassifier", meta
        m = cls(n_estimators=meta["n_estimators"],
                max_depth=meta["max_depth"],
                learning_rate=meta["learning_rate"],
                n_bins=meta["n_bins"], reg_lambda=meta["reg_lambda"])
        m.classes_ = np.asarray(meta["classes"])
        if "edges" in arrays:  # binary
            m._base = meta["base"]
            m._edges = jnp.asarray(arrays["edges"])
            m._trees = (
                jnp.asarray(arrays["feats"]), jnp.asarray(arrays["cuts"]),
                jnp.asarray(arrays["leaf_vals"]),
            )
            m._ovr = None
            return m
        m._ovr = []
        k = len(m.classes_)
        for i in range(k):
            sub = GradientBoostedTrees(**m._params())
            sub._base = 0.0
            sub._edges = jnp.asarray(arrays[f"edges{i}"])
            sub._trees = (
                jnp.asarray(arrays[f"feats{i}"]),
                jnp.asarray(arrays[f"cuts{i}"]),
                jnp.asarray(arrays[f"leaf_vals{i}"]),
            )
            m._ovr.append(sub)
        return m
