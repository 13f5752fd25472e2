"""Clustering: KMeans (Lloyd's) as ONE fused XLA program.

Beyond the reference (which has no clustering). Design notes:

- The distance matrix is computed as ||x||² − 2·X@Cᵀ + ||c||² — the
  O(n·k·d) term is a single GEMM per iteration.
- Center updates are one scatter-add (sums) + one scatter-add (counts).
- The whole fit is a ``lax.while_loop`` with an on-device shift test —
  zero host syncs until the final fetch (same design as fast_glm).
- k-means++ seeding, counter-based keys: same seed ⇒ same clustering on
  any backend/sharding.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
import jax.random as jr

from nums_tpu.core.application_manager import instance as _instance
from nums_tpu.core.array.blockarray import BlockArray

__all__ = ["KMeans"]


def _dists2(x, c):
    # (n, k) squared distances; the x·cᵀ term is the GEMM.
    xx = (x * x).sum(axis=1, keepdims=True)
    cc = (c * c).sum(axis=1)
    return jnp.maximum(xx - 2.0 * (x @ c.T) + cc[None, :], 0.0)


def _plusplus_init(k, key, x):
    n = x.shape[0]
    first = jr.randint(jr.fold_in(key, 0), (), 0, n)
    centers = jnp.zeros((k, x.shape[1]), x.dtype)
    centers = centers.at[0].set(x[first])

    def body(i, centers):
        d2 = _dists2(x, centers)
        # distance to the nearest ALREADY-CHOSEN center (j < i)
        chosen = jnp.arange(k) < i
        d2 = jnp.where(chosen[None, :], d2, jnp.inf).min(axis=1)
        # sample proportional to d² via the Gumbel-max trick
        # (jittable categorical without normalizing)
        logits = jnp.log(jnp.maximum(d2, 1e-30))
        gumbel = jr.gumbel(jr.fold_in(key, i), (n,), x.dtype)
        nxt = jnp.argmax(logits + gumbel)
        return centers.at[i].set(x[nxt])

    return jax.lax.fori_loop(1, k, body, centers)


@functools.lru_cache(maxsize=None)
def _seed_kernel(k: int):
    return jax.jit(lambda x, key: _plusplus_init(k, key, x))


@functools.lru_cache(maxsize=None)
def _ooc_stats_kernel():
    """Per-panel Lloyd statistics with DONATED accumulators; pad rows
    (mesh-sharded puts round rows up) are masked out via nv."""

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
    def k(sums, counts, inertia, panel, centers, nv):
        mask = (jnp.arange(panel.shape[0]) < nv).astype(panel.dtype)
        d2 = _dists2(panel, centers)
        assign = jnp.argmin(d2, axis=1)
        sums = sums.at[assign].add(panel * mask[:, None])
        counts = counts.at[assign].add(mask)
        inertia = inertia + (d2.min(axis=1) * mask).sum()
        return sums, counts, inertia

    return k


@functools.lru_cache(maxsize=None)
def _ooc_update_kernel():
    @jax.jit
    def k(centers, sums, counts):
        new = jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0),
            centers,
        )
        shift = jnp.sqrt(((new - centers) ** 2).sum(axis=1)).max()
        return new, shift

    return k


@functools.lru_cache(maxsize=None)
def _fit_kernel(k: int, max_iter: int, tol: float):
    def plusplus_init(key, x):
        return _plusplus_init(k, key, x)

    def fit(x, key):
        n, d = x.shape
        centers0 = plusplus_init(key, x)

        def cond(carry):
            it, _, shift = carry
            return jnp.logical_and(it < max_iter, shift > tol)

        def body(carry):
            it, centers, _ = carry
            assign = jnp.argmin(_dists2(x, centers), axis=1)
            sums = jnp.zeros((k, d), x.dtype).at[assign].add(x)
            counts = jnp.zeros((k,), x.dtype).at[assign].add(1.0)
            new = jnp.where(
                counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0),
                centers,  # empty cluster: keep previous center
            )
            shift = jnp.sqrt(((new - centers) ** 2).sum(axis=1)).max()
            return it + 1, new, shift

        it, centers, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), centers0, jnp.asarray(jnp.inf, x.dtype))
        )
        d2 = _dists2(x, centers)
        assign = jnp.argmin(d2, axis=1)
        inertia = d2.min(axis=1).sum()
        return centers, assign, inertia, it

    return jax.jit(fit)


@functools.lru_cache(maxsize=None)
def _predict_kernel():
    return jax.jit(lambda x, c: jnp.argmin(_dists2(x, c), axis=1))


class KMeans:
    def __init__(self, n_clusters=8, max_iter=100, tol=1e-4, seed=0):
        self.n_clusters = int(n_clusters)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.seed = int(seed)
        self.cluster_centers_ = None
        self.inertia_ = None
        self.n_iter_ = None

    def fit(self, X: BlockArray):
        from nums_tpu.core.array.diskarray import DiskArray

        if isinstance(X, DiskArray):
            return self._fit_ooc(X)
        app = _instance()
        X = X if isinstance(X, BlockArray) else app.array(np.asarray(X))
        xd = X.data.astype(jnp.float32)
        kern = _fit_kernel(self.n_clusters, self.max_iter, self.tol)
        centers, assign, inertia, it = kern(xd, jr.key(self.seed))
        self.cluster_centers_ = app.array(
            np.asarray(jax.device_get(centers))
        )
        self.inertia_ = float(inertia)
        self.n_iter_ = int(it)
        self._labels_data = assign
        # labels_ only needs the row grid + backend — pinning X itself
        # would keep the full training buffer alive on the model object.
        self._fit_grid = (X.shape[0], X.block_shape[0], X.backend)
        return self

    def _fit_ooc(self, X):
        """Streamed Lloyd's on a DiskArray: each iteration runs one pass
        over the row panels, accumulating per-cluster sums/counts with
        donated buffers. Seeding is k-means++ on the FIRST panel (the
        standard sample-seeded approach for out-of-core k-means); one
        scalar (shift) sync per pass. labels are produced on demand via
        ``predict(X, out=...)`` → a labels DiskArray."""
        import jax as _jax

        k = self.n_clusters
        first = next(iter(X.iter_row_panels(prefetch=False)))[1]
        sample = jnp.asarray(first, jnp.float32)
        assert sample.shape[0] >= k, "first panel smaller than n_clusters"
        from nums_tpu.core.array.application import (
            ooc_accumulator, ooc_panels, ooc_put,
        )

        backend = X.backend
        # Seeding runs per-process on the (identical) first panel; the
        # result is re-placed mesh-replicated so it can meet global
        # panels inside the jitted stats under multi-controller.
        centers = ooc_accumulator(
            backend, _seed_kernel(k)(sample, jr.key(self.seed))
        )
        stats = _ooc_stats_kernel()
        update = _ooc_update_kernel()
        d = X.shape[1]

        def one_pass(centers):
            sums = ooc_accumulator(backend, jnp.zeros((k, d), jnp.float32))
            counts = ooc_accumulator(backend, jnp.zeros((k,), jnp.float32))
            inertia = ooc_accumulator(backend, jnp.zeros((), jnp.float32))
            for _, panel in ooc_panels(X):
                p, nv = ooc_put(backend, panel)
                sums, counts, inertia = stats(
                    sums, counts, inertia, p.astype(jnp.float32),
                    centers, np.int32(nv),
                )
            return sums, counts, inertia

        it = 0
        for it in range(1, self.max_iter + 1):
            sums, counts, _ = one_pass(centers)
            centers, shift = update(centers, sums, counts)
            if float(shift) <= self.tol:
                break
        # Final inertia against the FINAL centers (sklearn semantics).
        _, _, inertia = one_pass(centers)
        app = _instance()
        self.cluster_centers_ = app.array(
            np.asarray(_jax.device_get(centers))
        )
        self.inertia_ = float(inertia)
        self.n_iter_ = int(it)
        self._labels_data = None
        self._fit_grid = None
        return self

    def predict_ooc(self, X, out: str = None):
        """Labels for a DiskArray, written as a 1-D int32 DiskArray."""
        from nums_tpu.core.array.diskarray import DiskArray

        assert self.cluster_centers_ is not None, "fit first"
        from nums_tpu.core import multiprocess as _mp
        from nums_tpu.core.array.application import ooc_panels, ooc_put

        backend = X.backend
        # Host centers: numpy jit inputs are auto-replicated under
        # multi-controller (a local jnp array could not meet the global
        # panel inside the kernel).
        centers = np.asarray(self.cluster_centers_.get(), np.float32)
        kern = _predict_kernel()
        out = out or X.path + ".labels"

        def panels():
            for _, panel in ooc_panels(X):
                p, nv = ooc_put(backend, panel)
                lab = kern(p.astype(jnp.float32), centers)
                host = (
                    _mp.allgather_to_host(lab) if _mp.is_multiprocess()
                    else np.asarray(lab)
                )
                yield host[:nv]

        return DiskArray.from_panels(
            out, X._fs, panels(), (X.shape[0],), np.int32,
            X.grid.block_shape[0],
        )

    @property
    def labels_(self):
        from nums_tpu.core.grid import ArrayGrid

        assert self._labels_data is not None, (
            "labels_ requires an in-core fit in this process; use "
            "predict(X) (in-core) or predict_ooc(X, out=...) instead."
        )
        n, block_rows, backend = self._fit_grid
        grid = ArrayGrid(
            (n,), (block_rows,), self._labels_data.dtype.name
        )
        return BlockArray(self._labels_data, grid, backend)

    def predict(self, X: BlockArray) -> BlockArray:
        assert self.cluster_centers_ is not None, "fit first"
        from nums_tpu.core.grid import ArrayGrid

        xd = X.data.astype(jnp.float32)
        out = _predict_kernel()(xd, self.cluster_centers_.data)
        grid = ArrayGrid((X.shape[0],), (X.block_shape[0],), out.dtype.name)
        return BlockArray(out, grid, X.backend)

    def fit_predict(self, X: BlockArray) -> BlockArray:
        from nums_tpu.core.array.diskarray import DiskArray

        if isinstance(X, DiskArray):
            return self.fit(X).predict_ooc(X)  # labels DiskArray
        return self.fit(X).labels_

    def save(self, path: str):
        from nums_tpu.models._common import save_model_arrays

        assert self.cluster_centers_ is not None, "fit before save"
        save_model_arrays(
            path,
            {"model": "KMeans", "n_clusters": self.n_clusters,
             "max_iter": self.max_iter, "tol": self.tol,
             "seed": self.seed, "inertia": self.inertia_,
             "n_iter": self.n_iter_},
            {"cluster_centers": self.cluster_centers_},
        )

    @classmethod
    def load(cls, path: str):
        from nums_tpu.models._common import load_model_arrays

        meta, arrays = load_model_arrays(path)
        assert meta["model"] == "KMeans", meta
        m = cls(n_clusters=meta["n_clusters"], max_iter=meta["max_iter"],
                tol=meta["tol"], seed=meta["seed"])
        m.cluster_centers_ = _instance().array(arrays["cluster_centers"])
        m.inertia_ = meta["inertia"]
        m.n_iter_ = meta["n_iter"]
        m._labels_data = None
        m._fit_grid = None
        return m
