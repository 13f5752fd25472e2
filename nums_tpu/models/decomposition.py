"""Dimensionality reduction: PCA and TruncatedSVD.

Beyond the reference's model zoo (it ships GLMs plus an empty trees
placeholder; no decomposition models), but a natural fit here: both
models ride the distributed tall-skinny SVD
(``ArrayApplication.svd`` → TSQR/CholeskyQR2 tree, the framework's
linalg north star), so fitting an (n, d) matrix with n ≫ d costs one
streamed pass over X — per-shard panel factorizations + a d×d SVD of R
— with no n×n or host-side materialization anywhere. All derived ops
(centering, projection, reconstruction) are BlockArray expressions:
they fuse through lazy batching and run on either backend.

sklearn-compatible surface: fit / transform / fit_transform /
inverse_transform, components_, explained_variance_(ratio_),
singular_values_, mean_, whiten.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp

from nums_tpu.core.application_manager import instance as _instance
from nums_tpu.core.array.blockarray import BlockArray
from nums_tpu.models._common import _to_ba


@functools.lru_cache(maxsize=None)
def _project_kernel():
    """(panel - shift) @ comps.T / scale, one jitted program per panel.
    Pad rows (mesh-sharded ooc_put rounds rows up) project to garbage
    that the caller slices away with the n_valid count."""
    return jax.jit(
        lambda p, comps, shift, scale:
            ((p - shift[None, :]) @ comps.T) / scale[None, :]
    )


@functools.lru_cache(maxsize=None)
def _flip_kernel():
    """Deterministic sign convention (sklearn's svd_flip, u-based):
    each left-singular column's max-|.| entry is made positive; vt rows
    flip to match so u @ diag(s) @ vt is unchanged."""

    def k(u, vt):
        idx = jnp.argmax(jnp.abs(u), axis=0)
        signs = jnp.sign(u[idx, jnp.arange(u.shape[1])])
        signs = jnp.where(signs == 0, 1.0, signs).astype(u.dtype)
        return u * signs[None, :], vt * signs[:, None]

    return jax.jit(k)


class _BaseSVDModel:
    def __init__(self, n_components=None, svd_solver="full",
                 n_oversamples=10, power_iters=2, seed=0):
        assert svd_solver in ("full", "randomized"), svd_solver
        self.n_components = n_components
        self.svd_solver = svd_solver
        self.n_oversamples = int(n_oversamples)
        self.power_iters = int(power_iters)
        self.seed = int(seed)
        self.components_ = None
        self.singular_values_ = None
        self.explained_variance_ = None
        self.explained_variance_ratio_ = None
        self.n_components_ = None
        self.n_samples_ = None

    def _svd(self, X, k):
        """Distributed SVD with the deterministic sign fix — exact
        (TSQR tree) by default, or the Halko randomized sketch
        (``svd_solver='randomized'``) returning exactly k triplets when
        both dimensions are large."""
        app = _instance()
        if self.svd_solver == "randomized" and k < min(X.shape):
            u, s, vt = app.randomized_svd(
                X, k, n_oversamples=self.n_oversamples,
                n_iter=self.power_iters, seed=self.seed,
            )
        else:
            u, s, vt = app.svd(X)
        ud, vtd = _flip_kernel()(u.data, vt.data)
        u = BlockArray.from_jax(
            ud, block_shape=u.block_shape, backend=u.backend
        )
        vt = BlockArray.from_jax(
            vtd, block_shape=vt.block_shape, backend=vt.backend
        )
        return u, s, vt

    def _resolve_k(self, X):
        k = self.n_components
        if k is None:
            k = min(X.shape)
        k = int(k)
        assert 1 <= k <= min(X.shape), (k, X.shape)
        return k

    def fit(self, X):
        from nums_tpu.core.array.diskarray import DiskArray

        if isinstance(X, DiskArray):
            self._fit_ooc(X)
            return self
        self._fit(_to_ba(X))
        return self

    def fit_transform(self, X):
        from nums_tpu.core.array.diskarray import DiskArray

        if isinstance(X, DiskArray):
            self._fit_ooc(X)
            return self.transform(X)  # second streamed pass
        X = _to_ba(X)
        u, s = self._fit(X)
        # u[:, :k] * s[:k] — already computed by the fit's SVD; no second
        # pass over X.
        k = self.n_components_
        return u[:, :k] * s[:k]

    def transform(self, X, out: str = None):
        """Project onto the components. An out-of-core ``X`` streams row
        panels and writes the (n, k) result as a new DiskArray at
        ``out`` (default: ``<X.path>.transformed``)."""
        assert self.components_ is not None, "fit must be called first"
        from nums_tpu.core.array.diskarray import DiskArray

        if isinstance(X, DiskArray):
            return self._transform_ooc(X, out)
        X = _to_ba(X)
        return self._center(X) @ self.components_.T

    def inverse_transform(self, X):
        assert self.components_ is not None, "fit must be called first"
        X = _to_ba(X)
        return self._uncenter(X @ self.components_)

    # -- out-of-core paths (gram/covariance eigendecomposition) --------

    def _moments_ooc(self, X):
        """ONE streamed pass → host (XᵀX, column means): both moments
        accumulate in the same per-panel kernel (disk IO is the
        dominant cost of an out-of-core fit — never read twice). Panels
        row-shard over the mesh (zero pad rows are gram/sum-neutral)."""
        import jax as _jax
        import jax.numpy as jnp

        from nums_tpu.core.array.application import (
            ooc_accumulator, ooc_panels, ooc_put,
        )
        from nums_tpu.core.ops import streaming

        backend = X.backend
        d = X.shape[1]
        dtype = jnp.asarray(np.zeros(0, X.dtype)).dtype
        upd = streaming.gram_and_sum_update()
        G = ooc_accumulator(backend, jnp.zeros((d, d), dtype))
        s = ooc_accumulator(backend, jnp.zeros((d,), dtype))
        for _, panel in ooc_panels(X):
            p, _ = ooc_put(backend, panel)
            G, s = upd(G, s, p.astype(dtype))
        G = np.asarray(_jax.device_get(G), dtype=np.float64)
        mu = np.asarray(_jax.device_get(s), dtype=np.float64) / X.shape[0]
        return G, mu

    @staticmethod
    def _top_eigh(M, k):
        """Top-k eigenpairs of a symmetric host matrix, descending, with
        a deterministic sign convention (largest-|entry| positive)."""
        evals, evecs = np.linalg.eigh(M)
        order = np.argsort(evals)[::-1]
        evals = evals[order]
        evecs = evecs[:, order]
        comps = evecs[:, :k].T  # (k, d)
        idx = np.argmax(np.abs(comps), axis=1)
        signs = np.sign(comps[np.arange(k), idx])
        signs[signs == 0] = 1.0
        return evals, comps * signs[:, None]

    def _transform_ooc(self, X, out):
        """Streamed projection on DEVICE (ooc_put + one jitted GEMM per
        panel, the KMeans.predict_ooc pattern) — a host-NumPy per-panel
        GEMM would be single-threaded CPU work that cannot overlap the
        disk reads."""
        from nums_tpu.core import multiprocess as _mp
        from nums_tpu.core.array.application import ooc_panels, ooc_put
        from nums_tpu.core.array.diskarray import DiskArray

        backend = X.backend
        dtype = jnp.asarray(np.zeros(0, X.dtype)).dtype
        comps = np.asarray(self.components_.get(), dtype)
        shift = self._ooc_shift()
        scale = self._ooc_scale()
        # Neutral values keep ONE kernel signature (numpy inputs are
        # auto-replicated under multi-controller).
        shift = (np.zeros((comps.shape[1],), dtype) if shift is None
                 else np.asarray(shift, dtype))
        scale = (np.ones((comps.shape[0],), dtype) if scale is None
                 else np.broadcast_to(
                     np.asarray(scale, dtype), (comps.shape[0],)
                 ))
        kern = _project_kernel()
        out = out or X.path + ".transformed"
        block_rows = X.grid.block_shape[0]

        def panels():
            for _, panel in ooc_panels(X):
                p, nv = ooc_put(backend, panel)
                t = kern(p.astype(dtype), comps, shift, scale)
                host = (
                    _mp.allgather_to_host(t) if _mp.is_multiprocess()
                    else np.asarray(t)
                )
                yield host[:nv]

        return DiskArray.from_panels(
            out, X._fs, panels(), (X.shape[0], comps.shape[0]),
            X.dtype, block_rows,
        )

    def _ooc_shift(self):
        return None

    def _ooc_scale(self):
        return None

    # -- persistence (model.json + arrays.npz, atomic) ------------------

    _extra_meta = ()
    _extra_arrays = ()

    def save(self, path: str):
        from nums_tpu.models._common import save_model_arrays

        assert self.components_ is not None, "fit before save"
        meta = {
            "model": type(self).__name__,
            "n_components": self.n_components_,
            "svd_solver": self.svd_solver,
            "n_oversamples": self.n_oversamples,
            "power_iters": self.power_iters,
            "seed": self.seed,
            "n_samples": self.n_samples_,
        }
        for k in self._extra_meta:
            meta[k] = getattr(self, k)
        arrays = {
            "components": self.components_,
            "singular_values": self.singular_values_,
            "explained_variance": self.explained_variance_,
            "explained_variance_ratio": self.explained_variance_ratio_,
        }
        for k in self._extra_arrays:
            arrays[k] = getattr(self, k + "_", None)
        save_model_arrays(path, meta, arrays)

    @classmethod
    def load(cls, path: str):
        from nums_tpu.models._common import load_model_arrays

        meta, arrays = load_model_arrays(path)
        kw = {}
        if meta.get("whiten") is not None:
            kw["whiten"] = meta["whiten"]
        m = cls(
            n_components=meta["n_components"],
            svd_solver=meta["svd_solver"],
            n_oversamples=meta["n_oversamples"],
            power_iters=meta["power_iters"], seed=meta["seed"], **kw
        )
        assert meta["model"] == type(m).__name__, meta
        app = _instance()
        m.n_components_ = meta["n_components"]
        m.n_samples_ = meta["n_samples"]
        m.components_ = app.array(arrays["components"])
        m.singular_values_ = app.array(arrays["singular_values"])
        m.explained_variance_ = app.array(arrays["explained_variance"])
        m.explained_variance_ratio_ = app.array(
            arrays["explained_variance_ratio"]
        )
        if "mean" in arrays:
            m.mean_ = app.array(arrays["mean"])
        if "noise_variance" in arrays:
            m.noise_variance_ = app.scalar(
                float(arrays["noise_variance"])
            )
        return m

    # Centering hooks (identity for TruncatedSVD).
    def _center(self, X):
        return X

    def _uncenter(self, X):
        return X


class TruncatedSVD(_BaseSVDModel):
    """Truncated SVD (a.k.a. LSA): no centering — works directly on the
    (possibly non-centered) data matrix."""

    def _fit(self, X):
        assert X.ndim == 2
        app = _instance()
        n = X.shape[0]
        k = self._resolve_k(X)
        u, s, vt = self._svd(X, k)
        self.n_samples_ = n
        self.n_components_ = k
        self.components_ = vt[:k]
        self.singular_values_ = s[:k]
        # sklearn TruncatedSVD semantics: explained_variance_ is the
        # per-column variance of the TRANSFORMED data (np.var, ddof=0),
        # not s²/(n−1) — for non-centered X (the typical TruncatedSVD
        # input) the two differ wildly because the leading singular
        # value absorbs the mean offset.
        self.explained_variance_ = app.var(u[:, :k] * s[:k], axis=0)
        total_var = app.sum(app.var(X, axis=0))
        self.explained_variance_ratio_ = self.explained_variance_ / total_var
        return u, s

    def _fit_ooc(self, X):
        """Out-of-core fit from ONE streamed pass: eigendecomposition of
        the gram XᵀX (accuracy ~eps·cond² like any normal-equations
        method; the in-core path's TSQR-SVD is the high-accuracy route).
        sklearn variance semantics from gram identities:
        var(Xvᵢ) = sᵢ²/n − (μᵀvᵢ)²; Σvar(X col) = tr(G)/n − ‖μ‖²."""
        app = _instance()
        n, d = X.shape
        k = self._resolve_k(X)
        G, mu = self._moments_ooc(X)
        evals, comps = self._top_eigh(G, k)
        s = np.sqrt(np.maximum(evals[:k], 0.0))
        self.n_samples_ = n
        self.n_components_ = k
        self.components_ = app.array(
            comps.astype(X.dtype), block_shape=(k, d)
        )
        self.singular_values_ = app.array(s.astype(X.dtype),
                                          block_shape=(k,))
        ev = s * s / n - (comps @ mu) ** 2
        total_var = np.trace(G) / n - float(mu @ mu)
        self.explained_variance_ = app.array(ev.astype(X.dtype),
                                             block_shape=(k,))
        self.explained_variance_ratio_ = app.array(
            (ev / total_var).astype(X.dtype), block_shape=(k,)
        )


class PCA(_BaseSVDModel):
    """Principal component analysis via distributed centered SVD.

    ``whiten=True`` scales projections to unit component-wise variance.
    """

    _extra_meta = ("whiten",)
    _extra_arrays = ("mean", "noise_variance")

    def __init__(self, n_components=None, whiten=False, **solver_kwargs):
        super().__init__(n_components, **solver_kwargs)
        self.whiten = bool(whiten)
        self.mean_ = None
        self.noise_variance_ = None

    def _fit(self, X):
        assert X.ndim == 2
        app = _instance()
        n, d = X.shape
        k = self._resolve_k(X)
        self.mean_ = app.mean(X, axis=0)
        Xc = X - self.mean_
        u, s, vt = self._svd(Xc, k)
        self.n_samples_ = n
        self.n_components_ = k
        self.components_ = vt[:k]
        self.singular_values_ = s[:k]
        ev_k = (s[:k] * s[:k]) / float(n - 1)
        # Total variance directly (== Σ all eigenvalues exactly); works
        # whether the solver returned all or only the top-k values.
        total_var = app.sum(app.var(X, axis=0, ddof=1))
        self.explained_variance_ = ev_k
        self.explained_variance_ratio_ = ev_k / total_var
        # Average variance in the dropped subspace (sklearn's
        # noise_variance_; 0 when k == min(n, d)).
        if k < min(n, d):
            self.noise_variance_ = (total_var - app.sum(ev_k)) / float(
                min(n, d) - k
            )
        else:
            self.noise_variance_ = app.scalar(0.0)
        return u, s

    def _fit_ooc(self, X):
        """Out-of-core PCA: streamed (XᵀX, μ) → covariance
        eigendecomposition. cov = (G − n·μμᵀ)/(n−1); sklearn's
        explained_variance_ IS the top eigenvalues of cov."""
        app = _instance()
        n, d = X.shape
        k = self._resolve_k(X)
        G, mu = self._moments_ooc(X)
        cov = (G - n * np.outer(mu, mu)) / (n - 1)
        evals, comps = self._top_eigh(cov, k)
        evk = np.maximum(evals[:k], 0.0)
        self.n_samples_ = n
        self.n_components_ = k
        self.mean_ = app.array(mu.astype(X.dtype), block_shape=(d,))
        self.components_ = app.array(
            comps.astype(X.dtype), block_shape=(k, d)
        )
        self.singular_values_ = app.array(
            np.sqrt(evk * (n - 1)).astype(X.dtype), block_shape=(k,)
        )
        total_var = float(np.trace(cov))
        self.explained_variance_ = app.array(evk.astype(X.dtype),
                                             block_shape=(k,))
        self.explained_variance_ratio_ = app.array(
            (evk / total_var).astype(X.dtype), block_shape=(k,)
        )
        if k < min(n, d):
            self.noise_variance_ = app.scalar(
                (total_var - float(evk.sum())) / (min(n, d) - k)
            )
        else:
            self.noise_variance_ = app.scalar(0.0)

    def _ooc_shift(self):
        return np.asarray(self.mean_.get())

    def _ooc_scale(self):
        if not self.whiten:
            return None
        return np.asarray(self.singular_values_.get()) / float(
            np.sqrt(self.n_samples_ - 1)
        )

    def _center(self, X):
        return X - self.mean_

    def _uncenter(self, X):
        return X + self.mean_

    def transform(self, X, out: str = None):
        from nums_tpu.core.array.diskarray import DiskArray

        if isinstance(X, DiskArray):
            # whiten is folded into the panel stream (_ooc_scale).
            return super().transform(X, out)
        res = super().transform(X)
        if self.whiten:
            res = res / (self.singular_values_ / float(
                np.sqrt(self.n_samples_ - 1)
            ))
        return res

    def fit_transform(self, X):
        from nums_tpu.core.array.diskarray import DiskArray

        if isinstance(X, DiskArray):
            return super().fit_transform(X)
        res = super().fit_transform(X)
        if self.whiten:
            res = res / (self.singular_values_ / float(
                np.sqrt(self.n_samples_ - 1)
            ))
        return res

    def inverse_transform(self, X):
        if self.whiten:
            X = _to_ba(X) * (
                self.singular_values_ / float(np.sqrt(self.n_samples_ - 1))
            )
        return super().inverse_transform(X)
