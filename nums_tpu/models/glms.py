"""Generalized linear models with distributed solvers.

Parity target: ``nums/models/glms.py:64-398`` — same model family
(Linear/Logistic/Poisson/Exponential regression), same five solvers
(gd, sgd, block_sgd, newton/newton-cg, irls), same GLM math, written
entirely against BlockArray/ArrayApplication so it runs unchanged on any
backend. For fused on-device training loops see ``nums_tpu.models.fast_glm``
(fully jitted train step).
"""

import numpy as np

from nums_tpu.core.application_manager import instance as _instance

from nums_tpu.core.array.blockarray import BlockArray
from nums_tpu.core.array.random import NumsRandomState


class GLM:
    def __init__(
        self,
        penalty="none",
        C=1.0,
        tol=0.0001,
        max_iter=100,
        solver="newton-cg",
        lr=0.01,
        admm_rho=1.0,
        l1_ratio=0.5,
        random_state=None,
        fit_intercept=True,
        normalize=False,
    ):
        if fit_intercept is False:
            raise NotImplementedError(
                "fit_intercept=False currently not supported."
            )
        if normalize is True:
            raise NotImplementedError("normalize=True currently not supported.")

        self._app = _instance()
        if random_state is None:
            self.rs = self._app.random
        elif isinstance(random_state, (int, np.integer)):
            self.rs = NumsRandomState(self._app.backend, seed=random_state)
        elif isinstance(random_state, NumsRandomState):
            self.rs = random_state
        else:
            raise Exception(
                f"Unexpected type for random_state {type(random_state)}"
            )
        self._penalty = None if penalty == "none" else penalty
        if self._penalty not in (None, "l2", "l1", "elasticnet"):
            raise NotImplementedError(f"{self._penalty} penalty not supported")
        if self._penalty in ("l1", "elasticnet") and solver != "admm":
            # l1/elasticnet are non-smooth: only the proximal (ADMM)
            # solver handles them.
            raise NotImplementedError(
                f"{self._penalty} penalty requires solver='admm'."
            )
        self._l1_ratio = float(l1_ratio)
        self._lambda = 1.0 / C
        self._lambda_vec = None
        self._tol = tol
        self._max_iter = max_iter
        self._opt = solver
        self._lr = lr
        self._admm_rho = float(admm_rho)
        self._beta = None
        self._beta0 = None

    def fit(self, X: BlockArray, y: BlockArray):
        """Parity: glms.py:103-138, with upstream-NumS intercept handling
        restored: X is augmented with a ones column so the final beta
        component is the intercept. (The reference fork commented this out
        — glms.py:107-112 — which makes its own fit→predict path fail on a
        shape mismatch; verified against the fork directly.)

        ``X`` may also be a ``DiskArray`` (out-of-core): Newton then
        streams row panels through the device each iteration, so the
        dataset never has to fit in HBM (see fast_glm.newton_fit_ooc).
        """
        from nums_tpu.core.array.diskarray import DiskArray

        if isinstance(X, DiskArray):
            return self._fit_ooc(X, y)
        assert X.ndim == 2 and y.ndim == 1
        app = self._app
        X = app.concatenate(
            [
                X,
                app.ones(
                    (X.shape[0], 1), (X.block_shape[0], 1), dtype=X.dtype
                ),
            ],
            axis=1,
            axis_block_size=X.block_shape[1],
        )
        beta = app.zeros((X.shape[1],), (X.block_shape[1],), dtype=X.dtype)
        tol = app.scalar(self._tol)
        max_iter = self._max_iter
        vec = self._lambda_host_vec(X.shape[0], beta.shape[0], dtype=X.dtype)
        if vec is not None:
            self._lambda_vec = app.array(vec, block_shape=beta.block_shape)
        if self._opt in ("gd", "sgd", "block_sgd"):
            lr = app.scalar(self._lr)
            opt = {"gd": gd, "sgd": sgd, "block_sgd": block_sgd}[self._opt]
            beta = opt(self, beta, X, y, tol, max_iter, lr)
        elif self._opt in ("newton", "newton-cg"):
            fused = self._fused_newton(X, y, beta, max_iter)
            if fused is not None:
                beta = fused
            else:
                beta = newton(app, self, beta, X, y, tol, max_iter)
        elif self._opt == "irls":
            assert isinstance(self, LogisticRegression)
            beta = irls(app, self, beta, X, y, tol, max_iter)
        elif self._opt == "lbfgs":
            # Implemented (the reference stubs this out, glms.py:393-394):
            # on-device quasi-Newton over the fused objective.
            if self._fused_kind is None:
                raise NotImplementedError(
                    "lbfgs unsupported for this model family."
                )
            from nums_tpu.models import fast_glm

            lv = (
                self._lambda_vec.data
                if self._lambda_vec is not None
                else None
            )
            beta_data = fast_glm.bfgs_fit(
                X.data, y.data, beta.data, self._tol,
                kind=self._fused_kind, max_iter=int(max_iter),
                penalized=lv is not None, lambda_vec=lv,
            )
            beta = BlockArray.from_jax(
                beta_data, block_shape=beta.block_shape, backend=beta.backend
            )
        elif self._opt == "admm":
            # Implemented (the reference stubs this out, glms.py:397-398):
            # whole ADMM loop as ONE on-device while_loop; adds l1
            # (lasso / sparse logistic) support no other solver has.
            if self._fused_kind is None:
                raise NotImplementedError(
                    "admm unsupported for this model family."
                )
            from nums_tpu.models import fast_glm

            lv = (
                self._lambda_vec.data
                if self._lambda_vec is not None
                else None
            )
            beta_data, _, _ = fast_glm.admm_fit(
                X.data, y.data, beta.data, self._tol,
                kind=self._fused_kind, max_iter=int(max_iter),
                rho=self._admm_rho,
                penalty=self._penalty, lambda_vec=lv,
                l1_ratio=self._l1_ratio,
            )
            beta = BlockArray.from_jax(
                beta_data, block_shape=beta.block_shape, backend=beta.backend
            )
        else:
            raise Exception(f"Unsupported optimizer specified {self._opt}.")
        self._beta0 = beta[-1]
        self._beta = beta[:-1]
        return self

    _fused_kind = None  # set by subclasses that support the fused solver
    # Reference parity: the reference's lambda_vec penalizes every
    # coordinate including the intercept; the sklearn aliases override.
    _penalize_intercept = True
    _sklearn_alpha_scale = False

    def _fit_ooc(self, X, y):
        """Out-of-core fit on a DiskArray design matrix.

        Newton streams the dataset once per iteration (any fused kind);
        ADMM (lasso/ridge/elastic-net, linear kind) streams ONCE total —
        the whole prox loop runs on the (d+1)² normal-equation moments.
        """
        if self._fused_kind is None:
            raise NotImplementedError(
                "out-of-core training unsupported for this model family."
            )
        from nums_tpu.models import fast_glm

        app = self._app
        d = X.shape[1]
        lv = self._lambda_host_vec(X.shape[0], d + 1)
        if lv is not None:
            self._lambda_vec = app.array(lv, block_shape=(d + 1,))
        if self._opt == "admm":
            if self._fused_kind != "linear":
                raise NotImplementedError(
                    "out-of-core admm supports linear models only."
                )
            beta = self._admm_ooc(X, y, lv)
        elif self._opt in ("newton", "newton-cg"):
            if self._penalty not in (None, "l2"):
                raise NotImplementedError(
                    "out-of-core Newton supports penalty in {none, l2}."
                )
            beta, _, _ = fast_glm.newton_fit_ooc(
                X, y, self._tol, kind=self._fused_kind,
                max_iter=int(self._max_iter),
                penalized=lv is not None, lambda_vec=lv,
            )
        else:
            raise NotImplementedError(
                "out-of-core training supports solver in {newton, admm}."
            )
        beta = BlockArray.from_jax(beta, backend=app.backend)
        self._beta0 = beta[-1]
        self._beta = beta[:-1]
        return self

    def _admm_ooc(self, X, y, lv):
        """ONE streamed pass for (G, q) = ([X,1]ᵀ[X,1], [X,1]ᵀy), then
        the cached-factorization ADMM loop on (d+1)² state — lasso on a
        disk-sized dataset costs a single read of it."""
        import jax.numpy as jnp

        from nums_tpu.core.array.application import (
            _ooc_y_getter, ooc_accumulator, ooc_panels, ooc_put,
        )
        from nums_tpu.core.ops import streaming
        from nums_tpu.models import fast_glm

        d = X.shape[1]
        dtype = jnp.asarray(np.zeros(0, X.dtype)).dtype
        y_at = _ooc_y_getter(X, y)
        upd = streaming.normal_eq_aug_update()
        backend = X.backend
        G = ooc_accumulator(backend, jnp.zeros((d + 1, d + 1), dtype))
        q = ooc_accumulator(backend, jnp.zeros((d + 1,), dtype))
        for start, panel in ooc_panels(X):
            p, nv = ooc_put(backend, panel)
            yp, _ = ooc_put(backend, y_at(start, panel.shape[0]))
            G, q = upd(G, q, p.astype(dtype), yp.astype(dtype),
                       np.int32(nv))
        beta0 = ooc_accumulator(backend, jnp.zeros((d + 1,), dtype))
        lam = ooc_accumulator(backend, (
            jnp.asarray(lv, dtype) if lv is not None
            else jnp.zeros((d + 1,), dtype)
        ))
        beta, _, _ = fast_glm.admm_fit_gram(
            G, q, beta0, self._tol, max_iter=int(self._max_iter),
            rho=self._admm_rho, penalty=self._penalty or "none",
            lambda_vec=lam, l1_ratio=self._l1_ratio,
        )
        return beta

    def _fused_newton(self, X, y, beta, max_iter):
        """Run Newton as ONE on-device while_loop program when supported.

        Numerically identical to the eager loop (same update, same
        convergence rule) but with zero per-iteration host syncs.
        Returns None to fall back to the eager solver.
        """
        from nums_tpu.core import settings

        if settings.glm_fuse in ("0", "false") or self._fused_kind is None:
            return None
        from nums_tpu.models import fast_glm

        lv = self._lambda_vec.data if self._lambda_vec is not None else None
        beta_data, _, _ = fast_glm.newton_fit(
            X.data, y.data, beta.data, self._tol,
            kind=self._fused_kind, max_iter=int(max_iter),
            penalized=lv is not None, lambda_vec=lv,
        )
        from nums_tpu.core.array.blockarray import BlockArray

        return BlockArray.from_jax(
            beta_data, block_shape=beta.block_shape, backend=beta.backend
        )

    def _fused_enabled(self):
        from nums_tpu.core import settings

        return (
            settings.glm_fuse not in ("0", "false")
            and self._fused_kind is not None
            and self._beta is not None
        )

    def _fused_forward(self, X):
        from nums_tpu.models import fast_glm

        data = fast_glm.glm_forward(
            X.data, self._beta.data, self._beta0.data, kind=self._fused_kind
        )
        return BlockArray.from_jax(
            data, block_shape=(X.block_shape[0],), backend=X.backend
        )

    def forward(self, X, beta=None):
        if beta:
            return self.link_inv(X @ beta)
        if self._fused_enabled():
            # One jitted program instead of an eager op chain.
            return self._fused_forward(X)
        return self.link_inv(self._beta0 + X @ self._beta)

    def grad_norm_sq(self, X, y, beta=None):
        g = self.gradient(X, y, self.forward(X, beta), beta=beta)
        return g.T @ g

    def _lambda_host_vec(self, n_rows, width, dtype=np.float64):
        """Per-coordinate penalty vector — the ONE construction shared
        by in-core fit, out-of-core fit, and save/load (two copies
        previously drifted on dtype). None when unpenalized."""
        if self._penalty not in ("l2", "l1", "elasticnet"):
            return None
        lam = self._lambda
        if self._sklearn_alpha_scale:
            # sklearn's Lasso/ElasticNet objective carries a 1/(2n)
            # factor on the residual term; ours doesn't, so the
            # equivalent per-coordinate λ is n·alpha.
            lam = lam * n_rows
        vec = np.full(width, lam, dtype=dtype)
        if not self._penalize_intercept:
            # sklearn never penalizes the intercept (the appended
            # ones column / last beta coordinate). Plain GLM keeps
            # reference parity (glms.py:222-240 penalizes all).
            vec[-1] = 0.0
        return vec

    def _lam_for(self, X):
        """λ vector sized for X's columns: during fit X is intercept-
        augmented (width d+1 == len(lambda_vec)); post-fit callers pass
        the raw d-column X — drop the intercept slot."""
        lv = self._lambda_vec
        if lv is not None and lv.shape[0] == X.shape[1] + 1:
            return lv[:-1]
        return lv

    def _beta_for_penalty(self, X, beta):
        """The coefficient vector the l2 term applies to: the solver's
        augmented beta during fit, the fitted coefficients after."""
        if beta is not None:
            return beta
        assert self._beta is not None, "penalized gradient needs beta"
        return self._beta

    def predict(self, X):
        raise NotImplementedError()

    def predict_ooc(self, X, out: str = None):
        """Predictions for an out-of-core design matrix, streamed to a
        new 1-D DiskArray (``out`` defaults to ``<X.path>.pred``)."""
        from nums_tpu.core.array.diskarray import DiskArray

        assert isinstance(X, DiskArray), type(X)
        assert self._beta is not None, "fit must be called first"
        app = self._app
        coef = np.asarray(self._beta.get())
        b0 = float(self._beta0.get())
        out = out or X.path + ".pred"

        def panels():
            for _, p in X.iter_row_panels():
                eta = p @ coef + b0
                yield np.asarray(self._host_link(eta))

        dtype = self._host_link(np.zeros(1)).dtype
        da = DiskArray.from_panels(
            out, app.fs, panels(), (X.shape[0],), dtype,
            X.grid.block_shape[0],
        )
        return da

    def _host_link(self, eta):
        """Host-side link_inv + decision for predict_ooc panels."""
        raise NotImplementedError()

    def link_inv(self, eta):
        raise NotImplementedError()

    def objective(self, X, y, beta=None):
        raise NotImplementedError()

    def gradient(self, X, y, mu=None, beta=None):
        raise NotImplementedError()

    def hessian(self, X, y, mu=None):
        raise NotImplementedError()

    def deviance(self, y, y_pred):
        raise NotImplementedError()

    def deviance_sqr(self, X, y):
        app = self._app
        y_pred = self.predict(X)
        dev = self.deviance(y, y_pred)
        y_mean = app.mean(y)
        dev_null = self.deviance(y, y_mean)
        # Constant-y guard (same convention as metrics.r2_score):
        # dev_null == 0 would otherwise emit -inf/nan.
        one, zero = app.scalar(1.0), app.scalar(0.0)
        null_zero = dev_null == zero
        score = one - dev / app.where(null_zero, one, dev_null)
        return app.where(
            null_zero, app.where(dev == zero, one, zero), score
        )

    # -- sklearn-style conveniences (beyond the reference) ---------------

    @property
    def coef_(self):
        return self._beta

    @property
    def intercept_(self):
        return self._beta0

    def score(self, X, y):
        """Classification accuracy for classifiers; R² otherwise."""
        if isinstance(self, LogisticRegression):
            return (self.predict(X) == y.astype(np.int64)).mean()
        return self.deviance_sqr(X, y)

    # -- model checkpointing (absent in the reference: SURVEY §5 notes it
    #    keeps _beta as a live object with no persistence) ---------------

    def save(self, filename: str):
        """Persist fitted parameters + hyperparameters to a directory."""
        import json
        import os

        assert self._beta is not None, "fit must be called before save"
        from nums_tpu.core.io.filesystem import _fs_path

        path = _fs_path(filename)
        os.makedirs(path, exist_ok=True)
        self._app.write_fs(self._beta, os.path.join(path, "beta"))
        if self._lambda_vec is not None:
            # Without this, a loaded penalized model crashes in
            # gradient/hessian (_lam_for returns None) until refit.
            self._app.write_fs(
                self._lambda_vec, os.path.join(path, "lambda_vec")
            )
        meta = {
            "model": type(self).__name__,
            "beta0": float(self._beta0.get()),
            "penalty": self._penalty or "none",
            "C": 1.0 / self._lambda,
            "tol": self._tol,
            "max_iter": self._max_iter,
            "solver": self._opt,
            "lr": self._lr,
            "admm_rho": self._admm_rho,
            "l1_ratio": self._l1_ratio,
        }
        with open(os.path.join(path, "model.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, filename: str):
        """Restore a fitted GLM (any subclass) from ``save`` output."""
        import json
        import os

        from nums_tpu.core.io.filesystem import _fs_path

        path = _fs_path(filename)
        with open(os.path.join(path, "model.json")) as f:
            meta = json.load(f)
        model_cls = _MODEL_REGISTRY[meta["model"]]
        common = dict(
            tol=meta["tol"], max_iter=meta["max_iter"], lr=meta["lr"],
            admm_rho=meta.get("admm_rho", 1.0),
            l1_ratio=meta.get("l1_ratio", 0.5),
        )
        if issubclass(model_cls, (Lasso, ElasticNet)):
            # Alias constructors fix penalty/solver (always admm) and
            # take sklearn's alpha (== 1/C).
            model = model_cls(alpha=1.0 / meta["C"], **common)
        elif issubclass(model_cls, Ridge):
            # Ridge's solver is user-selectable — restore the saved one.
            model = model_cls(
                alpha=1.0 / meta["C"], solver=meta["solver"], **common
            )
        else:
            model = model_cls(
                penalty=meta["penalty"], C=meta["C"],
                solver=meta["solver"], **common,
            )
        model._beta = model._app.read_fs(os.path.join(path, "beta"))
        model._beta0 = model._app.scalar(meta["beta0"])
        lam_dir = os.path.join(path, "lambda_vec")
        if os.path.isdir(lam_dir):
            model._lambda_vec = model._app.read_fs(lam_dir)
        return model


class LinearRegression(GLM):
    # Canonical link: identity (glms.py:178-208).

    _fused_kind = "linear"

    def link_inv(self, eta):
        return eta

    def objective(self, X, y, beta=None):
        assert beta is not None or self._beta is not None
        mu = self.forward(X, beta)
        # (Unpenalized, like the reference's objectives — the penalty
        # enters through gradient/hessian in the Newton solvers.)
        return self._app.sum((y - mu) ** self._app.two)

    def gradient(self, X, y, mu=None, beta=None):
        if mu is None:
            mu = self.forward(X)
        if self._penalty != "l2":
            # (The reference's LinearRegression ignores the penalty
            # entirely — glms.py:190-201; Ridge requires it here.)
            return X.T @ (mu - y)
        b = self._beta_for_penalty(X, beta)
        return X.T @ (mu - y) + self._lam_for(X) * b

    def hessian(self, X, y, mu=None):
        if self._penalty != "l2":
            return X.T @ X
        return X.T @ X + self._app.diag(self._lam_for(X))

    def deviance(self, y, y_pred):
        return self._app.sum((y - y_pred) ** self._app.two)

    def predict(self, X):
        return self.forward(X)

    def _host_link(self, eta):
        return eta


class LogisticRegression(GLM):
    # Canonical link: logit (glms.py:211-251).

    _fused_kind = "logistic"

    def link_inv(self, eta):
        app = self._app
        return app.one / (app.one + app.exp(-eta))

    def objective(self, X, y, beta=None):
        assert beta is not None or self._beta is not None
        app = self._app
        mu = self.forward(X, beta)
        return -app.sum(y * app.log(mu) + (app.one - y) * app.log(app.one - mu))

    def gradient(self, X, y, mu=None, beta=None):
        if mu is None:
            mu = self.forward(X)
        if self._penalty != "l2":
            # l1's subgradient is non-smooth — the smooth gradient here
            # is only used by smooth solvers (l1 is ADMM-only).
            return X.T @ (mu - y)
        b = self._beta_for_penalty(X, beta)
        return X.T @ (mu - y) + self._lam_for(X) * b

    def hessian(self, X, y, mu=None):
        if mu is None:
            mu = self.forward(X)
        dim, block_dim = mu.shape[0], mu.block_shape[0]
        s = (mu * (self._app.one - mu)).reshape(
            (dim, 1), block_shape=(block_dim, 1)
        )
        if self._penalty != "l2":
            return X.T @ (s * X)
        # diag(λ) — the reference broadcasts the vector across the whole
        # Hessian (glms.py:239, adding λ_j to EVERY entry of column j,
        # an asymmetric rank-one perturbation); that is a reference bug,
        # fixed here and in the fused path identically (DIVERGENCES.md).
        return X.T @ (s * X) + self._app.diag(self._lam_for(X))

    def deviance(self, y, y_pred):
        raise NotImplementedError()

    def predict(self, X):
        if self._fused_enabled():
            from nums_tpu.models import fast_glm

            data = fast_glm.logistic_predict_label(
                X.data, self._beta.data, self._beta0.data
            )
            return BlockArray.from_jax(
                data, block_shape=(X.block_shape[0],), backend=X.backend
            ).astype(np.int64)
        return (self.forward(X) > 0.5).astype(np.int64)

    def _host_link(self, eta):
        return (1.0 / (1.0 + np.exp(-eta)) > 0.5).astype(np.int64)

    def predict_proba(self, X):
        """(n, 2) probabilities in SKLEARN column order — column index ==
        class label, so column 1 = P(1). (The reference emits the
        reverse, [P(1), P(0)]; we diverge for consistency with the rest
        of the model zoo and metrics — DIVERGENCES.md.)"""
        y_pos = self.forward(X).reshape(
            (X.shape[0], 1), block_shape=(X.block_shape[0], 1)
        )
        y_neg = 1 - y_pos
        return self._app.concatenate([y_neg, y_pos], axis=1, axis_block_size=2)


class PoissonRegression(GLM):
    # Canonical link: log (glms.py:254-283).

    _fused_kind = "poisson"

    def link_inv(self, eta):
        return self._app.exp(eta)

    def objective(self, X, y, beta=None):
        if beta is None:
            eta = X @ self._beta + self._beta0
        else:
            eta = X @ beta
        mu = self._app.exp(eta)
        return self._app.sum(mu - y * eta)

    def gradient(self, X, y, mu=None, beta=None):
        if mu is None:
            mu = self.forward(X)
        return X.T @ (mu - y)

    def hessian(self, X, y, mu=None):
        if mu is None:
            mu = self.forward(X)
        return (X.T * mu) @ X

    def deviance(self, y, y_pred):
        app = self._app
        return app.sum(app.two * app.xlogy(y, y / y_pred) - y + y_pred)

    def predict(self, X):
        return self.forward(X)

    def _host_link(self, eta):
        return np.exp(eta)


class ExponentialRegression(GLM):
    """Exponential GLM with LOG link (implemented here; the reference is a
    stub, glms.py:286-304, and its canonical-link sketch is numerically
    untrainable from beta=0 since mu=-1/eta diverges at eta=0).

    y ~ Exp(rate=1/mu), mu = exp(eta):
      NLL      = sum(log mu + y/mu)
      gradient = X^T (1 - y/mu)
      hessian  = X^T diag(y/mu) X  (observed information)
    """

    _fused_kind = None  # eager Newton only (observed-information step)

    def link_inv(self, eta):
        return self._app.exp(eta)

    def objective(self, X, y, beta=None):
        app = self._app
        mu = self.forward(X, beta)
        return app.sum(app.log(mu) + y / mu)

    def gradient(self, X, y, mu=None, beta=None):
        if mu is None:
            mu = self.forward(X)
        return X.T @ (self._app.one - y / mu)

    def hessian(self, X, y, mu=None):
        if mu is None:
            mu = self.forward(X)
        w = y / mu
        dim, block_dim = w.shape[0], w.block_shape[0]
        w2 = w.reshape((dim, 1), block_shape=(block_dim, 1))
        return X.T @ (w2 * X)

    def deviance(self, y, y_pred):
        app = self._app
        r = y / y_pred
        return app.sum(app.two * (r - app.log(r) - app.one))

    def predict(self, X):
        return self.forward(X)


# Scikit-Learn alias (parity: glms.py:307).
PoissonRegressor = PoissonRegression


def sgd(model, beta, X, y, tol, max_iter, lr):
    """Single-sample SGD (parity: glms.py:315-330)."""
    app = _instance()
    # ONE generator for the whole run: rs.numpy() reseeds on every call,
    # so drawing inside the loop would yield the same index forever
    # (max_iter steps on a single fixed sample).
    rng = model.rs.numpy()
    for _ in range(max_iter):
        idx = int(rng.integers(X.shape[0]))
        X_sample, y_sample = X[idx : idx + 1], y[idx : idx + 1]
        mu = model.forward(X_sample, beta)
        g = model.gradient(X_sample, y_sample, mu, beta=beta)
        beta += -lr * g
        if app.max(app.abs(g)) <= tol:
            break
    return beta


def block_sgd(model, beta, X, y, tol, max_iter, lr):
    """Per-block minibatch SGD (parity: glms.py:333-346)."""
    app = _instance()
    for _ in range(max_iter):
        for start, stop in X.grid.grid_slices[0]:
            X_batch, y_batch = X[start:stop], y[start:stop]
            mu = model.forward(X_batch, beta)
            g = model.gradient(X_batch, y_batch, mu, beta=beta)
            beta += -lr * g
            if app.max(app.abs(g)) <= tol:
                break
    return beta


def gd(model, beta, X, y, tol, max_iter, lr):
    """Parity: glms.py:349-359."""
    app = _instance()
    for _ in range(max_iter):
        mu = model.forward(X, beta)
        g = model.gradient(X, y, mu, beta=beta)
        beta += -lr * g
        if app.max(app.abs(g)) <= tol:
            break
    return beta


def newton(app, model, beta, X, y, tol, max_iter):
    """Parity: glms.py:362-372 — but the d×d Hessian solve is a Cholesky
    solve instead of explicit inverse + matvec (fewer flops, better
    conditioning; Hessians here are PSD)."""
    for _ in range(max_iter):
        mu = model.forward(X, beta)
        g = model.gradient(X, y, mu, beta=beta)
        beta += -app.posdef_solve(model.hessian(X, y, mu), g)
        if app.max(app.abs(g)) <= tol:
            break
    return beta


def irls(app, model, beta, X, y, tol, max_iter):
    """Parity: glms.py:375-390."""
    for _ in range(max_iter):
        eta = X @ beta
        mu = model.link_inv(eta)
        s = mu * (1 - mu) + 1e-16
        XT_s = X.T * s
        z = eta + (y - mu) / s
        beta = app.posdef_solve(XT_s @ X, XT_s @ z)
        g = model.gradient(X, y, mu, beta)
        if app.max(app.abs(g)) <= tol:
            break
    return beta


def lbfgs(*args, **kwargs):
    """The eager per-op L-BFGS path is intentionally absent: the solver
    is implemented as ONE fused on-device program (fast_glm.bfgs_fit) —
    use ``solver='lbfgs'`` on any GLM. (The reference's lbfgs lives in
    a separate driver loop, glms.py:397-398 stubs the entry.)"""
    raise NotImplementedError("use GLM(solver='lbfgs') — fused on-device L-BFGS")


def admm(*args, **kwargs):
    """The eager per-op ADMM path is intentionally absent: the solver is
    implemented as ONE fused on-device program (fast_glm.admm_fit) — use
    ``solver='admm'`` on any GLM. (The reference stubs this entirely,
    glms.py:397-398.)"""
    raise NotImplementedError("use GLM(solver='admm') — fused on-device ADMM")


# -- sklearn-style penalized-regression conveniences ----------------------
# (alpha convention: penalty strength, sklearn's `alpha` == our λ == 1/C)


class Ridge(LinearRegression):
    """l2-penalized linear regression, sklearn semantics:
    min ‖y − Xβ‖² + alpha·‖β‖² with an UNPENALIZED intercept.
    (sklearn Ridge carries no 1/n factor, so λ == alpha directly.)"""

    _penalize_intercept = False

    def __init__(self, alpha=1.0, **kwargs):
        kwargs.setdefault("solver", "newton")
        super().__init__(penalty="l2", C=1.0 / float(alpha), **kwargs)


class Lasso(LinearRegression):
    """l1-penalized linear regression via the fused ADMM solver,
    sklearn semantics: min 1/(2n)‖y − Xβ‖² + alpha·‖β‖₁, intercept
    unpenalized (internally λ = n·alpha against the un-normalized
    residual objective)."""

    _penalize_intercept = False
    _sklearn_alpha_scale = True

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(
            penalty="l1", C=1.0 / float(alpha), solver="admm", **kwargs
        )


class ElasticNet(LinearRegression):
    """l1+l2-penalized linear regression via the fused ADMM solver,
    sklearn semantics: min 1/(2n)‖y − Xβ‖² + alpha·l1_ratio·‖β‖₁
    + alpha·(1−l1_ratio)/2·‖β‖², intercept unpenalized."""

    _penalize_intercept = False
    _sklearn_alpha_scale = True

    def __init__(self, alpha=1.0, l1_ratio=0.5, **kwargs):
        super().__init__(
            penalty="elasticnet", C=1.0 / float(alpha), solver="admm",
            l1_ratio=l1_ratio, **kwargs
        )


_MODEL_REGISTRY = {
    "LinearRegression": LinearRegression,
    "LogisticRegression": LogisticRegression,
    "PoissonRegression": PoissonRegression,
    "ExponentialRegression": ExponentialRegression,
    "Ridge": Ridge,
    "Lasso": Lasso,
    "ElasticNet": ElasticNet,
}
