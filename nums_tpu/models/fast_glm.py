"""Fused training steps for GLMs.

The BlockArray-level GLM (``nums_tpu.models.glms``) mirrors the reference's
eager per-op structure (one dispatch per op, parity with
``nums/models/glms.py``). This module is the fused fast path: the
ENTIRE solver iteration (forward, gradient, Hessian, Cholesky solve) is one
jitted program, so XLA fuses the elementwise chain into the two matmuls
and the device runs back-to-back GEMMs. This is the flagship "model" for
benchmarks (reference analogue: ``scripts/benchmark_lr.py:56-150``'s
one-step Newton benchmark).

Under a mesh: X is sharded (rows = data-parallel, cols = tensor-parallel);
XLA inserts the psum for X^T(mu-y) and X^T S X automatically.
"""

import functools

import jax
import jax.numpy as jnp
import jax.scipy.optimize  # noqa: F401 - registers the lazy submodule


def _sigmoid(x):
    return jax.nn.sigmoid(x)


def _posdef_solve(a, b):
    l = jnp.linalg.cholesky(a)
    z = jax.scipy.linalg.solve_triangular(l, b, lower=True)
    return jax.scipy.linalg.solve_triangular(l.T, z, lower=False)


def _gram(X, s=None):
    """H = Xᵀ diag(s) X (or XᵀX when ``s`` is None)."""
    Xw = X if s is None else X * s[:, None]
    return Xw.T @ X


def _newton_stats(kind, X, y, beta):
    """(g, H) for one Newton iteration."""
    if kind == "logistic":
        mu = _sigmoid(X @ beta)
        s = mu * (1.0 - mu)
    elif kind == "linear":
        mu = X @ beta
        s = None  # H = XᵀX
    elif kind == "poisson":
        mu = jnp.exp(X @ beta)
        s = mu
    else:
        raise ValueError(kind)
    g = X.T @ (mu - y)
    return g, _gram(X, s)


def logistic_newton_step(X, y, beta):
    """One Newton step of logistic regression. Fully fused.

    Matches the math of the reference benchmark step
    (scripts/benchmark_lr.py:56-150): mu = sigmoid(X beta);
    g = X^T (mu - y); H = X^T S X; beta' = beta - H^{-1} g.
    """
    g, H = _newton_stats("logistic", X, y, beta)
    return beta - _posdef_solve(H, g), g


logistic_newton_step_jit = jax.jit(logistic_newton_step)


def linear_newton_step(X, y, beta):
    g, H = _newton_stats("linear", X, y, beta)
    return beta - _posdef_solve(H, g), g


def poisson_newton_step(X, y, beta):
    g, H = _newton_stats("poisson", X, y, beta)
    return beta - _posdef_solve(H, g), g


_STEPS = {
    "logistic": logistic_newton_step,
    "linear": linear_newton_step,
    "poisson": poisson_newton_step,
}


def _newton_step_penalized(kind, X, y, beta, lambda_vec):
    """One Newton step with l2 penalty: g += λ∘β; H += diag(λ).

    (The reference broadcasts the λ vector across the whole Hessian —
    glms.py:239 adds λ_j to every entry of column j, an asymmetric
    perturbation; that is a reference bug, fixed identically here and
    in the eager path. See DIVERGENCES.md.)"""
    g, H = _newton_stats(kind, X, y, beta)
    if lambda_vec is not None:
        g = g + lambda_vec * beta
        H = H + jnp.diag(lambda_vec)
    return beta - _posdef_solve(H, g), g


@functools.partial(
    jax.jit,
    static_argnames=("kind", "max_iter", "penalized"),
)
def newton_fit(X, y, beta0, tol, kind="logistic", max_iter=10,
               penalized=False, lambda_vec=None):
    """Full Newton training with ON-DEVICE convergence: the loop is a
    lax.while_loop checking max|g| <= tol after each update — semantics
    identical to the reference's driver loop (glms.py:362-372) but with
    zero per-iteration host syncs (the reference ray.get's every
    iteration, its acknowledged choke point)."""
    lv = lambda_vec if penalized else None

    def cond(state):
        _, gmax, it = state
        return jnp.logical_and(it < max_iter, gmax > tol)

    def body(state):
        beta, _, it = state
        beta, g = _newton_step_penalized(kind, X, y, beta, lv)
        return beta, jnp.max(jnp.abs(g)), it + 1

    init = (beta0, jnp.array(jnp.inf, X.dtype), jnp.array(0, jnp.int32))
    beta, gmax, it = jax.lax.while_loop(cond, body, init)
    return beta, gmax, it


@functools.partial(jax.jit, static_argnames=("kind", "num_iters"))
def newton_train(X, y, beta0, kind="logistic", num_iters=10):
    """Fixed-iteration Newton training as ONE compiled program.

    The reference's per-iteration driver sync (``ray.get`` on the
    convergence test every iteration, glms.py:370-371) disappears: the
    loop is a lax.scan on device; convergence is checked after.
    """
    step = _STEPS[kind]

    def body(beta, _):
        beta, g = step(X, y, beta)
        return beta, jnp.max(jnp.abs(g))

    beta, gmax = jax.lax.scan(body, beta0, None, length=num_iters)
    return beta, gmax


def _objective(kind, X, y, beta, lambda_vec):
    eta = X @ beta
    if kind == "logistic":
        # Σ softplus(-(2y-1)·eta): numerically stable NLL.
        obj = jnp.sum(jax.nn.softplus(jnp.where(y > 0.5, -eta, eta)))
    elif kind == "linear":
        obj = 0.5 * jnp.sum((y - eta) ** 2)
    elif kind == "poisson":
        obj = jnp.sum(jnp.exp(eta) - y * eta)
    else:
        raise ValueError(kind)
    if lambda_vec is not None:
        obj = obj + 0.5 * jnp.sum(lambda_vec * beta * beta)
    return obj


@functools.partial(jax.jit, static_argnames=("kind", "max_iter", "penalized"))
def bfgs_fit(X, y, beta0, tol, kind="logistic", max_iter=100,
             penalized=False, lambda_vec=None):
    """Quasi-Newton fit via jax.scipy BFGS — implements the solver the
    reference stubs out (``lbfgs``, glms.py:393-394). Whole optimization
    is one on-device program."""
    lv = lambda_vec if penalized else None
    fun = lambda b: _objective(kind, X, y, b, lv)
    res = jax.scipy.optimize.minimize(
        fun, beta0, method="BFGS",
        options={"maxiter": max_iter, "gtol": tol},
    )
    return res.x


def _soft_threshold(v, k):
    return jnp.sign(v) * jnp.maximum(jnp.abs(v) - k, 0.0)


@functools.partial(
    jax.jit, static_argnames=("max_iter", "penalty")
)
def admm_fit_gram(G, q0, beta0, tol, max_iter=100, rho=1.0,
                  penalty="l1", lambda_vec=None, l1_ratio=0.5):
    """Linear-kind ADMM from PRECOMPUTED normal-equation moments
    (G = XᵀX, q0 = Xᵀy): the whole loop touches only (d, d) state, so
    an out-of-core X needs ONE streamed pass for (G, q0) and the lasso/
    elastic-net solve costs no further data passes. Same math as
    ``admm_fit(kind='linear')`` (which hoists exactly these moments)."""
    d = beta0.shape[0]
    rho0 = jnp.asarray(rho, G.dtype)
    lv = lambda_vec if lambda_vec is not None else jnp.zeros_like(beta0)
    eye = jnp.eye(d, dtype=G.dtype)

    def beta_update(v, rho):
        L = jnp.linalg.cholesky(G + rho * eye)
        w = jax.scipy.linalg.solve_triangular(
            L, q0 + rho * v, lower=True
        )
        return jax.scipy.linalg.solve_triangular(L.T, w, lower=False)

    def z_update(bu, rho):
        if penalty == "l1":
            return _soft_threshold(bu, lv / rho)
        if penalty == "l2":
            return rho * bu / (lv + rho)
        if penalty == "elasticnet":
            a = jnp.asarray(l1_ratio, G.dtype)
            st = _soft_threshold(bu, lv * a / rho)
            return st / (1.0 + lv * (1.0 - a) / rho)
        return bu

    def cond(state):
        _, _, _, r, s, it = state
        return jnp.logical_and(it < max_iter, jnp.maximum(r, s) > tol)

    def body(state):
        z, u, rho, _, _, it = state
        beta = beta_update(z - u, rho)
        z_new = z_update(beta + u, rho)
        u = u + beta - z_new
        r = jnp.max(jnp.abs(beta - z_new))
        s = jnp.max(jnp.abs(rho * (z_new - z)))
        rho_new = jnp.where(
            r > 10.0 * s, rho * 2.0, jnp.where(s > 10.0 * r, rho * 0.5, rho)
        )
        u = u * (rho / rho_new)
        return z_new, u, rho_new, r, s, it + 1

    inf = jnp.array(jnp.inf, G.dtype)
    init = (beta0, jnp.zeros_like(beta0), rho0, inf, inf,
            jnp.array(0, jnp.int32))
    z, u, rho_f, r, s, it = jax.lax.while_loop(cond, body, init)
    return z, jnp.maximum(r, s), it


@functools.partial(
    jax.jit, static_argnames=("kind", "max_iter", "penalty", "newton_steps")
)
def admm_fit(X, y, beta0, tol, kind="linear", max_iter=100, rho=1.0,
             penalty="l1", lambda_vec=None, newton_steps=5, l1_ratio=0.5):
    """ADMM GLM fit — implements the solver the reference stubs out
    (``admm``, glms.py:397-398) and with it L1 (lasso/sparse) penalties,
    which no reference solver supports.

    Split min f(β) + g(z) s.t. β = z (Boyd et al. 2011, §6.4/§8):
    β-update minimizes f(β) + ρ/2‖β − z + u‖², z-update is the proximal
    operator of g (soft-threshold for l1, scaling for l2), u is the
    scaled dual. The WHOLE loop is one on-device lax.while_loop with the
    standard primal/dual-residual stopping rule — zero host syncs.

    For the linear kind the Gram XᵀX and Xᵀy are hoisted out
    of the loop (the two big GEMMs happen ONCE; each iteration is two
    (d,d) triangular solves off a cached Cholesky factor — the classic
    ADMM-lasso factorization-caching trick). For logistic/poisson the
    β-update runs ``newton_steps`` damped-free Newton steps on the
    ρ-augmented objective inside a fori_loop; XLA fuses the elementwise
    chain into the two per-step GEMMs.

    ρ is adapted in-loop by residual balancing (Boyd §3.4.1: ×2 when the
    primal residual leads 10×, ÷2 when the dual does, with the scaled
    dual rescaled accordingly) — the solver is robust to the λ/ρ scale
    without user tuning. For the linear kind this re-factorizes the
    (d,d) augmented Gram each iteration, which is O(d³) noise next to
    the hoisted O(n·d²) GEMMs.

    Returns (z, residual, iterations): z is the proximal iterate (exactly
    sparse under l1). ``lambda_vec`` is per-coordinate λ — coordinates
    with λ_j = 0 (e.g. the intercept under the sklearn aliases) pass
    through the prox unpenalized.
    """
    d = beta0.shape[0]
    rho0 = jnp.asarray(rho, X.dtype)
    lv = lambda_vec if lambda_vec is not None else jnp.zeros_like(beta0)
    eye = jnp.eye(d, dtype=X.dtype)

    if kind == "linear":
        G = X.T @ X  # hoisted: the big GEMMs happen once
        q0 = X.T @ y

        def beta_update(beta, v, rho):
            del beta
            L = jnp.linalg.cholesky(G + rho * eye)
            q = q0 + rho * v
            w = jax.scipy.linalg.solve_triangular(L, q, lower=True)
            return jax.scipy.linalg.solve_triangular(L.T, w, lower=False)

    elif kind in ("logistic", "poisson"):

        def beta_update(beta, v, rho):
            def newton_body(_, b):
                if kind == "logistic":
                    mu = _sigmoid(X @ b)
                    s = mu * (1.0 - mu)
                else:
                    mu = jnp.exp(X @ b)
                    s = mu
                g = X.T @ (mu - y) + rho * (b - v)
                H = (X * s[:, None]).T @ X + rho * eye
                return b - _posdef_solve(H, g)

            return jax.lax.fori_loop(0, newton_steps, newton_body, beta)

    else:
        raise ValueError(kind)

    def z_update(bu, rho):
        if penalty == "l1":
            return _soft_threshold(bu, lv / rho)
        if penalty == "l2":
            return rho * bu / (lv + rho)
        if penalty == "elasticnet":
            # prox of λ(α‖z‖₁ + (1−α)/2 ‖z‖²): soft-threshold then shrink
            # (sklearn l1_ratio convention, α = l1_ratio).
            a = jnp.asarray(l1_ratio, X.dtype)
            st = _soft_threshold(bu, lv * a / rho)
            return st / (1.0 + lv * (1.0 - a) / rho)
        return bu

    def cond(state):
        _, _, _, _, r, s, it = state
        return jnp.logical_and(it < max_iter, jnp.maximum(r, s) > tol)

    def body(state):
        beta, z, u, rho, _, _, it = state
        beta = beta_update(beta, z - u, rho)
        z_new = z_update(beta + u, rho)
        u = u + beta - z_new
        r = jnp.max(jnp.abs(beta - z_new))
        s = jnp.max(jnp.abs(rho * (z_new - z)))
        # Residual balancing; u is the SCALED dual, so it rescales by
        # rho/rho_new when rho changes.
        rho_new = jnp.where(
            r > 10.0 * s, rho * 2.0, jnp.where(s > 10.0 * r, rho * 0.5, rho)
        )
        u = u * (rho / rho_new)
        return beta, z_new, u, rho_new, r, s, it + 1

    inf = jnp.array(jnp.inf, X.dtype)
    init = (beta0, beta0, jnp.zeros_like(beta0), rho0, inf, inf,
            jnp.array(0, jnp.int32))
    beta, z, u, rho_f, r, s, it = jax.lax.while_loop(cond, body, init)
    return z, jnp.maximum(r, s), it


def newton_fit_ooc(X_disk, y, tol, kind="logistic", max_iter=10,
                   penalized=False, lambda_vec=None, dtype=None):
    """Newton GLM training on an OUT-OF-CORE design matrix.

    X_disk is a ``DiskArray``; each iteration streams its row panels
    through the device, accumulating the gradient and Hessian with
    donated buffers (peak HBM: one panel + (d+1)² stats), then takes
    one on-device Newton step. The per-iteration convergence check is
    one scalar sync — the same cadence as the reference's eager loop
    (glms.py:362-372 there), but the dataset never has to fit in device
    (or even host) memory. The reference needed its whole cluster's
    object store for this; here ONE device trains any disk-sized dataset.

    y: host array, BlockArray, or a 1-D DiskArray sharing X's row
    partitioning. Returns (beta_with_intercept, max|g|, iterations).
    """
    from nums_tpu.core.array.application import (
        _ooc_y_getter, ooc_accumulator, ooc_panels, ooc_put,
    )
    from nums_tpu.core.ops import streaming

    assert X_disk.ndim == 2
    d = X_disk.shape[1]
    import numpy as np

    backend = X_disk.backend
    # jnp round-trip resolves dtype coercion (f64→f32 when x64 is off).
    dtype = jnp.asarray(np.zeros(0, dtype or X_disk.dtype)).dtype
    y_at = _ooc_y_getter(X_disk, y)
    da = d + 1
    stats = streaming.glm_stats_update(kind)
    newt = streaming.newton_update(bool(penalized))
    # Under multi-controller every carried array is mesh-replicated so
    # the jitted updates see (global panel, global stats) — a process-
    # local jnp.zeros cannot mix with a global panel in one jit.
    acc = lambda v: ooc_accumulator(backend, v)  # noqa: E731
    lv = acc(
        jnp.asarray(lambda_vec, dtype) if lambda_vec is not None
        else jnp.zeros((da,), dtype)
    )
    beta = acc(jnp.zeros((da,), dtype))
    gmax = jnp.array(jnp.inf, dtype)
    it = 0
    for it in range(1, int(max_iter) + 1):
        g = acc(jnp.zeros((da,), dtype))
        H = acc(jnp.zeros((da, da), dtype))
        for start, panel in ooc_panels(X_disk):
            yp, _ = ooc_put(backend, y_at(start, panel.shape[0]))
            # Mesh backends shard the panel rows over every device; pad
            # rows are masked out via nv inside the kernel.
            p, nv = ooc_put(backend, panel)
            # nv rides in as a HOST scalar: numpy inputs are auto-
            # replicated under multi-controller jit, a jnp.int32 would
            # be a process-local device array (incompatible devices).
            g, H = stats(g, H, p.astype(dtype), yp.astype(dtype), beta,
                         np.int32(nv))
        beta, gmax = newt(beta, g, H, lv)
        if float(gmax) <= tol:  # one scalar sync per PASS, not per op
            break
    return beta, gmax, it


@functools.partial(jax.jit, static_argnames=("kind",))
def glm_forward(X, beta, beta0, kind="logistic"):
    eta = X @ beta + beta0
    if kind == "logistic":
        return _sigmoid(eta)
    if kind == "poisson":
        return jnp.exp(eta)
    return eta


@jax.jit
def logistic_predict_label(X, beta, beta0):
    return (_sigmoid(X @ beta + beta0) > 0.5).astype(jnp.int32)


def fit_logistic(X, y, num_iters=10):
    """Convenience: train from zeros. X: (n, d) jax/np array, y: (n,)."""
    X = jnp.asarray(X)
    y = jnp.asarray(y)
    ones = jnp.ones((X.shape[0], 1), X.dtype)
    Xa = jnp.concatenate([X, ones], axis=1)
    beta0 = jnp.zeros((Xa.shape[1],), Xa.dtype)
    beta, _ = newton_train(Xa, y, beta0, kind="logistic", num_iters=num_iters)
    return beta


def predict_proba_logistic(X, beta):
    X = jnp.asarray(X)
    return _sigmoid(X @ beta[:-1] + beta[-1])
