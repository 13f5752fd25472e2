"""Streaming accumulation kernels for out-of-core (DiskArray) ops.

Each kernel is a jitted update step applied once per row panel; the
accumulator argument is DONATED so XLA updates it in place — peak HBM
stays O(panel + accumulator) regardless of the dataset's total size.
Matmul precision follows the global ``NUMS_TPU_MATMUL_PRECISION``
setting like every other GEMM kernel.
"""

import functools

import jax
import jax.numpy as jnp

from nums_tpu.core.ops import linalg as _linalg


@functools.lru_cache(maxsize=None)
def gram_update():
    """G += panelᵀ panel."""

    @functools.partial(jax.jit, donate_argnums=(0,))
    def k(G, panel):
        return G + _sym_gram(panel)

    return k


def _sym_gram(panel):
    """panelᵀ panel, left to XLA (one dot_general; no transpose is
    materialized)."""
    return panel.T @ panel


@functools.lru_cache(maxsize=None)
def gram_and_sum_update():
    """(G, s) += (panelᵀ panel, panel.sum(0)) — the moments PCA needs,
    in ONE pass over the data."""

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def k(G, s, panel):
        return G + _sym_gram(panel), s + panel.sum(axis=0)

    return k


@functools.lru_cache(maxsize=None)
def normal_eq_update():
    """(G, b) += (panelᵀ panel, panelᵀ y_panel) — normal equations."""

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def k(G, b, panel, y_panel):
        return G + _sym_gram(panel), b + panel.T @ y_panel

    return k


@functools.lru_cache(maxsize=None)
def normal_eq_aug_update():
    """Intercept-AUGMENTED normal equations: with pa = [panel, 1],
    (G, q) += (paᵀ pa, paᵀ y) — one pass yields everything the linear
    ADMM (lasso/elastic-net) solve needs."""

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def k(G, q, panel, y_panel, nv):
        # Pad rows (sharded puts round rows up) must contribute ZERO —
        # their panel entries are zero-filled, and the intercept column
        # is the row-validity mask instead of plain ones.
        ones = (
            jnp.arange(panel.shape[0]) < nv
        ).astype(panel.dtype)[:, None]
        pa = jnp.concatenate([panel, ones], axis=1)
        return G + pa.T @ pa, q + pa.T @ y_panel

    return k


@functools.lru_cache(maxsize=None)
def reduce0_update(op: str):
    """acc = combine(acc, reduce(panel, axis=0)) for sum/min/max."""
    red = {"sum": jnp.sum, "min": jnp.min, "max": jnp.max}[op]
    comb = {"sum": jnp.add, "min": jnp.minimum, "max": jnp.maximum}[op]

    @functools.partial(jax.jit, donate_argnums=(0,))
    def k(acc, panel):
        return comb(acc, red(panel, axis=0))

    return k


@functools.lru_cache(maxsize=None)
def tsqr_r_update(chunk: int):
    """R = qr_r([R; panel]) — Householder combine, numerically robust
    for any conditioning (the gram path is the fast alternative)."""

    @functools.partial(jax.jit, donate_argnums=(0,))
    def k(R, panel):
        stacked = jnp.concatenate([R, panel], axis=0)
        return _linalg._tsqr_r_impl(stacked, chunk)

    return k


@functools.lru_cache(maxsize=None)
def glm_stats_update(kind: str):
    """Accumulate Newton statistics for one intercept-augmented panel.

    g += [p, 1]ᵀ (mu − y);  H += ([p, 1] · s)ᵀ [p, 1]
    with mu, s per GLM kind — the streaming form of
    ``fast_glm._newton_step_penalized``'s per-iteration math.
    """

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def k(g, H, panel, y_panel, beta, nv):
        # Pad rows are zero-filled and their intercept entry is masked
        # to zero, so every pad contribution to g and H vanishes.
        ones = (
            jnp.arange(panel.shape[0]) < nv
        ).astype(panel.dtype)[:, None]
        pa = jnp.concatenate([panel, ones], axis=1)
        eta = pa @ beta
        if kind == "logistic":
            mu = jax.nn.sigmoid(eta)
            s = mu * (1.0 - mu)
        elif kind == "linear":
            mu = eta
            s = jnp.ones_like(eta)
        elif kind == "poisson":
            mu = jnp.exp(eta)
            s = mu
        else:
            raise ValueError(kind)
        g = g + pa.T @ (mu - y_panel)
        H = H + (pa * s[:, None]).T @ pa
        return g, H

    return k


@functools.lru_cache(maxsize=None)
def glm_stats_update_aug(kind: str):
    """``glm_stats_update`` for panels that arrive ALREADY
    intercept-augmented from ``ooc_put(augment_ones=True)`` — serial
    backend only (no pad rows to mask)."""

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def k(g, H, pa, y_panel, beta):
        eta = pa @ beta
        if kind == "logistic":
            mu = jax.nn.sigmoid(eta)
            s = mu * (1.0 - mu)
        elif kind == "linear":
            mu = eta
            s = None  # H = paᵀpa: no (n,) ones vector to stream
        elif kind == "poisson":
            mu = jnp.exp(eta)
            s = mu
        else:
            raise ValueError(kind)
        g = g + pa.T @ (mu - y_panel)
        pw = pa if s is None else pa * s[:, None]
        return g, H + pw.T @ pa

    return k


@functools.lru_cache(maxsize=None)
def newton_update(penalized: bool):
    """beta' = beta − (H + diag(λ))⁻¹ (g + λ∘beta); returns max|g|."""

    @jax.jit
    def k(beta, g, H, lambda_vec):
        if penalized:
            g = g + lambda_vec * beta
            H = H + jnp.diag(lambda_vec)
        step = _linalg._posdef_solve_impl(H, g)
        return beta - step, jnp.max(jnp.abs(g))

    return k
