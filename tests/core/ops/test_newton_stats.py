"""Newton statistics left to XLA: ``fast_glm._newton_stats`` and the
streamed ``glm_stats_update`` / ``glm_stats_update_aug`` /
``newton_update`` against float64 NumPy, for every GLM kind."""

import numpy as np
import pytest

KINDS = ["logistic", "linear", "poisson"]
TOL = 2e-5  # fp32 products and accumulation over <= 1000 rows


def _problem(kind, n=1000, d=12, seed=0):
    rs = np.random.RandomState(seed)
    X = (rs.randn(n, d) * 0.3).astype(np.float32)
    beta = (rs.randn(d) * 0.2).astype(np.float32)
    if kind == "logistic":
        y = (rs.rand(n) > 0.5).astype(np.float32)
    elif kind == "poisson":
        y = rs.poisson(1.0, n).astype(np.float32)
    else:
        y = rs.randn(n).astype(np.float32)
    return X, y, beta


def _oracle(kind, X, y, beta):
    X = X.astype(np.float64)
    eta = X @ beta.astype(np.float64)
    if kind == "logistic":
        mu = 1.0 / (1.0 + np.exp(-eta))
        s = mu * (1.0 - mu)
    elif kind == "linear":
        mu, s = eta, np.ones_like(eta)
    else:
        mu = np.exp(eta)
        s = mu
    return X.T @ (mu - y), (X * s[:, None]).T @ X


def _err(got, want):
    got = np.asarray(got, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("kind", KINDS)
def test_newton_stats(kind):
    import jax
    import jax.numpy as jnp

    from nums_tpu.models import fast_glm

    X, y, beta = _problem(kind)
    g, H = jax.jit(lambda X, y, b: fast_glm._newton_stats(kind, X, y, b))(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(beta))
    g64, H64 = _oracle(kind, X, y, beta)
    assert _err(g, g64) < TOL and _err(H, H64) < TOL


@pytest.mark.parametrize("kind", KINDS)
def test_newton_step(kind):
    import jax.numpy as jnp

    from nums_tpu.models import fast_glm

    X, y, beta = _problem(kind, seed=1)
    new, g = fast_glm._STEPS[kind](jnp.asarray(X), jnp.asarray(y),
                                   jnp.asarray(beta))
    g64, H64 = _oracle(kind, X, y, beta)
    want = beta - np.linalg.solve(H64, g64)
    assert _err(g, g64) < TOL
    assert _err(new, want) < 1e-4  # the solve adds cond(H) * eps


def _augmented(X):
    return np.concatenate([X, np.ones((X.shape[0], 1), X.dtype)], axis=1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pad_rows", [0, 5])
def test_glm_stats_update_masks_pad_rows(kind, pad_rows):
    """The masked update (mesh panels carry zero pad rows) equals the
    intercept-augmented oracle over the valid rows only."""
    import jax.numpy as jnp

    from nums_tpu.core.ops import streaming

    X, y, beta = _problem(kind, d=8, seed=2)
    beta = np.concatenate([beta, [0.1]]).astype(np.float32)
    n, d = X.shape
    Xp = np.concatenate([X, np.zeros((pad_rows, d), X.dtype)])
    yp = np.concatenate([y, np.zeros(pad_rows, y.dtype)])
    g, H = streaming.glm_stats_update(kind)(
        jnp.zeros((d + 1,), jnp.float32),
        jnp.zeros((d + 1, d + 1), jnp.float32),
        jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(beta), np.int32(n))
    g64, H64 = _oracle(kind, _augmented(X), y, beta)
    assert _err(g, g64) < TOL and _err(H, H64) < TOL


@pytest.mark.parametrize("kind", KINDS)
def test_glm_stats_update_aug(kind):
    """Panels already carrying the intercept column, two panels folded
    into the donated (g, H)."""
    import jax.numpy as jnp

    from nums_tpu.core.ops import streaming

    X, y, beta = _problem(kind, d=8, seed=3)
    Xa = _augmented(X)
    beta = np.concatenate([beta, [-0.05]]).astype(np.float32)
    upd = streaming.glm_stats_update_aug(kind)
    da = Xa.shape[1]
    g = jnp.zeros((da,), jnp.float32)
    H = jnp.zeros((da, da), jnp.float32)
    for lo in (0, 600):
        g, H = upd(g, H, jnp.asarray(Xa[lo:lo + 600]),
                   jnp.asarray(y[lo:lo + 600]), jnp.asarray(beta))
    g64, H64 = _oracle(kind, Xa, y, beta)
    assert _err(g, g64) < TOL and _err(H, H64) < TOL


@pytest.mark.parametrize("penalized", [False, True])
def test_newton_update(penalized):
    import jax.numpy as jnp

    from nums_tpu.core.ops import streaming

    rs = np.random.RandomState(4)
    A = rs.randn(20, 6)
    H = (A.T @ A + np.eye(6)).astype(np.float32)
    g = rs.randn(6).astype(np.float32)
    beta = rs.randn(6).astype(np.float32)
    lv = np.full(6, 0.5, np.float32)
    new, gmax = streaming.newton_update(penalized)(
        jnp.asarray(beta), jnp.asarray(g), jnp.asarray(H), jnp.asarray(lv))
    g64, H64 = g.astype(np.float64), H.astype(np.float64)
    if penalized:
        g64 = g64 + lv * beta
        H64 = H64 + np.diag(lv)
    assert _err(new, beta - np.linalg.solve(H64, g64)) < 1e-5
    assert abs(float(gmax) - np.max(np.abs(g64))) < 1e-5
