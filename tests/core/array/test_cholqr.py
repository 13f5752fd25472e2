"""CholeskyQR2 path tests — force the accelerator-default TSQR method on
CPU and check it against the same oracles as the Householder tree."""

import numpy as np
import pytest

from nums_tpu.core import settings


@pytest.fixture()
def cholqr_mode():
    prev = settings.tsqr_method
    settings.tsqr_method = "cholqr2"
    yield
    settings.tsqr_method = prev


def test_cholqr2_qr(app_inst, cholqr_mode):
    rs = np.random.RandomState(0)
    x = rs.randn(2000, 32)
    bx = app_inst.array(x, block_shape=(500, 32))
    q, r = app_inst.direct_tsqr(bx)
    q, r = q.get(), r.get()
    assert np.allclose(q @ r, x, atol=1e-9)
    assert np.allclose(q.T @ q, np.eye(32), atol=1e-9)
    assert np.allclose(r, np.triu(r), atol=1e-12)
    r_only = app_inst.indirect_tsr(bx).get()
    assert np.allclose(np.abs(r_only), np.abs(r), atol=1e-6)


def test_cholqr2_svd_lstsq(app_inst, cholqr_mode):
    rs = np.random.RandomState(1)
    x = rs.randn(800, 10)
    bx = app_inst.array(x, block_shape=(200, 10))
    u, s, vt = app_inst.svd(bx)
    assert np.allclose(u.get() @ np.diag(s.get()) @ vt.get(), x, atol=1e-8)
    theta_true = rs.randn(10)
    y = x @ theta_true
    by = app_inst.array(y, block_shape=(200,))
    theta = app_inst.linear_regression(bx, by).get()
    assert np.allclose(theta, theta_true, atol=1e-8)


def test_cholqr2_moderately_ill_conditioned(app_inst, cholqr_mode):
    # cond ~ 1e5: within CholeskyQR2's validity (cond < 1/sqrt(eps_f64)).
    rs = np.random.RandomState(2)
    u, _ = np.linalg.qr(rs.randn(500, 20))
    v, _ = np.linalg.qr(rs.randn(20, 20))
    s = np.logspace(0, -5, 20)
    x = u @ np.diag(s) @ v.T
    bx = app_inst.array(x, block_shape=(125, 20))
    q, r = app_inst.direct_tsqr(bx)
    assert np.allclose(q.get() @ r.get(), x, atol=1e-10)
    assert np.allclose(q.get().T @ q.get(), np.eye(20), atol=1e-8)


def test_cholqr2_stream_overwrite(app_inst):
    rs = np.random.RandomState(3)
    x = rs.randn(1024, 16)
    bx = app_inst.array(x, block_shape=(256, 16))
    q, r = app_inst.direct_tsqr(bx, overwrite_x=True)
    qv, rv = q.get(), r.get()
    assert np.allclose(qv @ rv, x, atol=1e-9)
    assert np.allclose(qv.T @ qv, np.eye(16), atol=1e-9)
    # X now aliases Q (documented destructive behavior)
    assert np.allclose(bx.get(), qv)


def test_compensated_gram_accuracy():
    """Kahan-chunked gram beats naive f32 accumulation on tall inputs
    (VERDICT #10: recover full-Q orthogonality toward ~1e-6)."""
    import jax
    import jax.numpy as jnp
    from nums_tpu.core.ops import linalg as L

    rs = np.random.RandomState(0)
    m, n = 200_000, 8
    x64 = rs.randn(m, n) + 1.0  # offset inflates accumulation error
    x = jnp.asarray(x64, jnp.float32)
    oracle = x64.T @ x64
    hi = jax.lax.Precision.HIGHEST
    naive = np.asarray(
        jax.jit(lambda a: L._gram(a, hi, compensated=False))(x), np.float64
    )
    comp = np.asarray(
        jax.jit(lambda a: L._gram(a, hi, compensated=True))(x), np.float64
    )
    err_naive = np.abs(naive - oracle).max() / np.abs(oracle).max()
    err_comp = np.abs(comp - oracle).max() / np.abs(oracle).max()
    assert err_comp <= err_naive
    assert err_comp < 2e-6, (err_comp, err_naive)
