"""GLM solver tests (parity: reference tests/models/test_glms.py:30-180)."""

import numpy as np
import pytest

from nums_tpu.core.io.datasets import BimodalGaussian


LOGISTIC_PARAMS = [
    {"solver": "gd", "lr": 1e-6, "tol": 1e-8, "max_iter": 10},
    {"solver": "sgd", "lr": 1e-6, "tol": 1e-8, "max_iter": 10},
    {"solver": "block_sgd", "lr": 1e-6, "tol": 1e-8, "max_iter": 10},
    {"solver": "newton", "tol": 1e-8, "max_iter": 10},
    {"solver": "irls", "tol": 1e-8, "max_iter": 10},
]


def test_logistic(nps_app_inst):
    from nums_tpu.models.glms import LogisticRegression

    num_samples, num_features = 1000, 10
    real_X, real_y = BimodalGaussian.get_dataset(num_samples, num_features)
    X = nps_app_inst.array(real_X, block_shape=(100, 3))
    y = nps_app_inst.array(real_y, block_shape=(100,))
    for kwargs in LOGISTIC_PARAMS:
        model = LogisticRegression(**kwargs)
        model.fit(X, y)
        y_pred = model.predict(X).get()
        proba = model.predict_proba(X).get()
        assert np.allclose(np.ones(num_samples), proba[:, 0] + proba[:, 1])
        acc = np.sum(real_y == y_pred) / num_samples
        if kwargs["solver"] in ("newton", "irls"):
            assert acc > 0.95, (kwargs, acc)
        assert np.isfinite(model.grad_norm_sq(X, y).get())
        assert np.isfinite(model.objective(X, y).get())


def test_logistic_l2(nps_app_inst):
    from nums_tpu.models.glms import LogisticRegression

    real_X, real_y = BimodalGaussian.get_dataset(800, 8, p=0.5)
    X = nps_app_inst.array(real_X, block_shape=(200, 8))
    y = nps_app_inst.array(real_y, block_shape=(200,))
    m_plain = LogisticRegression(solver="newton", tol=1e-8, max_iter=10)
    m_plain.fit(X, y)
    m_l2 = LogisticRegression(
        solver="newton", penalty="l2", C=1.0 / 10.0, tol=1e-8, max_iter=10
    )
    m_l2.fit(X, y)
    # L2 shrinks the coefficient norm.
    assert (
        np.linalg.norm(m_l2._beta.get()) < np.linalg.norm(m_plain._beta.get())
    )
    assert np.sum(real_y == m_l2.predict(X).get()) / 800 > 0.9


def test_linear(nps_app_inst):
    from nums_tpu.models.glms import LinearRegression

    num_samples, num_features = 1000, 6
    rs = np.random.RandomState(7)
    theta = rs.randn(num_features)
    real_X, real_y = BimodalGaussian.get_dataset(
        num_samples, num_features, theta=theta
    )
    X = nps_app_inst.array(real_X, block_shape=(250, 6))
    y = nps_app_inst.array(real_y, block_shape=(250,))
    model = LinearRegression(solver="newton", tol=1e-8, max_iter=10)
    model.fit(X, y)
    y_pred = model.predict(X).get()
    assert np.allclose(y_pred, real_y, atol=1e-4)
    r2 = model.deviance_sqr(X, y).get()
    assert r2 > 0.999


def test_poisson(nps_app_inst):
    from nums_tpu.models.glms import PoissonRegression

    rs = np.random.RandomState(1337)
    n, d = 1000, 4
    beta_true = rs.rand(d) * 0.3
    X_real = rs.randn(n, d)
    lam = np.exp(X_real @ beta_true)
    y_real = rs.poisson(lam).astype(float)
    X = nps_app_inst.array(X_real, block_shape=(250, d))
    y = nps_app_inst.array(y_real, block_shape=(250,))
    model = PoissonRegression(solver="newton", tol=1e-8, max_iter=20)
    model.fit(X, y)
    beta_hat = model._beta.get()
    assert np.allclose(beta_hat, beta_true, atol=0.15)
    assert np.isfinite(model.objective(X, y).get())
    dev = model.deviance(y, model.predict(X)).get()
    assert np.isfinite(dev) and dev >= 0


def test_logistic_cv(nps_app_inst):
    """K-fold CV via block assignment (parity: reference test_glms.py CV loop)."""
    from nums_tpu.models.glms import LogisticRegression

    num_samples, num_features = 600, 5
    block_rows = 150
    folds = num_samples // block_rows
    real_X, real_y = BimodalGaussian.get_dataset(num_samples, num_features, p=0.5)
    X = nps_app_inst.array(real_X, block_shape=(block_rows, num_features))
    y = nps_app_inst.array(real_y, block_shape=(block_rows,))
    accs = []
    for f in range(folds):
        lo, hi = f * block_rows, (f + 1) * block_rows
        train_idx = np.concatenate(
            [np.arange(0, lo), np.arange(hi, num_samples)]
        )
        X_train, y_train = X[train_idx], y[train_idx]
        X_test, y_test = X[lo:hi], y[lo:hi]
        model = LogisticRegression(solver="newton", tol=1e-8, max_iter=10)
        model.fit(X_train, y_train)
        pred = model.predict(X_test).get()
        accs.append(np.mean(pred == y_test.get()))
    assert np.mean(accs) > 0.9


def test_exponential(nps_app_inst):
    """ExponentialRegression is trainable here (the reference stubs it)."""
    from nums_tpu.models.glms import ExponentialRegression

    rs = np.random.RandomState(77)
    n, d = 2000, 3
    beta_true = rs.rand(d) * 0.4
    X_real = rs.randn(n, d)
    mu = np.exp(X_real @ beta_true)
    y_real = rs.exponential(scale=mu)
    X = nps_app_inst.array(X_real, block_shape=(500, d))
    y = nps_app_inst.array(y_real, block_shape=(500,))
    model = ExponentialRegression(solver="newton", tol=1e-8, max_iter=25)
    model.fit(X, y)
    assert np.allclose(model._beta.get(), beta_true, atol=0.15)
    dev = model.deviance(y, model.predict(X)).get()
    assert np.isfinite(dev) and dev >= 0


def test_fast_glm_matches_blockarray_glm(nps_app_inst):
    """The fused train step converges to the same solution."""
    from nums_tpu.models.glms import LogisticRegression
    from nums_tpu.models import fast_glm

    real_X, real_y = BimodalGaussian.get_dataset(500, 6)
    X = nps_app_inst.array(real_X, block_shape=(125, 6))
    y = nps_app_inst.array(real_y, block_shape=(125,))
    model = LogisticRegression(solver="newton", tol=1e-10, max_iter=10)
    model.fit(X, y)
    beta_fast = np.asarray(fast_glm.fit_logistic(real_X, real_y, num_iters=10))
    beta_slow = np.concatenate(
        [model._beta.get(), [float(model._beta0.get())]]
    )
    assert np.allclose(beta_fast, beta_slow, atol=1e-5)


def test_fused_vs_eager_newton(nps_app_inst):
    """The fused while_loop Newton must match the eager per-op loop."""
    from nums_tpu.core import settings
    from nums_tpu.models.glms import LogisticRegression, PoissonRegression

    real_X, real_y = BimodalGaussian.get_dataset(400, 5)
    X = nps_app_inst.array(real_X, block_shape=(100, 5))
    y = nps_app_inst.array(real_y, block_shape=(100,))

    def fit(fuse, cls=LogisticRegression, **kw):
        prev = settings.glm_fuse
        settings.glm_fuse = fuse
        try:
            m = cls(solver="newton", tol=1e-8, max_iter=8, **kw)
            m.fit(X, y)
            return np.concatenate([m._beta.get(), [float(m._beta0.get())]])
        finally:
            settings.glm_fuse = prev

    assert np.allclose(fit("1"), fit("0"), atol=1e-9)
    # l2-penalized path too
    assert np.allclose(
        fit("1", penalty="l2", C=0.5), fit("0", penalty="l2", C=0.5),
        atol=1e-9,
    )
    # Every fused kind drifts together with its eager twin (the two
    # implementations are maintained in parallel — this sweep is the
    # drift guard).
    from nums_tpu.models.glms import LinearRegression

    assert np.allclose(
        fit("1", cls=LinearRegression), fit("0", cls=LinearRegression),
        atol=1e-8,
    )
    assert np.allclose(
        fit("1", cls=LinearRegression, penalty="l2", C=0.5),
        fit("0", cls=LinearRegression, penalty="l2", C=0.5),
        atol=1e-8,
    )
    assert np.allclose(
        fit("1", cls=PoissonRegression), fit("0", cls=PoissonRegression),
        atol=1e-7,
    )


def test_lbfgs_solver(nps_app_inst):
    """lbfgs is implemented here (the reference stubs it, glms.py:393-394)."""
    from nums_tpu.models.glms import LogisticRegression, LinearRegression

    real_X, real_y = BimodalGaussian.get_dataset(600, 6)
    X = nps_app_inst.array(real_X, block_shape=(150, 6))
    y = nps_app_inst.array(real_y, block_shape=(150,))
    m = LogisticRegression(solver="lbfgs", tol=1e-8, max_iter=100)
    m.fit(X, y)
    acc = np.mean(m.predict(X).get() == real_y)
    assert acc > 0.95, acc
    # With l2 the objective is strictly convex: lbfgs and newton must find
    # the same optimum. (Unpenalized separable data has no finite MLE.)
    kw = {"penalty": "l2", "C": 1.0, "tol": 1e-10, "max_iter": 200}
    m_l = LogisticRegression(solver="lbfgs", **kw)
    m_l.fit(X, y)
    m_n = LogisticRegression(solver="newton", **kw)
    m_n.fit(X, y)
    assert np.allclose(m_l._beta.get(), m_n._beta.get(), atol=1e-3)

    rs = np.random.RandomState(0)
    theta = rs.randn(6)
    real_X2, real_y2 = BimodalGaussian.get_dataset(600, 6, theta=theta)
    X2 = nps_app_inst.array(real_X2, block_shape=(150, 6))
    y2 = nps_app_inst.array(real_y2, block_shape=(150,))
    lin = LinearRegression(solver="lbfgs", tol=1e-10, max_iter=200)
    lin.fit(X2, y2)
    assert np.allclose(lin.predict(X2).get(), real_y2, atol=1e-3)


def test_model_save_load(nps_app_inst, tmp_path):
    """Model checkpointing (absent in the reference)."""
    from nums_tpu.models.glms import GLM, LogisticRegression

    real_X, real_y = BimodalGaussian.get_dataset(400, 5)
    X = nps_app_inst.array(real_X, block_shape=(100, 5))
    y = nps_app_inst.array(real_y, block_shape=(100,))
    m = LogisticRegression(solver="newton", tol=1e-8, max_iter=10)
    m.fit(X, y)
    path = str(tmp_path / "model1")
    m.save(path)
    m2 = GLM.load(path)
    assert type(m2).__name__ == "LogisticRegression"
    assert np.allclose(m2._beta.get(), m._beta.get())
    assert np.allclose(m2.predict(X).get(), m.predict(X).get())
    assert np.allclose(
        m2.predict_proba(X).get(), m.predict_proba(X).get(), atol=1e-12
    )


def test_sklearn_conveniences(nps_app_inst):
    from nums_tpu.models.glms import LogisticRegression, LinearRegression

    real_X, real_y = BimodalGaussian.get_dataset(400, 5)
    X = nps_app_inst.array(real_X, block_shape=(100, 5))
    y = nps_app_inst.array(real_y, block_shape=(100,))
    m = LogisticRegression(solver="newton", tol=1e-8, max_iter=10)
    m.fit(X, y)
    assert m.coef_.shape == (5,)
    assert m.intercept_.shape == ()
    assert float(m.score(X, y)) > 0.95
    rs = np.random.RandomState(0)
    theta = rs.randn(5)
    X2r, y2r = BimodalGaussian.get_dataset(400, 5, theta=theta)
    X2 = nps_app_inst.array(X2r, block_shape=(100, 5))
    y2 = nps_app_inst.array(y2r, block_shape=(100,))
    lin = LinearRegression(solver="newton", max_iter=10)
    lin.fit(X2, y2)
    assert float(lin.score(X2, y2)) > 0.999


def test_sgd_draws_fresh_samples(nps_app_inst):
    """Review regression: rs.numpy() reseeds per call, so drawing the
    index inside the loop trained on ONE fixed row forever. The loop
    must hold a single generator and visit many distinct rows."""
    from nums_tpu.models import glms

    app = nps_app_inst
    n, d = 32, 2
    X = app.array(
        np.arange(n * d, dtype=float).reshape(n, d), block_shape=(n, d)
    )
    y = app.array(np.zeros(n), block_shape=(n,))
    seen = []

    class Probe:
        def __init__(self):
            self.rs = app.random_state(0)

        def forward(self, Xs, beta):
            return Xs[:, 0]

        def gradient(self, Xs, ys, mu, beta=None):
            seen.append(float(Xs.get()[0, 0]))
            return app.zeros((d,), (d,))

    beta = app.zeros((d,), (d,))
    glms.sgd(Probe(), beta, X, y, app.scalar(-1.0), 25, app.scalar(0.1))
    assert len(seen) == 25
    assert len(set(seen)) > 5, "sgd re-drew the same sample every step"


def test_penalized_model_usable_after_load(nps_app_inst, tmp_path):
    """Review regression: load() restores the penalty vector, so
    gradient/hessian/grad_norm_sq work on a loaded Ridge (previously
    _lam_for returned None -> TypeError until refit)."""
    from nums_tpu.models.glms import GLM, Ridge

    rs = np.random.RandomState(0)
    real_X = rs.randn(80, 4)
    real_y = real_X @ np.arange(1.0, 5.0) + 0.5
    X = nps_app_inst.array(real_X, block_shape=(40, 4))
    y = nps_app_inst.array(real_y, block_shape=(40,))
    m = Ridge(alpha=1.0).fit(X, y)
    want = float(m.grad_norm_sq(X, y).get())
    m.save(str(tmp_path / "ridge"))
    m2 = GLM.load(str(tmp_path / "ridge"))
    got = float(m2.grad_norm_sq(X, y).get())
    assert np.isfinite(got)
    assert abs(got - want) < 1e-6 * max(1.0, abs(want))
