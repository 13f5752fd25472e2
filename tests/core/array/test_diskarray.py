"""Out-of-core DiskArray + streaming ops vs in-core NumPy oracles."""

import os

import numpy as np
import pytest

from nums_tpu.core.array.diskarray import DiskArray


@pytest.fixture
def disk_xy(app_inst, tmp_path):
    rs = np.random.RandomState(0)
    n, d = 103, 6  # ragged: 103 rows over 25-row blocks
    real_X = rs.randn(n, d)
    real_y = real_X @ np.linspace(-1, 1, d) + 0.1 * rs.randn(n)
    X = app_inst.array(real_X, block_shape=(25, d))
    y = app_inst.array(real_y, block_shape=(25,))
    dX = app_inst.spill(X, str(tmp_path / "X"))
    dy = app_inst.spill(y, str(tmp_path / "y"))
    return real_X, real_y, dX, dy


def test_spill_open_roundtrip(app_inst, disk_xy):
    real_X, _, dX, _ = disk_xy
    assert isinstance(dX, DiskArray)
    assert dX.shape == real_X.shape and dX.ndim == 2
    assert dX.num_row_panels == 5  # ceil(103/25)
    assert np.allclose(dX.to_block_array().get(), real_X)
    # Panels tile the rows exactly, prefetch on and off.
    for prefetch in (False, True):
        rows = [p for _, p in dX.iter_row_panels(prefetch=prefetch)]
        assert np.allclose(np.concatenate(rows, axis=0), real_X)
    back = app_inst.open_fs(dX.path)
    assert back.shape == dX.shape


def test_gram_and_reductions_ooc(app_inst, disk_xy):
    real_X, _, dX, _ = disk_xy
    assert np.allclose(
        app_inst.gram_ooc(dX).get(), real_X.T @ real_X, atol=1e-8
    )
    assert np.allclose(app_inst.sum_ooc(dX).get(), real_X.sum(axis=0))
    assert np.allclose(app_inst.min_ooc(dX).get(), real_X.min(axis=0))
    assert np.allclose(app_inst.max_ooc(dX).get(), real_X.max(axis=0))
    assert np.allclose(app_inst.mean_ooc(dX).get(), real_X.mean(axis=0))


def test_tsqr_r_ooc(app_inst, disk_xy):
    real_X, _, dX, _ = disk_xy
    R = app_inst.tsqr_r_ooc(dX).get()
    # Factorization-valid: R'R == X'X; R triangular.
    assert np.allclose(R.T @ R, real_X.T @ real_X, atol=1e-8)
    assert np.allclose(R, np.triu(R))


def test_linear_regression_ooc(app_inst, disk_xy):
    real_X, real_y, dX, dy = disk_xy
    want = np.linalg.lstsq(real_X, real_y, rcond=None)[0]
    # y as host array and as an aligned DiskArray.
    got_host = app_inst.linear_regression_ooc(dX, real_y).get()
    got_disk = app_inst.linear_regression_ooc(dX, dy).get()
    assert np.allclose(got_host, want, atol=1e-6)
    assert np.allclose(got_disk, want, atol=1e-6)
    # Ridge shrinkage (closed form).
    lamb = 5.0
    want_r = np.linalg.solve(
        real_X.T @ real_X + lamb * np.eye(6), real_X.T @ real_y
    )
    assert np.allclose(
        app_inst.linear_regression_ooc(dX, real_y, lamb=lamb).get(),
        want_r, atol=1e-6,
    )


def test_glm_fit_out_of_core_matches_in_core(app_inst, tmp_path):
    from nums_tpu.core.io.datasets import BimodalGaussian
    from nums_tpu.models.glms import LogisticRegression

    real_X, real_y = BimodalGaussian.get_dataset(600, 5)
    X = app_inst.array(real_X, block_shape=(150, 5))
    y = app_inst.array(real_y, block_shape=(150,))
    dX = app_inst.spill(X, str(tmp_path / "glmX"))
    dy = app_inst.spill(y, str(tmp_path / "glmy"))

    m_core = LogisticRegression(solver="newton", tol=1e-9, max_iter=10)
    m_core.fit(X, y)
    m_ooc = LogisticRegression(solver="newton", tol=1e-9, max_iter=10)
    m_ooc.fit(dX, dy)  # same fit() entry point, out-of-core path
    assert np.allclose(
        m_ooc.coef_.get(), m_core.coef_.get(), atol=1e-5
    )
    assert np.isclose(
        float(m_ooc.intercept_.get()), float(m_core.intercept_.get()),
        atol=1e-5,
    )
    # Predict with the OOC-trained model on in-core data.
    acc = (m_ooc.predict(X).get() == real_y).mean()
    assert acc > 0.95


def test_glm_fit_ooc_l2_and_errors(app_inst, tmp_path):
    from nums_tpu.models.glms import LinearRegression, LogisticRegression

    rs = np.random.RandomState(1)
    real_X = rs.randn(80, 4)
    real_y = real_X @ np.array([1.0, -2.0, 3.0, 0.5]) + 2.0
    X = app_inst.array(real_X, block_shape=(20, 4))
    dX = app_inst.spill(X, str(tmp_path / "rX"))

    m_core = LinearRegression(penalty="l2", C=0.1, solver="newton",
                              max_iter=10, tol=1e-10).fit(
        X, app_inst.array(real_y, block_shape=(20,)))
    m_ooc = LinearRegression(penalty="l2", C=0.1, solver="newton",
                             max_iter=10, tol=1e-10).fit(dX, real_y)
    assert np.allclose(m_ooc.coef_.get(), m_core.coef_.get(), atol=1e-6)

    with pytest.raises(NotImplementedError):
        LogisticRegression(solver="irls").fit(dX, real_y)
    with pytest.raises(NotImplementedError):
        LogisticRegression(penalty="l1", solver="admm").fit(dX, real_y)


def test_from_panels_roundtrip(app_inst, tmp_path):
    rs = np.random.RandomState(4)
    x = rs.randn(53, 3)

    def panels():
        yield x[:20]
        yield x[20:40]
        yield x[40:]

    da = DiskArray.from_panels(
        str(tmp_path / "fp"), app_inst.fs, panels(), x.shape, x.dtype, 10
    )
    assert da.shape == (53, 3)
    assert np.allclose(da.to_block_array().get(), x)
    # First-class checkpoint: CRC scrub is clean.
    assert app_inst.verify_fs(da.path)["ok"]


def test_pca_out_of_core_matches_in_core(app_inst, tmp_path):
    from nums_tpu.models.decomposition import PCA

    rs = np.random.RandomState(5)
    real_X = rs.randn(300, 8) @ np.diag([5, 4, 3, 2, 1, 0.5, 0.2, 0.1])
    real_X += rs.randn(8)  # non-zero mean
    X = app_inst.array(real_X, block_shape=(60, 8))
    dX = app_inst.spill(X, str(tmp_path / "pcaX"))
    k = 3
    core = PCA(n_components=k).fit(X)
    ooc = PCA(n_components=k).fit(dX)
    # Components match up to the shared sign convention.
    c1, c2 = core.components_.get(), ooc.components_.get()
    for i in range(k):
        assert np.allclose(c1[i], c2[i], atol=1e-6) or np.allclose(
            c1[i], -c2[i], atol=1e-6
        )
    assert np.allclose(
        core.explained_variance_.get(), ooc.explained_variance_.get(),
        rtol=1e-6,
    )
    assert np.allclose(
        core.explained_variance_ratio_.get(),
        ooc.explained_variance_ratio_.get(), rtol=1e-6,
    )
    assert np.isclose(
        float(core.noise_variance_.get()), float(ooc.noise_variance_.get()),
        rtol=1e-6,
    )
    # Streaming transform writes a DiskArray matching in-core transform
    # (up to per-component sign).
    t_disk = ooc.transform(dX, out=str(tmp_path / "pcaT"))
    t_core = ooc.transform(X).get()
    assert t_disk.shape == (300, k)
    assert np.allclose(t_disk.to_block_array().get(), t_core, atol=1e-6)
    # fit_transform on disk == fit + transform.
    t2 = PCA(n_components=k).fit_transform(dX)
    assert np.allclose(
        np.abs(t2.to_block_array().get()), np.abs(t_core), atol=1e-5
    )


def test_pca_ooc_whiten(app_inst, tmp_path):
    from nums_tpu.models.decomposition import PCA

    rs = np.random.RandomState(6)
    real_X = rs.randn(200, 5) * [3.0, 2.0, 1.0, 0.5, 0.1]
    X = app_inst.array(real_X, block_shape=(50, 5))
    dX = app_inst.spill(X, str(tmp_path / "wX"))
    m = PCA(n_components=3, whiten=True).fit(dX)
    t = m.transform(dX).to_block_array().get()
    # Whitened projections have ~unit variance per component.
    assert np.allclose(t.var(axis=0, ddof=1), 1.0, rtol=1e-3)


def test_truncated_svd_out_of_core(app_inst, tmp_path):
    from nums_tpu.models.decomposition import TruncatedSVD

    rs = np.random.RandomState(7)
    real_X = rs.randn(250, 6) + 10.0  # non-centered (the LSA case)
    X = app_inst.array(real_X, block_shape=(50, 6))
    dX = app_inst.spill(X, str(tmp_path / "tsX"))
    k = 2
    core = TruncatedSVD(n_components=k).fit(X)
    ooc = TruncatedSVD(n_components=k).fit(dX)
    assert np.allclose(
        np.abs(core.components_.get()), np.abs(ooc.components_.get()),
        atol=1e-6,
    )
    assert np.allclose(
        core.singular_values_.get(), ooc.singular_values_.get(), rtol=1e-6
    )
    assert np.allclose(
        core.explained_variance_.get(), ooc.explained_variance_.get(),
        rtol=1e-5,
    )
    assert np.allclose(
        core.explained_variance_ratio_.get(),
        ooc.explained_variance_ratio_.get(), rtol=1e-5,
    )


def test_glm_predict_ooc_streams_to_disk(app_inst, tmp_path):
    from nums_tpu.core.io.datasets import BimodalGaussian
    from nums_tpu.models.glms import LinearRegression, LogisticRegression

    real_X, real_y = BimodalGaussian.get_dataset(400, 4)
    X = app_inst.array(real_X, block_shape=(100, 4))
    y = app_inst.array(real_y, block_shape=(100,))
    dX = app_inst.spill(X, str(tmp_path / "pX"))
    m = LogisticRegression(solver="newton", tol=1e-9, max_iter=10)
    m.fit(X, y)
    pred_disk = m.predict_ooc(dX, out=str(tmp_path / "pred"))
    assert pred_disk.shape == (400,)
    assert np.array_equal(
        pred_disk.to_block_array().get(), m.predict(X).get()
    )
    # Linear: continuous predictions match too.
    yl = real_X @ np.arange(1.0, 5.0) + 1.0
    lm = LinearRegression(solver="newton", tol=1e-10, max_iter=5)
    lm.fit(X, app_inst.array(yl, block_shape=(100,)))
    pl = lm.predict_ooc(dX, out=str(tmp_path / "predl"))
    assert np.allclose(
        pl.to_block_array().get(), lm.predict(X).get(), atol=1e-5
    )


def test_diskarray_reads_fail_over_to_replicas(app_inst, tmp_path):
    """Streamed panel reads share read_fs's resilience: a lost primary
    block fails over (CRC-guarded) to a replica copy."""
    rs = np.random.RandomState(10)
    x = rs.randn(60, 4)
    X = app_inst.array(x, block_shape=(20, 4))
    dX = app_inst.spill(X, str(tmp_path / "repX"), replicas=2)
    os.remove(os.path.join(dX.path, "block_1_0.npy"))
    rows = np.concatenate([p for _, p in dX.iter_row_panels()])
    assert np.allclose(rows, x)
    # verify=True catches SILENT corruption and routes around it.
    np.save(os.path.join(dX.path, "block_0_0.npy"), rs.randn(20, 4))
    dv = app_inst.open_fs(str(tmp_path / "repX"), verify=True)
    rows = np.concatenate([p for _, p in dv.iter_row_panels()])
    assert np.allclose(rows, x)
    app_inst.delete_fs(str(tmp_path / "repX"))


def test_unrelated_rN_sibling_not_treated_as_replica(app_inst, tmp_path):
    """A user checkpoint literally named '<base>.r2' next to the primary
    must never be deleted as a replica (suffix patterns are per
    scheme)."""
    base = str(tmp_path / "run")
    other = str(tmp_path / "run.r2")
    a, b = np.arange(4.0), np.arange(4.0) * 9
    app_inst.write_fs(app_inst.array(a, block_shape=(4,)), base)
    app_inst.write_fs(app_inst.array(b, block_shape=(4,)), other)
    app_inst.write_fs(app_inst.array(a + 1, block_shape=(4,)), base)
    assert np.allclose(app_inst.read_fs(other).get(), b)  # survived
    app_inst.delete_fs(base)
    assert np.allclose(app_inst.read_fs(other).get(), b)  # still there
    app_inst.delete_fs(other)


def test_kmeans_fit_predict_ooc(app_inst, tmp_path):
    from nums_tpu.models.cluster import KMeans

    rs = np.random.RandomState(11)
    x = np.concatenate([rs.randn(40, 3), rs.randn(40, 3) + 6.0])
    X = app_inst.array(x, block_shape=(20, 3))
    dX = app_inst.spill(X, str(tmp_path / "kfp"))
    labels = KMeans(n_clusters=2, seed=2).fit_predict(dX)
    from nums_tpu.core.array.diskarray import DiskArray

    assert isinstance(labels, DiskArray)
    host = labels.to_block_array().get()
    assert len(set(host[:40])) == 1 and len(set(host[40:])) == 1
    assert host[0] != host[-1]


def test_gbt_single_class_raises(app_inst):
    from nums_tpu.models.trees import GBTClassifier

    rs = np.random.RandomState(12)
    X = app_inst.array(rs.randn(40, 3), block_shape=(20, 3))
    y = app_inst.array(np.zeros(40), block_shape=(20,))
    with pytest.raises(ValueError, match="single class"):
        GBTClassifier(n_estimators=2, max_depth=2).fit(X, y)


def test_lasso_out_of_core_one_pass(app_inst, tmp_path):
    """Lasso on a DiskArray: one streamed pass for the moments, prox
    loop on (d+1)^2 state — matches the in-core fused ADMM solution."""
    from nums_tpu.models.glms import ElasticNet, Lasso

    rs = np.random.RandomState(13)
    n, d = 600, 8
    theta = np.zeros(d)
    theta[[1, 4, 6]] = [2.0, -1.5, 3.0]
    real_X = rs.randn(n, d)
    real_y = real_X @ theta + 1.0 + 0.01 * rs.randn(n)
    X = app_inst.array(real_X, block_shape=(150, d))
    y = app_inst.array(real_y, block_shape=(150,))
    dX = app_inst.spill(X, str(tmp_path / "lassoX"))

    kw = dict(alpha=0.02, tol=1e-7, max_iter=500)
    core = Lasso(**kw).fit(X, y)
    ooc = Lasso(**kw).fit(dX, real_y)
    assert np.allclose(ooc.coef_.get(), core.coef_.get(), atol=1e-4)
    assert np.isclose(float(ooc.intercept_.get()),
                      float(core.intercept_.get()), atol=1e-3)
    support = set(np.flatnonzero(np.abs(ooc.coef_.get()) > 1e-6))
    assert support == {1, 4, 6}, support
    # elastic-net too
    en_core = ElasticNet(l1_ratio=0.7, **kw).fit(X, y)
    en_ooc = ElasticNet(l1_ratio=0.7, **kw).fit(dX, real_y)
    assert np.allclose(
        en_ooc.coef_.get(), en_core.coef_.get(), atol=1e-4
    )


def test_ooc_panels_shard_over_mesh(app_inst):
    """Under the mesh backend a streamed panel is row-sharded across
    ALL devices (pad rows masked/neutral); serial places it whole."""
    import numpy as np

    from nums_tpu.core.array.application import ooc_put
    from nums_tpu.core.backend import MeshBackend

    panel = np.arange(26.0).reshape(13, 2)  # 13 rows: pads to 16 on 8 dev
    p, nv = ooc_put(app_inst.backend, panel)
    assert nv == 13
    if isinstance(app_inst.backend, MeshBackend):
        n_dev = int(np.prod(app_inst.backend.mesh.devices.shape))
        assert p.shape[0] % n_dev == 0 and p.shape[0] >= 13
        assert not p.sharding.is_fully_replicated
        assert len(p.sharding.device_set) == n_dev
    else:
        assert p.shape == (13, 2)


def test_integer_reductions_ooc_with_ragged_panels(app_inst, tmp_path):
    """min/max on an int DiskArray whose panels need mesh padding must
    not absorb the pad fill (review finding: np.full cast +inf to
    INT_MIN)."""
    vals = np.array([5, 9, 3, 7, 11, 2, 8, 6, 4, 10, 12, 1, 13],
                    dtype=np.int32)  # 13 rows: pads on the 8-dev mesh
    X = app_inst.array(vals, block_shape=(13,))
    dX = app_inst.spill(X, str(tmp_path / "ints"))
    assert int(app_inst.min_ooc(dX).get()) == 1
    assert int(app_inst.max_ooc(dX).get()) == 13
    assert int(app_inst.sum_ooc(dX).get()) == int(vals.sum())


def test_linear_regression_ooc_rejects_mismatched_y(app_inst, disk_xy):
    """Review regression: an oversized host y must raise, not be
    silently truncated to X's row range (a stale y from a larger
    dataset would otherwise fit a plausible-but-wrong model)."""
    real_X, real_y, dX, _ = disk_xy
    import pytest as _pytest

    with _pytest.raises(ValueError, match="rows"):
        app_inst.linear_regression_ooc(
            dX, np.concatenate([real_y, real_y[:3]])
        )
    with _pytest.raises(ValueError, match="rows"):
        app_inst.linear_regression_ooc(dX, real_y[:-1])


def test_ooc_put_rejects_serial_only_kwargs_on_mesh(app_inst):
    """Review regression: augment_ones is serial-only; mesh callers
    must get a loud error instead of a silent no-op."""
    import pytest as _pytest

    from nums_tpu.core.array.application import ooc_put
    from nums_tpu.core.backend import MeshBackend

    panel = np.ones((8, 3))
    if isinstance(app_inst.backend, MeshBackend):
        with _pytest.raises(ValueError, match="serial-backend only"):
            ooc_put(app_inst.backend, panel, augment_ones=True)
    else:
        p, nv = ooc_put(app_inst.backend, panel, augment_ones=True)
        assert nv == 8 and p.shape == (8, 4)
        np.testing.assert_array_equal(np.asarray(p)[:, -1], 1.0)
