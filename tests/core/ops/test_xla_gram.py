"""The gram contractions, all left to XLA: ``x.T @ x`` through the
BlockArray, the weighted Hessian gram of ``fast_glm``, and the streamed
``_sym_gram`` updates of the out-of-core path, against float64 NumPy at
ragged row counts, d = 128·k and d = 1000."""

import numpy as np
import pytest

# (rows, d): ragged rows, lane-multiple widths and the reference's d=1000.
SHAPES = [(1000, 128), (1003, 128), (2048, 256), (777, 384),
          (1500, 1000), (517, 1000)]
# fp32 products with fp32 accumulation over <= 2048 rows.
TOL = 2e-5


def _x(n, d, seed=0):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def _err(got, want):
    got = np.asarray(got, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("n,d", SHAPES)
def test_blockarray_gram(app_inst, n, d):
    x = _x(n, d)
    bx = app_inst.array(x, block_shape=(max(1, n // 4), d))
    G = (bx.T @ bx).get()
    assert G.shape == (d, d)
    x64 = x.astype(np.float64)
    assert _err(G, x64.T @ x64) < TOL


@pytest.mark.parametrize("n,d", SHAPES)
def test_weighted_gram(n, d):
    import jax.numpy as jnp

    from nums_tpu.models import fast_glm

    x = _x(n, d, seed=1)
    s = (np.abs(np.sin(np.arange(n))) + 0.01).astype(np.float32)
    H = fast_glm._gram(jnp.asarray(x), jnp.asarray(s))
    x64 = x.astype(np.float64)
    assert _err(H, (x64 * s[:, None]).T @ x64) < TOL
    assert _err(fast_glm._gram(jnp.asarray(x)), x64.T @ x64) < TOL


@pytest.mark.parametrize("n,d", SHAPES)
def test_streamed_sym_gram(n, d):
    """gram_update folds panels into a donated accumulator; the ragged
    last panel takes the same route."""
    import jax.numpy as jnp

    from nums_tpu.core.ops import streaming

    x = _x(n, d, seed=2)
    upd = streaming.gram_update()
    G = jnp.zeros((d, d), jnp.float32)
    step = max(1, n // 3)
    for lo in range(0, n, step):
        G = upd(G, jnp.asarray(x[lo:lo + step]))
    x64 = x.astype(np.float64)
    assert _err(G, x64.T @ x64) < TOL
    assert _err(streaming._sym_gram(jnp.asarray(x)), x64.T @ x64) < TOL


@pytest.mark.parametrize("n,d", [(1003, 128), (517, 1000)])
def test_gram_and_sum_and_normal_eq_updates(n, d):
    import jax.numpy as jnp

    from nums_tpu.core.ops import streaming

    x = _x(n, d, seed=3)
    y = np.random.RandomState(4).randn(n).astype(np.float32)
    G, s = streaming.gram_and_sum_update()(
        jnp.zeros((d, d), jnp.float32), jnp.zeros((d,), jnp.float32),
        jnp.asarray(x))
    G2, b = streaming.normal_eq_update()(
        jnp.zeros((d, d), jnp.float32), jnp.zeros((d,), jnp.float32),
        jnp.asarray(x), jnp.asarray(y))
    x64 = x.astype(np.float64)
    assert _err(G, x64.T @ x64) < TOL and _err(G2, x64.T @ x64) < TOL
    assert _err(s, x64.sum(axis=0)) < TOL
    assert _err(b, x64.T @ y) < TOL


@pytest.mark.parametrize("n,d", [(1003, 128), (777, 384), (517, 1000)])
def test_gram_ooc(app_inst, tmp_path, n, d):
    x = _x(n, d, seed=5)
    bx = app_inst.array(x, block_shape=(max(1, n // 3), d))
    dX = app_inst.spill(bx, str(tmp_path / "X"))
    G = app_inst.gram_ooc(dX).get()
    x64 = x.astype(np.float64)
    assert G.shape == (d, d)
    assert _err(G, x64.T @ x64) < TOL


def test_gram_ooc_keeps_logical_width(app_inst, tmp_path):
    """No lane padding: panels and accumulator keep the logical d."""
    from nums_tpu.core.array.application import ooc_put

    x = _x(300, 1000, seed=6)
    p, nv = ooc_put(app_inst.backend, x)
    assert p.shape[1] == 1000 and nv == 300
    bx = app_inst.array(x, block_shape=(100, 1000))
    assert tuple(bx.raw.shape)[1] == 1000
