"""Compensated-gram unit tests: both chunk-sum shapes (batched tree /
scanned Kahan) against a float64 oracle. The real trigger thresholds
(2^20 rows, 512 MB stack) are monkeypatched down so the CPU suite
exercises the exact code paths an accelerator runs at 2^24x128 and
2.5Mx1000."""

import numpy as np
import pytest

import jax

from nums_tpu.core.ops import linalg as L


@pytest.fixture
def small_thresholds(monkeypatch):
    monkeypatch.setattr(L, "_COMP_CHUNK", 64)
    monkeypatch.setattr(L, "_COMP_MIN_ROWS", 256)
    yield


def _oracle(x):
    x64 = np.asarray(x, dtype=np.float64)
    return x64.T @ x64


@pytest.mark.parametrize("m,n", [(1000, 8), (1024, 8), (999, 3)])
def test_gram_batched_tree_branch(small_thresholds, monkeypatch, m, n):
    # Large stack ceiling -> the batched + pairwise-tree branch.
    monkeypatch.setattr(L, "_COMP_STACK_BYTES", 1 << 30)
    rs = np.random.RandomState(0)
    x = rs.randn(m, n).astype(np.float32)
    got = np.asarray(
        L._gram(jax.numpy.asarray(x), jax.lax.Precision.HIGHEST)
    )
    assert np.allclose(got, _oracle(x), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,n", [(1000, 8), (1024, 8), (999, 3)])
def test_gram_scan_kahan_branch(small_thresholds, monkeypatch, m, n):
    # Zero stack ceiling -> the scanned Kahan branch (incl. the
    # remainder-tail fold).
    monkeypatch.setattr(L, "_COMP_STACK_BYTES", 0)
    rs = np.random.RandomState(1)
    x = rs.randn(m, n).astype(np.float32)
    got = np.asarray(
        L._gram(jax.numpy.asarray(x), jax.lax.Precision.HIGHEST)
    )
    assert np.allclose(got, _oracle(x), rtol=1e-5, atol=1e-4)


def test_gram_branches_agree(small_thresholds, monkeypatch):
    rs = np.random.RandomState(2)
    x = jax.numpy.asarray(rs.randn(777, 5).astype(np.float32))
    monkeypatch.setattr(L, "_COMP_STACK_BYTES", 1 << 30)
    a = np.asarray(L._gram(x, jax.lax.Precision.HIGHEST))
    monkeypatch.setattr(L, "_COMP_STACK_BYTES", 0)
    b = np.asarray(L._gram(x, jax.lax.Precision.HIGHEST))
    assert np.allclose(a, b, rtol=1e-6, atol=1e-6)


def test_gram_uncompensated_below_threshold(small_thresholds):
    # Below _COMP_MIN_ROWS: the single-dot fast path.
    rs = np.random.RandomState(3)
    x = rs.randn(100, 4).astype(np.float32)
    got = np.asarray(
        L._gram(jax.numpy.asarray(x), jax.lax.Precision.HIGHEST)
    )
    assert np.allclose(got, _oracle(x), rtol=1e-5, atol=1e-5)
