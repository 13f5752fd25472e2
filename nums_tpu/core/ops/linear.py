"""Linear-algebra contraction kernels.

Replaces the reference's blocked tensordot driver loop — output block (i,j)
= sum_k A[i,k]·B[k,j] dispatched as O(p·q·k) Ray tasks with a sequential
add-chain (``nums/core/array/blockarray.py:442-473``) — with one jitted
``dot_general``. XLA tiles it onto the matrix units and, under a mesh,
partitions it SUMMA-style with all-gathers/reduce-scatters chosen by the SPMD
partitioner; the k-combine becomes a log-depth all-reduce instead of the
reference's sequential chain.
"""

import functools

import jax
import jax.numpy as jnp


def _maybe_t(x, transposed):
    return jnp.transpose(x) if transposed else x


@functools.lru_cache(maxsize=None)
def tensordot(axes, t1: bool = False, t2: bool = False, precision=None):
    """Transposed operands fuse into the dot (XLA folds the transpose into
    dot_general dimension numbers — x.T @ x never materializes x.T)."""
    return jax.jit(
        lambda a, b: jnp.tensordot(
            _maybe_t(a, t1), _maybe_t(b, t2), axes=axes, precision=precision
        )
    )


@functools.lru_cache(maxsize=None)
def tensordot_same(axes, t1: bool = False, t2: bool = False, precision=None):
    """Both operands are the SAME buffer (e.g. the gram product x.T @ x).

    Passing one argument halves the program's argument footprint — a
    runtime that stages duplicate arguments separately would otherwise
    hold two copies at x.T@x scale.
    """

    def impl(a):
        return jnp.tensordot(
            _maybe_t(a, t1), _maybe_t(a, t2), axes=axes, precision=precision
        )

    return jax.jit(impl)


@functools.lru_cache(maxsize=None)
def matmul(t1: bool = False, t2: bool = False, precision=None):
    return jax.jit(
        lambda a, b: jnp.matmul(
            _maybe_t(a, t1), _maybe_t(b, t2), precision=precision
        )
    )


@functools.lru_cache(maxsize=None)
def transpose(perm):
    """Lazy in XLA: usually fuses into the consumer as a layout change.

    Parity: zero-copy metadata transpose (base.py:72-85) — XLA gives the
    same effect by fusing the transpose into downstream ops.
    """
    return jax.jit(lambda x: jnp.transpose(x, axes=perm))
