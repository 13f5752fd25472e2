"""Reduction op vocabulary.

Replaces the reference's two-stage reductions — per-block ``reduce_axis``
kernels then a pairwise tree of ``bop`` adds/fmin/fmax between blocks
(``nums/core/array/blockarray.py:337-408``, numpy_compute.py:181-186,
210-211) — with single jitted whole-array reductions. Under a mesh, XLA
lowers the cross-shard stage to all-reduce trees, which is exactly the
log-depth combine the reference lacked (its k-chain was sequential).
"""

import functools

import jax
import jax.numpy as jnp

_DTYPE_AWARE = {"sum", "prod", "mean", "nansum", "nanprod", "nanmean"}


def _maybe_t(x, transposed):
    return jnp.transpose(x) if transposed else x


@functools.lru_cache(maxsize=None)
def reduce(op_name: str, axis, keepdims: bool, dtype_name,
           transposed: bool = False):
    fn = getattr(jnp, op_name)

    if dtype_name is not None and op_name in _DTYPE_AWARE:
        dtype = jnp.dtype(dtype_name)

        def impl(x):
            return fn(_maybe_t(x, transposed), axis=axis, keepdims=keepdims,
                      dtype=dtype)

    elif dtype_name is not None:
        dtype = jnp.dtype(dtype_name)

        def impl(x):
            return fn(
                _maybe_t(x, transposed), axis=axis, keepdims=keepdims
            ).astype(dtype)

    else:

        def impl(x):
            return fn(_maybe_t(x, transposed), axis=axis, keepdims=keepdims)

    return jax.jit(impl)


@functools.lru_cache(maxsize=None)
def arg_op(op_name: str, axis, transposed: bool = False):
    """Parity: streaming ``arg_op`` kernel (numpy_compute.py:269-283).

    The reference scans blocks sequentially carrying (argoptima, optima);
    here a single jitted argmin/argmax compiles to a parallel tree.
    """
    assert op_name in ("argmin", "argmax"), op_name
    fn = getattr(jnp, op_name)
    return jax.jit(lambda x: fn(_maybe_t(x, transposed), axis=axis))


@functools.lru_cache(maxsize=None)
def var(axis, ddof: int, keepdims: bool, dtype_name, transposed: bool = False):
    dtype = jnp.dtype(dtype_name) if dtype_name is not None else None
    return jax.jit(
        lambda x: jnp.var(_maybe_t(x, transposed), axis=axis, ddof=ddof,
                          keepdims=keepdims, dtype=dtype)
    )


@functools.lru_cache(maxsize=None)
def std(axis, ddof: int, keepdims: bool, dtype_name, transposed: bool = False):
    dtype = jnp.dtype(dtype_name) if dtype_name is not None else None
    return jax.jit(
        lambda x: jnp.std(_maybe_t(x, transposed), axis=axis, ddof=ddof,
                          keepdims=keepdims, dtype=dtype)
    )
