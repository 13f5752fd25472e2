"""Shape-manipulation kernels: reshape / expand / squeeze / where.

The reference implements reshape as three driver-side strategies over block
copies (``nums/core/array/blockarray.py:702-855``: factor-of-1, re-block via
setitem, arbitrary index-translation). Here all three collapse to XLA
``reshape`` — a layout change on one device and an automatic resharding
(all-to-all) under a mesh. Re-blocking without a logical reshape is a pure
sharding change (see ``BlockArray.reshape``).
"""

import functools

import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=None)
def reshape(shape: tuple):
    return jax.jit(lambda x: jnp.reshape(x, shape))


@functools.lru_cache(maxsize=None)
def expand_dims(axis):
    return jax.jit(lambda x: jnp.expand_dims(x, axis))


@jax.jit
def squeeze(x):
    return jnp.squeeze(x)


@jax.jit
def where3(condition, x, y):
    return jnp.where(condition, x, y)


@functools.lru_cache(maxsize=None)
def slice_to(logical_shape: tuple):
    """Strip at-rest padding: physical buffer -> logical-shape array."""
    idx = tuple(slice(0, d) for d in logical_shape)
    return jax.jit(lambda x: x[idx])


@functools.lru_cache(maxsize=None)
def slice_t(raw_logical_shape: tuple):
    """Strip padding then materialize a lazy transpose, in one program."""
    idx = tuple(slice(0, d) for d in raw_logical_shape)
    return jax.jit(lambda x: jnp.transpose(x[idx]))


@functools.lru_cache(maxsize=None)
def broadcast_to(shape: tuple):
    return jax.jit(lambda x: jnp.broadcast_to(x, shape))


@functools.lru_cache(maxsize=None)
def concatenate(axis: int, n: int):
    del n
    return jax.jit(lambda *arrs: jnp.concatenate(arrs, axis=axis))
