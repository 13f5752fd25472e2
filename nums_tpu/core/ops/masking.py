"""Device-side boolean-mask resolution (capacity + slice idiom).

The reference computes per-block index arrays worker-side
(``nums/core/systems/numpy_compute.py:188-201``); round 1 instead fetched
the ENTIRE condition array to host (a GB-scale transfer on a
2^24-row mask). Here the only host sync is ONE
scalar (the true-count): index arrays are built on device with
``jnp.nonzero(size=capacity)`` and sliced to the exact count. Capacities
are rounded to powers of two so the jit cache sees O(log n) distinct
programs instead of one per count.

Pads of at-rest buffers are never read: kernels slice to the logical
shape first (garbage pads would otherwise count as True).
"""

import functools

import jax
import jax.numpy as jnp


def _logical(x, logical_shape, transposed):
    if tuple(x.shape) != tuple(logical_shape):
        x = x[tuple(slice(0, d) for d in logical_shape)]
    return jnp.transpose(x) if transposed else x


@functools.lru_cache(maxsize=None)
def count_nonzero(logical_shape: tuple, transposed: bool = False):
    return jax.jit(
        lambda x: jnp.count_nonzero(_logical(x, logical_shape, transposed))
    )


@functools.lru_cache(maxsize=None)
def nonzero_capped(logical_shape: tuple, cap: int, transposed: bool = False):
    """Index arrays of the True positions, padded to ``cap`` entries.

    Fill values index position 0 (valid everywhere) — callers slice to
    the exact count, so fills are never observed.
    """
    return jax.jit(
        lambda x: jnp.nonzero(
            _logical(x, logical_shape, transposed), size=cap, fill_value=0
        )
    )


def capacity_for(count: int) -> int:
    """Next power of two (>=1): bounds distinct compiled programs."""
    return 1 << max(0, (int(count) - 1)).bit_length() if count > 0 else 0


@functools.lru_cache(maxsize=None)
def unique_count(logical_shape: tuple, transposed: bool = False,
                 equal_nan: bool = True):
    """Number of distinct elements. ``equal_nan=True`` collapses NaNs to
    one (np.unique's default); False keeps each NaN distinct (the
    np.unique_* array-API family). Only valid for size > 0."""

    def impl(x):
        s = jnp.sort(_logical(x, logical_shape, transposed).ravel())
        neq = s[1:] != s[:-1]
        if equal_nan and jnp.issubdtype(s.dtype, jnp.inexact):
            neq = neq & ~(jnp.isnan(s[1:]) & jnp.isnan(s[:-1]))
        return jnp.sum(neq) + 1

    return jax.jit(impl)


@functools.lru_cache(maxsize=None)
def unique_capped(logical_shape: tuple, cap: int, transposed: bool,
                  want_index: bool, want_inverse: bool, want_counts: bool,
                  equal_nan: bool = True):
    """jnp.unique of the raveled logical array, padded to ``cap`` values.

    Callers slice values/index/counts to the exact count (pad slots are
    never observed); the inverse is full-size (static input shape) and
    reshaped back to the logical shape, matching np.unique on numpy>=2.
    """

    def impl(x):
        v = _logical(x, logical_shape, transposed).ravel()
        out = jnp.unique(
            v, size=cap, return_index=want_index,
            return_inverse=want_inverse, return_counts=want_counts,
            equal_nan=equal_nan,
        )
        if not (want_index or want_inverse or want_counts):
            return (out,)
        out = list(out)
        if want_inverse:
            pos = 1 + int(want_index)
            # The inverse maps USER-VISIBLE positions (after the lazy
            # transpose) — reshaping to the raw logical shape would
            # scramble it for transposed non-square inputs.
            view_shape = (
                tuple(reversed(logical_shape)) if transposed
                else logical_shape
            )
            out[pos] = out[pos].reshape(view_shape)
        return tuple(out)

    return jax.jit(impl)


def device_unique(mask_block_array, want_index=False, want_inverse=False,
                  want_counts=False, equal_nan=True):
    """np.unique resolved ON DEVICE: one scalar host sync (the distinct
    count), O(result) transfer. Returns (count, [values, index?,
    inverse?, counts?]) — values/index/counts exactly-sliced jax arrays,
    inverse shaped like the logical input.

    The analogue of `device_where` for the set-op family (the reference
    has no distributed unique at all)."""
    ba = mask_block_array
    raw = ba.raw
    logical = ba._raw_logical_shape()
    t = ba.is_transposed
    count = int(unique_count(logical, t, equal_nan)(raw))
    cap = capacity_for(count)
    outs = list(unique_capped(
        logical, cap, t, want_index, want_inverse, want_counts, equal_nan
    )(raw))
    if cap != count:
        inv_pos = 1 + int(want_index) if want_inverse else None
        outs = [
            o if i == inv_pos else o[:count] for i, o in enumerate(outs)
        ]
    return count, outs


def device_where(mask_block_array):
    """(count, index jax.Arrays): device-resolved np.where semantics.

    One scalar host sync for the count; index arrays stay on device and
    are already sliced to exact length.
    """
    raw = mask_block_array.raw
    logical = mask_block_array._raw_logical_shape()
    t = mask_block_array.is_transposed
    count = int(count_nonzero(logical, t)(raw))
    if count == 0:
        ndim = len(mask_block_array.shape)
        return 0, tuple(jnp.zeros((0,), jnp.int64) for _ in range(ndim))
    cap = capacity_for(count)
    idx = nonzero_capped(logical, cap, t)(raw)
    if cap != count:
        idx = tuple(i[:count] for i in idx)
    return count, tuple(idx)
