"""Pad-and-mask execution adapter for ragged sharding.

jax requires even divisibility for explicit shardings, so at rest every
mesh-sharded axis is rounded up to the mesh multiple
(``MeshBackend.physical_shape``). The pad region is NEVER READ: this
module fuses "slice inputs back to their logical shapes → kernel → pad
outputs to the at-rest rule" into one jitted program, so XLA folds the
slice/pad into the op and the intermediate (uneven) values never hit HBM
unpartitioned. This replaces the reference's first-class ragged grids
(``nums/core/storage/storage.py:36-52``) under uniform shards — no
per-op-class masking rules or logical-count bookkeeping are needed
because reductions/contractions only ever see logical data.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp

from nums_tpu.core import lazy, settings


def _slice_to(x, logical_shape):
    if tuple(x.shape) == tuple(logical_shape):
        return x
    return x[tuple(slice(0, d) for d in logical_shape)]


def _pad_out(out, backend):
    shape = tuple(out.shape)
    pshape = backend.physical_shape(shape)
    if pshape == shape:
        return out
    out = jnp.pad(out, [(0, p - s) for p, s in zip(pshape, shape)])
    return jax.lax.with_sharding_constraint(
        out, backend.sharding_for_shape(pshape)
    )


@functools.lru_cache(maxsize=None)
def _fused(kernel, logical_shapes, transposes, backend):
    """jit(pad_out ∘ kernel ∘ (transpose? ∘ slice_to_logical per arg))."""

    def run(*args):
        sliced = []
        for a, ls, t in zip(args, logical_shapes, transposes):
            if ls is not None:
                a = _slice_to(a, ls)
                if t:
                    a = jnp.transpose(a)
            sliced.append(a)
        out = kernel(*sliced)
        if isinstance(out, tuple):
            return tuple(_pad_out(o, backend) for o in out)
        return _pad_out(out, backend)

    return jax.jit(run)


_eval_cache = {}


def _logical_out_shapes(kernel, args, logical_shapes, transposes):
    """Shapes the kernel produces on LOGICAL inputs (static; memoized)."""
    key_parts = []
    avals = []
    for a, ls, t in zip(args, logical_shapes, transposes):
        if ls is None:
            if hasattr(a, "dtype") and hasattr(a, "shape"):
                # Array passed through unsliced (incl. deferred LazyOut).
                avals.append(jax.ShapeDtypeStruct(tuple(a.shape), a.dtype))
                key_parts.append((tuple(a.shape), np.dtype(a.dtype).name))
            else:
                # Scalar operand: shape () with its weak dtype.
                avals.append(a)
                key_parts.append(type(a).__name__)
        else:
            shape = tuple(reversed(ls)) if t else tuple(ls)
            dt = a.dtype
            avals.append(jax.ShapeDtypeStruct(shape, dt))
            key_parts.append((shape, np.dtype(dt).name))
    key = (kernel, tuple(key_parts))
    try:
        return _eval_cache[key]
    except (KeyError, TypeError):
        pass
    out = jax.eval_shape(kernel, *avals)
    if isinstance(out, (tuple, list)):
        shapes = tuple(tuple(o.shape) for o in out)
    else:
        shapes = tuple(out.shape)
    try:
        _eval_cache[key] = shapes
    except TypeError:  # unhashable operand type; skip memoization
        pass
    return shapes


def call(kernel, args, logical_shapes, backend, transposes=None):
    """Run ``kernel`` on physical buffers with pad-and-mask fused in.

    Args:
      kernel: a stable (cached) jitted callable on LOGICAL arrays.
      args: physical at-rest buffers (or python scalars).
      logical_shapes: per-arg logical RAW shape (None = pass through
        unsliced: scalars / already-logical operands).
      backend: the owning backend; mesh backends pad outputs to their
        at-rest rule.
      transposes: per-arg bool — transpose AFTER slicing (fuses a lazy
        BlockArray transpose into the same program).

    Returns (out, logical_out_shape(s)): ``out`` is padded at rest;
    callers build grids from the returned logical shape(s), never from
    ``out.shape``.
    """
    n = len(args)
    logical_shapes = tuple(
        tuple(ls) if ls is not None else None for ls in logical_shapes
    )
    transposes = tuple(transposes) if transposes else (False,) * n
    no_at_rest_padding = (
        backend.mesh is None or not settings.pad_shard
    )
    if no_at_rest_padding:
        # No padding can exist at rest: buffers are logical already;
        # only lazy transposes need folding in.
        if any(transposes):
            out = lazy.apply(
                _fused(kernel, logical_shapes, transposes, backend), *args
            )
        else:
            out = lazy.apply(kernel, *args)
        if isinstance(out, tuple):
            return out, tuple(tuple(o.shape) for o in out)
        return out, tuple(out.shape)
    lshapes = _logical_out_shapes(kernel, args, logical_shapes, transposes)
    out = lazy.apply(
        _fused(kernel, logical_shapes, transposes, backend), *args
    )
    return out, lshapes


def repad(data, pshape: tuple, backend):
    """Lazy-aware eager repad to the at-rest padded shape."""
    return lazy.apply(pad_to(tuple(pshape), backend), data)


@functools.lru_cache(maxsize=None)
def pad_to(pshape: tuple, backend):
    """Eager repad: logical array -> at-rest padded + sharded buffer."""

    def run(x):
        x = jnp.pad(
            x, [(0, p - s) for p, s in zip(pshape, x.shape)]
        )
        return jax.lax.with_sharding_constraint(
            x, backend.sharding_for_shape(pshape)
        )

    return jax.jit(run)
