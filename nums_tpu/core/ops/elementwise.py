"""Elementwise op vocabulary (unary + binary), jit-cached per op name.

Replaces the reference's per-block ``map_uop``/``bop`` kernels
(``nums/core/systems/numpy_compute.py:184-238``): instead of one remote
NumPy call per block, each op is ONE jitted XLA program over the whole
(possibly sharded) array; XLA fuses chains of these into single kernels and
SPMD-partitions them across the mesh. The scipy.special fallback the
reference uses (numpy_compute.py:231-236) maps to ``jax.scipy.special``.
"""

import functools

import jax
import jax.numpy as jnp
import jax.scipy.special as jsp_special

from nums_tpu.core import settings

# Ops whose numpy name differs from the jnp attribute, or that need custom
# lambdas.
_SPECIAL_UFUNCS = {
    "abs": jnp.abs,
    "bitwise_not": jnp.bitwise_not,
    "invert": jnp.invert,
    "conj": jnp.conj,
    "xlogy": jsp_special.xlogy,
}


def resolve_ufunc(name: str):
    name = settings.np_ufunc_map.get(name, name)
    if name in _SPECIAL_UFUNCS:
        return _SPECIAL_UFUNCS[name]
    fn = getattr(jnp, name, None)
    if fn is None:
        fn = getattr(jsp_special, name, None)
    if fn is None:
        raise NotImplementedError(f"No device kernel for ufunc {name!r}")
    return fn


def maybe_t(x, transposed: bool):
    """Fold a lazy logical transpose into the consuming program.

    BlockArray transposes are metadata-only (parity with the reference's
    zero-copy ``Block.transpose()``, base.py:72-85); consumers splice the
    ``jnp.transpose`` here so XLA fuses it (e.g. into dot_general dimension
    numbers) instead of materializing a copy in HBM.
    """
    return jnp.transpose(x) if transposed else x


@functools.lru_cache(maxsize=None)
def uop(name: str, transposed: bool = False):
    """Jitted unary elementwise op."""
    fn = resolve_ufunc(name)
    return jax.jit(lambda x: fn(maybe_t(x, transposed)))


@functools.lru_cache(maxsize=None)
def bop(name: str, t1: bool = False, t2: bool = False):
    """Jitted binary elementwise op (with NumPy broadcasting)."""
    fn = resolve_ufunc(name)
    return jax.jit(lambda x1, x2: fn(maybe_t(x1, t1), maybe_t(x2, t2)))


@functools.lru_cache(maxsize=None)
def astype(dtype_name: str):
    return jax.jit(lambda x: x.astype(jnp.dtype(dtype_name)))


@functools.lru_cache(maxsize=None)
def const_bool(value: bool):
    """Shape-preserving bool constant (eq/ne vs incomparable operands)."""
    return jax.jit(lambda x: jnp.full(x.shape, value, dtype=jnp.bool_))


@functools.lru_cache(maxsize=None)
def materialize_t():
    return jax.jit(lambda x: jnp.transpose(x))


@jax.jit
def touch(x):
    """Identity; used with block_until_ready to force materialization.

    Parity: kernel ``touch`` (numpy_compute.py:88-89) /
    ``BlockArray.touch()`` (blockarray.py:117-126).
    """
    return x


@functools.partial(jax.jit, static_argnames=("rtol", "atol", "equal_nan"))
def allclose(a, b, rtol=1.0e-5, atol=1.0e-8, equal_nan=False):
    """Parity: kernel ``allclose`` (numpy_compute.py:261-263)."""
    return jnp.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


@functools.lru_cache(maxsize=None)
def allclose_kernel(rtol: float, atol: float, equal_nan: bool = False):
    """Stable (cached) allclose kernel for the pad/lazy adapter."""
    return jax.jit(
        lambda a, b: jnp.allclose(
            a, b, rtol=rtol, atol=atol, equal_nan=equal_nan
        )
    )
