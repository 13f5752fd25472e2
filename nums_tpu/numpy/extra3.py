"""Fourth facade tranche: set operations, polynomial arithmetic,
partitioning, block assembly. Host-sync only for data-dependent shapes
(set ops, unique_*), metadata passthroughs for dtype predicates."""

import builtins
import functools

import numpy as np

import jax
import jax.numpy as jnp

from nums_tpu.core.application_manager import instance as _instance
from nums_tpu.numpy.extra import _to_ba, _wrap, _wrapc, _call, _jit_kw

__all__ = [
    "argpartition", "partition", "lexsort", "modf", "rot90", "rollaxis",
    "vecdot", "block", "choose", "delete", "insert", "array_equiv",
    "in1d", "intersect1d", "setdiff1d", "setxor1d", "union1d",
    "unique_all", "unique_counts", "unique_inverse", "unique_values",
    "trim_zeros", "sort_complex", "polyadd", "polysub", "polymul",
    "polydiv", "polyder", "polyint", "poly", "roots", "issubdtype",
    "isdtype", "iterable", "real_if_close",
]

issubdtype = np.issubdtype
isdtype = getattr(np, "isdtype", None) or np.issubdtype
iterable = np.iterable


def argpartition(a, kth, axis=-1):
    a = _to_ba(a)
    return _wrapc(a, _call(_jit_kw("argpartition", kth=kth, axis=axis), a))


def partition(a, kth, axis=-1):
    a = _to_ba(a)
    return _wrapc(a, _call(_jit_kw("partition", kth=kth, axis=axis), a))


@functools.lru_cache(maxsize=None)
def _k_lexsort(axis, n):
    del n
    return jax.jit(lambda *ks: jnp.lexsort(ks, axis=axis))


def lexsort(keys, axis=-1):
    bas = [_to_ba(k) for k in keys]
    return _wrapc(bas[0], _call(_k_lexsort(axis, len(bas)), *bas))


_k_modf = jax.jit(lambda v: jnp.modf(v))


def modf(x):
    x = _to_ba(x)
    (frac, whole), (f_l, w_l) = _call(_k_modf, x)
    return (
        _wrap(x, frac, x.block_shape, shape=f_l),
        _wrap(x, whole, x.block_shape, shape=w_l),
    )


def rot90(m, k=1, axes=(0, 1)):
    m = _to_ba(m)
    return _wrapc(m, _call(_jit_kw("rot90", k=k, axes=tuple(axes)), m))


def rollaxis(a, axis, start=0):
    a = _to_ba(a)
    return _wrapc(a, _call(_jit_kw("rollaxis", axis=axis, start=start), a))


@functools.lru_cache(maxsize=None)
def _k_vecdot(axis):
    return jax.jit(lambda a, b: jnp.vecdot(a, b, axis=axis))


def vecdot(x1, x2, axis=-1):
    x1, x2 = _to_ba(x1), _to_ba(x2)
    return _wrapc(x1, _call(_k_vecdot(axis), x1, x2))


def block(arrays):
    def conv(obj):
        if isinstance(obj, list):
            return [conv(o) for o in obj]
        return _to_ba(obj).data

    datas = conv(arrays)
    first = datas
    while isinstance(first, list):
        first = first[0]
    out = jnp.block(datas)
    from nums_tpu.core.array.blockarray import BlockArray

    return BlockArray.from_jax(out, backend=_instance().backend)


_k_choose = jax.jit(lambda idx, *cs: jnp.choose(idx, list(cs), mode="clip"))


def choose(a, choices):
    a = _to_ba(a)
    ch = [_to_ba(c) for c in choices]
    return _wrapc(a, _call(_k_choose, a, *ch))


def delete(arr, obj, axis=None):
    arr = _to_ba(arr)
    if isinstance(obj, (int, np.integer, slice)):
        return _wrapc(arr, _call(_jit_kw("delete", obj=obj, axis=axis), arr))
    # array-valued indices: data-dependent -> host
    out = np.delete(arr.get(), np.asarray(_to_ba(obj).get(), dtype=int),
                    axis=axis)
    return _instance().array(out, block_shape=None)


@functools.lru_cache(maxsize=None)
def _k_insert(obj_key, axis):
    obj = slice(*obj_key[1]) if obj_key[0] == "s" else obj_key[1]
    return jax.jit(lambda x, v: jnp.insert(x, obj, v, axis=axis))


def insert(arr, obj, values, axis=None):
    """Device-side for scalar/slice positions (static output shape);
    array-valued positions are data-dependent -> host."""
    arr = _to_ba(arr)
    if isinstance(obj, (int, np.integer)):
        key = ("i", int(obj))
    elif isinstance(obj, slice):
        key = ("s", (obj.start, obj.stop, obj.step))
    else:
        out = np.insert(
            arr.get(), obj,
            values.get() if hasattr(values, "get") else values, axis=axis,
        )
        return _instance().array(out, block_shape=None)
    return _wrapc(arr, _call(_k_insert(key, axis), arr, _to_ba(values)))


_k_array_equiv = jax.jit(lambda x, y: jnp.all(x == y))


def array_equiv(a1, a2):
    a1, a2 = _to_ba(a1), _to_ba(a2)
    try:
        np.broadcast_shapes(a1.shape, a2.shape)
    except ValueError:
        return _instance().scalar(False)

    return _wrapc(a1, _call(_k_array_equiv, a1, a2))


# -- set operations (device-resolved via the capacity idiom: one scalar
# -- sync each, values never round-trip the host — see ops/masking) ------


def in1d(ar1, ar2):
    from nums_tpu.numpy.extra2 import isin
    from nums_tpu.numpy.extra import ravel

    return isin(ravel(_to_ba(ar1)), _to_ba(ar2))


def _device_unique_1d(ba, equal_nan=True):
    """Sorted distinct values of a BlockArray as a 1-D BlockArray
    (device-resolved; empty inputs short-circuit on host)."""
    from nums_tpu.core.array.blockarray import BlockArray
    from nums_tpu.core.ops import masking

    ba = _to_ba(ba)
    if ba.size == 0:
        out = np.unique(ba.get())
        return _instance().array(out, block_shape=out.shape)
    _, (vals,) = masking.device_unique(ba, equal_nan=equal_nan)
    return BlockArray.from_jax(vals, block_shape=tuple(vals.shape),
                               backend=ba.backend)


def _compress_by(ba, mask_ba):
    """ba[mask] via the device-where capacity idiom (one scalar sync)."""
    from nums_tpu.numpy.extra import _mask_indices_1d

    return ba[_mask_indices_1d(mask_ba)]


def intersect1d(ar1, ar2):
    from nums_tpu.numpy.extra2 import isin

    ua, ub = _device_unique_1d(ar1), _device_unique_1d(ar2)
    if ua.size == 0 or ub.size == 0:
        return ua if ua.size == 0 else ub
    return _compress_by(ua, isin(ua, ub))


def setdiff1d(ar1, ar2):
    from nums_tpu.numpy.extra2 import isin

    ua = _device_unique_1d(ar1)
    ub = _to_ba(ar2)
    if ua.size == 0 or ub.size == 0:
        return ua
    return _compress_by(ua, ~isin(ua, ub))


def setxor1d(ar1, ar2):
    from nums_tpu.numpy.extra import sort
    from nums_tpu.numpy.extra import append

    da, db = setdiff1d(ar1, ar2), setdiff1d(ar2, ar1)
    if da.size == 0:
        return db
    if db.size == 0:
        return da
    return sort(append(da, db))


def union1d(ar1, ar2):
    from nums_tpu.numpy.extra import append, ravel

    a, b = _to_ba(ar1), _to_ba(ar2)
    if a.size == 0:
        return _device_unique_1d(b)
    if b.size == 0:
        return _device_unique_1d(a)
    return _device_unique_1d(append(ravel(a), ravel(b)))


def _unique_result(x, want_index=False, want_inverse=False,
                   want_counts=False, np_probe=np.unique_counts):
    """Shared device path for the np.unique_* namedtuple family."""
    from nums_tpu.core.array.blockarray import BlockArray
    from nums_tpu.core.ops import masking

    x = _to_ba(x)
    result_t = type(np_probe(np.zeros(1)))
    if x.size == 0:
        outs = np_probe(np.asarray(x.get()))
        app = _instance()
        return result_t(*[
            app.array(np.asarray(o), block_shape=np.asarray(o).shape)
            for o in outs
        ])
    # The np.unique_* array-API family does NOT collapse NaNs
    # (equal_nan=False), unlike np.unique's default.
    _, outs = masking.device_unique(
        x, want_index=want_index, want_inverse=want_inverse,
        want_counts=want_counts, equal_nan=False,
    )
    return result_t(*[
        BlockArray.from_jax(o, block_shape=tuple(o.shape),
                            backend=x.backend)
        for o in outs
    ])


def unique_values(x):
    return _device_unique_1d(x, equal_nan=False)


def unique_counts(x):
    return _unique_result(
        x, want_counts=True,
        np_probe=np.unique_counts,
    )


def unique_inverse(x):
    return _unique_result(
        x, want_inverse=True,
        np_probe=np.unique_inverse,
    )


def unique_all(x):
    return _unique_result(
        x, want_index=True, want_inverse=True, want_counts=True,
        np_probe=np.unique_all,
    )


@functools.lru_cache(maxsize=None)
def _k_trim_bounds(logical_shape, transposed):
    """(first nonzero index, last nonzero index + 1) in one program —
    a single 2-scalar sync sizes the trim slice."""

    def impl(x):
        if transposed:
            x = jnp.transpose(x)
        v = x[tuple(slice(0, d) for d in logical_shape)]
        nz = v != 0
        n = v.shape[0]
        idx = jnp.arange(n)
        first = jnp.min(jnp.where(nz, idx, n))
        last = jnp.max(jnp.where(nz, idx + 1, 0))
        return jnp.stack([first, last])

    return jax.jit(impl)


def trim_zeros(filt, trim="fb"):
    """Device-resolved (one 2-scalar sync for the trim bounds)."""
    filt = _to_ba(filt)
    if filt.size == 0:
        out = np.trim_zeros(np.asarray(filt.get()), trim)
        return _instance().array(out, block_shape=out.shape)
    bounds = np.asarray(
        _k_trim_bounds(filt._raw_logical_shape(), filt.is_transposed)(
            filt.raw
        )
    )
    first, last = int(bounds[0]), int(bounds[1])
    trim = trim.lower()
    start = first if "f" in trim else 0
    stop = last if "b" in trim else filt.shape[0]
    return filt[start:builtins.max(start, stop)]


def sort_complex(a):
    """Device-side (jnp.sort_complex; static output shape)."""
    a = _to_ba(a)
    return _wrapc(a, _call(_jit_kw("sort_complex"), a))


# -- polynomials ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _k_poly_bop(fname):
    fn = getattr(jnp, fname)
    return jax.jit(lambda x, y: fn(x, y))


def _poly_bop(fname):
    def fn(a1, a2):
        a1, a2 = _to_ba(a1), _to_ba(a2)
        return _wrapc(a1, _call(_k_poly_bop(fname), a1, a2))

    fn.__name__ = fname
    return fn


polyadd = _poly_bop("polyadd")
polysub = _poly_bop("polysub")
polymul = _poly_bop("polymul")


_k_polydiv = jax.jit(lambda x, y: jnp.polydiv(x, y))


def polydiv(u, v):
    u, v = _to_ba(u), _to_ba(v)
    (q, r), (q_l, r_l) = _call(_k_polydiv, u, v)
    return _wrap(u, q, shape=q_l), _wrap(u, r, shape=r_l)


def polyder(p, m=1):
    p = _to_ba(p)
    return _wrapc(p, _call(_jit_kw("polyder", m=m), p))


def polyint(p, m=1):
    p = _to_ba(p)
    return _wrapc(p, _call(_jit_kw("polyint", m=m), p))


_k_conj_paired = jax.jit(
    lambda r: jnp.all(
        jnp.sort_complex(r) == jnp.sort_complex(jnp.conj(r))
    )
)


def poly(seq_of_zeros):
    """Device-side (jnp.poly: convolution of root factors, static
    shapes). Matches np.poly's realization rule: complex roots that
    come in conjugate pairs yield REAL coefficients (one boolean sync
    decides the data-dependent output dtype). 2-D square inputs take
    eigenvalues first — that general eig is host-only, so the 2-D form
    stays a fallback."""
    from nums_tpu.numpy.extra import real

    sz = _to_ba(seq_of_zeros)
    if sz.ndim == 2:
        out = np.poly(np.asarray(sz.get()))
        return _instance().array(out, block_shape=out.shape)
    coeffs = _wrapc(sz, _call(_jit_kw("poly"), sz))
    if (
        np.issubdtype(sz.dtype, np.complexfloating)
        and sz.size
        and bool(_k_conj_paired(sz.data))
    ):
        return real(coeffs)
    return coeffs


@functools.lru_cache(maxsize=None)
def _roots_kernel(cap, cdt_name):
    """Jitted ``np.roots`` riding ``jax.pure_callback`` (general eig has
    no XLA kernel on accelerators). Returns (capacity-padded roots, count,
    all-real flag); jitting gives the callback outputs clean shardings."""
    cdt = np.dtype(cdt_name)

    def cb(x):
        r = np.roots(np.asarray(x))
        out = np.zeros((cap,), cdt)
        out[: r.size] = r.astype(cdt)
        return out, np.int32(r.size)

    def f(x):
        data, cnt = jax.pure_callback(
            cb,
            (jax.ShapeDtypeStruct((cap,), cdt),
             jax.ShapeDtypeStruct((), np.int32)),
            x,
        )
        return data, cnt, jnp.all(jnp.imag(data) == 0)

    return jax.jit(f)


def roots(p):
    """Polynomial roots with the general eig riding ``jax.pure_callback``
    inside the program (XLA has no general-eig kernel on accelerators): the
    coefficients stay in the XLA program; ONE scalar sync (the root
    count, which depends on leading zeros) picks the logical shape —
    the capacity+slice idiom (ops/masking.py) — plus one boolean sync
    for the numpy-parity dtype (real iff every root is real)."""
    ba = _to_ba(p)
    cap = max(int(ba.size) - 1, 0)
    cdt = np.result_type(ba.dtype, np.complex64)
    data, cnt, all_real = _roots_kernel(cap, cdt.name)(ba.data)
    out = data[: int(cnt)]
    # numpy parity: complex coefficient arrays KEEP a complex result
    # even when every root has zero imaginary part (np.roots([1+0j,-3+0j,
    # 2+0j]) is complex128); the real downcast applies to real inputs
    # only — the same guard eig/eigvals use (numpy/linalg.py).
    if bool(all_real) and not np.issubdtype(ba.dtype, np.complexfloating):
        out = jnp.real(out)
    from nums_tpu.core.array.blockarray import BlockArray

    return BlockArray.from_jax(out, backend=ba.backend)


_k_imag_close = jax.jit(
    lambda x, tol: jnp.all(jnp.abs(jnp.imag(x)) < tol)
)


def real_if_close(a, tol=100):
    """Device-resolved: ONE boolean sync decides the output dtype (the
    dtype is inherently data-dependent); the real-part extraction runs
    on device."""
    from nums_tpu.numpy.extra import real

    a = _to_ba(a)
    if not np.issubdtype(a.dtype, np.complexfloating):
        return a
    if tol > 1:
        tol = float(tol) * np.finfo(np.dtype(a.dtype).char.lower()).eps
    if bool(_k_imag_close(a.data, tol)):
        return real(a)
    return a