"""Terminal facade tranche: the last numpy callables, closing the module
surface at 0 stubs (coverage CLI).

The reference fills all of these with ``_not_implemented`` stubs
(``nums/numpy/__init__.py:30-40``); implementing them exceeds it.
Device-side where the op maps onto XLA (bitwise_count, piecewise, ix_,
apply_over_axes, bmat, from_dlpack, require); host round-trips only for
CPU-only domains (datetime/busday calendars, np.matrix, nditer, text and
binary file parsing) where no device kernel is meaningful.
"""


import numpy as np

import jax
import jax.numpy as jnp

from nums_tpu.core.application_manager import instance as _instance
from nums_tpu.core.array.blockarray import BlockArray
from nums_tpu.numpy.extra import _to_ba, _call, _wrapc, _jit_kw

__all__ = [
    "apply_over_axes", "asmatrix", "bitwise_count", "bmat",
    "busday_count", "busday_offset", "datetime_as_string",
    "datetime_data", "from_dlpack", "fromfile", "fromregex",
    "genfromtxt", "geterrcall", "is_busday", "isnat", "ix_",
    "nested_iters", "piecewise", "require", "savez_compressed",
    "seterrcall",
]


def _dehost(obj):
    """BlockArray -> host ndarray; anything else passes through."""
    return obj.get() if isinstance(obj, BlockArray) else obj


def _distribute(out):
    """Host ndarray -> sharded BlockArray when the dtype is device-legal
    (bool/int/float/complex); calendar/string/struct results stay host."""
    if isinstance(out, np.ndarray) and out.dtype.kind in "bifc":
        return _instance().array(out, block_shape=None)
    return out


# -- device-side ---------------------------------------------------------


def bitwise_count(x):
    """Per-element popcount on the VPU (one jitted XLA kernel)."""
    x = _to_ba(x)
    return _wrapc(x, _call(_jit_kw("bitwise_count"), x))


def from_dlpack(x):
    """Zero-copy DLPack import on the serial backend; mesh backends
    re-shard through the standard distribution path."""
    app = _instance()
    data = jnp.from_dlpack(x)
    if app.backend.mesh is None:
        return BlockArray.from_jax(data, backend=app.backend)
    return app.array(np.asarray(data), block_shape=None)


def require(a, dtype=None, requirements=None):
    """Memory-layout flags (C/F/ALIGNED/...) are XLA's concern on the device;
    equivalent to asarray with a dtype."""
    del requirements
    from nums_tpu.numpy import api as _api

    return _api.asarray(a, dtype=dtype)


def ix_(*args):
    """Open-mesh index vectors: each 1-D selector reshaped so that
    broadcasting forms the cross product (metadata-only on device)."""
    n = len(args)
    out = []
    for k, a in enumerate(args):
        if isinstance(a, BlockArray):
            ab = a
            if ab.dtype == bool:
                ab = _to_ba(np.flatnonzero(ab.get()))
        else:
            host = np.asarray(a)
            if host.size == 0 and host.dtype.kind == "f":
                host = host.astype(np.intp)
            if host.dtype.kind == "b":
                host = np.flatnonzero(host)
            ab = _to_ba(host)
        if ab.ndim != 1:
            raise ValueError("Cross index must be 1 dimensional")
        shape = [1] * n
        shape[k] = ab.shape[0]
        out.append(ab.reshape(tuple(shape)))
    return tuple(out)


def _piecewise_key(funclist):
    """Structural cache key for a funclist: inline lambdas are fresh
    OBJECTS every call but share one code object per source location, so
    keying on (code, defaults, closure cells, referenced-global VALUES)
    makes the idiomatic ``piecewise(x, conds, [lambda v: -v, ...])``
    loop hit the cache instead of compiling and permanently caching a
    new kernel per call — while a changed captured value (closure cell
    OR module global like ``lambda t: t*g``) misses and recompiles.
    Returns None (→ uncached path) when any piece isn't fully hashable.
    """
    key = []
    for f in funclist:
        if not callable(f):  # numpy allows scalar pieces
            key.append(("const", f))
            continue
        code = getattr(f, "__code__", None)
        if code is None:
            return None  # builtins/callables without code: don't cache
        try:
            cells = tuple(
                c.cell_contents for c in (f.__closure__ or ())
            )
        except ValueError:  # not-yet-bound cell
            return None
        fglobals = getattr(f, "__globals__", {})
        globs = tuple(
            (nm, fglobals[nm]) for nm in code.co_names if nm in fglobals
        )
        entry = (code, f.__defaults__, cells, globs)
        try:
            hash(entry)
        except TypeError:
            return None
        key.append(entry)
    return tuple(key)


_piecewise_cache = {}


def _piecewise_kernel(funclist):
    funclist = tuple(funclist)

    def k(x, *conds):
        return jnp.piecewise(x, list(conds), list(funclist))

    key = _piecewise_key(funclist)
    if key is None:
        return jax.jit(k)  # unhashable piece: correct but uncached
    kernel = _piecewise_cache.get(key)
    if kernel is None:
        if len(_piecewise_cache) >= 256:  # bounded (FIFO eviction)
            _piecewise_cache.pop(next(iter(_piecewise_cache)))
        kernel = _piecewise_cache[key] = jax.jit(k)
    return kernel


def piecewise(x, condlist, funclist, *args, **kw):
    """jnp.piecewise over the sharded array; the whole select tree is one
    fused XLA program (conditions slice-to-logical via the pad adapter)."""
    x = _to_ba(x)
    if not isinstance(condlist, (list, tuple)):
        condlist = [condlist]
    conds = [_to_ba(c) for c in condlist]
    if args or kw:
        # Extra per-function arguments: rare path, uncached kernel.
        def k(xd, *cds):
            return jnp.piecewise(xd, list(cds), list(funclist), *args, **kw)

        kernel = jax.jit(k)
    else:
        kernel = _piecewise_kernel(tuple(funclist))
    return _wrapc(x, _call(kernel, x, *conds))


def apply_over_axes(func, a, axes):
    """Apply ``func(a, axis)`` over each axis, re-expanding reduced axes
    (numpy semantics); composes with lazy batching since each step is a
    normal facade/BlockArray op."""
    from nums_tpu.numpy import api as _api

    a = _to_ba(a)
    if np.isscalar(axes):
        axes = (axes,)
    res = a
    for axis in axes:
        axis = int(axis)
        r = func(res, axis)
        r = _to_ba(r)
        if r.ndim == res.ndim:
            res = r
        elif r.ndim == res.ndim - 1:
            res = _api.expand_dims(r, axis)
        else:
            raise ValueError(
                "function is not returning an array of the correct shape"
            )
    return res


def bmat(obj, ldict=None, gdict=None):
    """Block matrix from nested blocks — the natural op for a blocked
    array library: rows concatenate on axis 1, then axis 0. Accepts the
    numpy string syntax ('A B; C D') resolved against ldict/gdict or the
    caller's frame. Returns a BlockArray (not np.matrix)."""
    from nums_tpu.numpy import api as _api

    if isinstance(obj, str):
        import sys

        frame = sys._getframe(1)
        gdict = frame.f_globals if gdict is None else gdict
        ldict = frame.f_locals if ldict is None else ldict
        rows = []
        for row in obj.split(";"):
            names = row.split()
            if not names:
                continue
            rows.append([ldict.get(n, gdict.get(n)) for n in names])
        obj = rows
    if isinstance(obj, (list, tuple)) and obj and isinstance(
        obj[0], (list, tuple)
    ):
        from nums_tpu.numpy.extra import atleast_2d

        row_arrays = [
            _api.concatenate([atleast_2d(_to_ba(b)) for b in row], axis=1)
            for row in obj
        ]
        return _api.concatenate(row_arrays, axis=0)
    from nums_tpu.numpy.extra import atleast_2d

    return atleast_2d(_to_ba(obj))


# -- host round-trips (CPU-only domains) ----------------------------------


def _host_passthrough(np_name, doc, wrap_out=False):
    fn = getattr(np, np_name)

    def wrapped(*args, **kwargs):
        args = [_dehost(a) for a in args]
        kwargs = {k: _dehost(v) for k, v in kwargs.items()}
        out = fn(*args, **kwargs)
        return _distribute(out) if wrap_out else out

    wrapped.__name__ = np_name
    wrapped.__doc__ = doc
    return wrapped


_CAL_DOC = (
    "Business-day/datetime calendars are a host-only domain (datetime64 "
    "has no device representation); numeric results are re-distributed."
)
busday_count = _host_passthrough("busday_count", _CAL_DOC, wrap_out=True)
busday_offset = _host_passthrough("busday_offset", _CAL_DOC)
is_busday = _host_passthrough("is_busday", _CAL_DOC)
datetime_as_string = _host_passthrough("datetime_as_string", _CAL_DOC)
datetime_data = _host_passthrough("datetime_data", _CAL_DOC)
isnat = _host_passthrough("isnat", _CAL_DOC, wrap_out=True)

geterrcall = np.geterrcall
seterrcall = np.seterrcall


def asmatrix(data, dtype=None):
    """np.matrix is a host-only legacy type; returns np.matrix."""
    return np.asmatrix(_dehost(data), dtype=dtype)


def nested_iters(op, axes, flags=None, op_flags=None, **kw):
    """nditer machinery is host-only; operands are fetched."""
    if isinstance(op, (list, tuple)):
        op = [_dehost(o) for o in op]
    else:
        op = _dehost(op)
    return np.nested_iters(
        op, axes, flags=flags, op_flags=op_flags, **kw
    )


def fromfile(file, dtype=float, count=-1, sep="", offset=0):
    out = np.fromfile(file, dtype=dtype, count=count, sep=sep, offset=offset)
    return _distribute(out)


def fromregex(file, regexp, dtype, encoding=None):
    out = np.fromregex(file, regexp, dtype, encoding=encoding)
    return _distribute(out)


def genfromtxt(fname, **kwargs):
    out = np.genfromtxt(fname, **kwargs)
    return _distribute(out)


def savez_compressed(file, *args, **kwds):
    args = [_dehost(a) for a in args]
    kwds = {k: _dehost(v) for k, v in kwds.items()}
    np.savez_compressed(file, *args, **kwds)
