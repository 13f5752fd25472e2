"""nums_tpu.numpy.linalg (parity: ``nums/numpy/linalg.py:20-23``).

The reference exposes reduced ``qr`` only; we add the rest of the
distributed linalg the application layer supports.
"""

from nums_tpu.core.application_manager import instance as _instance


def qr(a, mode="reduced"):
    if mode != "reduced":
        raise NotImplementedError("Only reduced QR is supported.")
    return _instance().qr(a)


def svd(a, full_matrices=False, compute_uv=True):
    if full_matrices:
        raise NotImplementedError("Only reduced SVD is supported.")
    u, s, vt = _instance().svd(a)
    if compute_uv:
        return u, s, vt
    return s


def inv(a):
    return _instance().inv(a)


def cholesky(a):
    return _instance().cholesky(a)


def lstsq(a, b):
    return _instance().lstsq(a, b)


def norm(a):
    return _instance().norm(a)


# ---------------------------------------------------------------------------
# Extended surface beyond the reference (jitted jnp.linalg kernels on the
# materialized array; all sharding-propagated under a mesh).
# ---------------------------------------------------------------------------

import functools as _functools

import jax as _jax
import jax.numpy as _jnp

from nums_tpu.core.array.blockarray import BlockArray as _BA


@_functools.lru_cache(maxsize=None)
def _jit1(fname):
    fn = getattr(_jnp.linalg, fname)
    return _jax.jit(lambda x: fn(x))


def _apply1(fname, a):
    out = _jit1(fname)(a.data)
    if isinstance(out, tuple):
        return tuple(
            _BA.from_jax(o, backend=a.backend) for o in out
        )
    return _BA.from_jax(out, backend=a.backend)


def det(a):
    return _apply1("det", a)


def slogdet(a):
    return _apply1("slogdet", a)


def eigh(a):
    return _apply1("eigh", a)


def eigvalsh(a):
    return _apply1("eigvalsh", a)


def pinv(a):
    return _apply1("pinv", a)


def matrix_rank(a):
    return _apply1("matrix_rank", a)


@_functools.lru_cache(maxsize=None)
def _solve_jit():
    return _jax.jit(lambda a, b: _jnp.linalg.solve(a, b))


def solve(a, b):
    out = _solve_jit()(a.data, b.data)
    return _BA.from_jax(out, backend=a.backend)


def multi_dot(arrays):
    out = arrays[0]
    for a in arrays[1:]:
        out = out @ a
    return out


def cond(a, p=None):
    if p is not None:
        raise NotImplementedError("Only the 2-norm condition number.")
    return _apply1("cond", a)


def svdvals(a):
    return svd(a, compute_uv=False)


def matrix_power(a, n):
    import functools as _ft

    @_ft.lru_cache(maxsize=None)
    def _jit(n):
        return _jax.jit(lambda x: _jnp.linalg.matrix_power(x, n))

    return _BA.from_jax(_jit(int(n))(a.data), backend=a.backend)


def diagonal(a):
    return _apply1("diagonal", a)


def matmul(a, b):
    return a @ b


def tensordot(a, b, axes=2):
    return a.tensordot(b, axes=axes)


def outer(a, b):
    from nums_tpu.numpy import extra as _extra

    return _extra.outer(a, b)


def trace(a):
    from nums_tpu.numpy import extra as _extra

    return _extra.trace(a)


def vector_norm(a):
    return norm(a)


def cross(x1, x2, axis=-1):
    from nums_tpu.numpy import extra as _extra

    return _extra.cross(x1, x2, axis=axis)


def vecdot(x1, x2, axis=-1):
    from nums_tpu.numpy import extra3 as _extra3

    return _extra3.vecdot(x1, x2, axis=axis)


def tensorinv(a, ind=2):
    import functools as _ft

    @_ft.lru_cache(maxsize=None)
    def _jit(ind):
        return _jax.jit(lambda x: _jnp.linalg.tensorinv(x, ind=ind))

    return _BA.from_jax(_jit(int(ind))(a.data), backend=a.backend)


def tensorsolve(a, b):
    @_functools.lru_cache(maxsize=None)
    def _jit():
        return _jax.jit(lambda x, y: _jnp.linalg.tensorsolve(x, y))

    return _BA.from_jax(_jit()(a.data, b.data), backend=a.backend)


@_functools.lru_cache(maxsize=None)
def _eig_kernel(shape, cdt_name, values_only):
    """Jitted general-eig: the LAPACK call rides ``jax.pure_callback``
    inside the program (XLA has no general-eig kernel on accelerators), and the
    all-eigenvalues-real probe computes in the same program. Jitting
    gives the callback outputs clean shardings (eager pure_callback
    emits a maximal-device sharding later jits can't consume)."""
    import numpy as _np

    cdt = _np.dtype(cdt_name)
    wsds = _jax.ShapeDtypeStruct(shape[:-1], cdt)

    if values_only:
        def cb(x):
            return _np.linalg.eigvals(_np.asarray(x)).astype(cdt)

        def f(x):
            w = _jax.pure_callback(cb, wsds, x)
            return w, _jnp.all(_jnp.imag(w) == 0)
    else:
        def cb(x):
            w, v = _np.linalg.eig(_np.asarray(x))
            return w.astype(cdt), v.astype(cdt)

        def f(x):
            w, v = _jax.pure_callback(
                cb, (wsds, _jax.ShapeDtypeStruct(shape, cdt)), x
            )
            ar = _jnp.all(_jnp.imag(w) == 0) & _jnp.all(_jnp.imag(v) == 0)
            return w, v, ar
    return _jax.jit(f)


def eig(a):
    """General (non-symmetric) eig. XLA has no general-eig kernel on
    accelerators, so the LAPACK call rides ``jax.pure_callback`` INSIDE the
    program: a lazy chain feeding it stays fused and the operand never
    surfaces as a Python-level host array. ONE boolean sync picks the
    numpy-parity output dtype (real iff the input is real and every
    eigenvalue is real, as ``np.linalg.eig`` does)."""
    import numpy as _np

    cdt = _np.result_type(a.dtype, _np.complex64)
    kern = _eig_kernel(tuple(a.shape), cdt.name, False)
    w, v, all_real = kern(a.data)
    if not _np.issubdtype(a.dtype, _np.complexfloating) and bool(all_real):
        w, v = _jnp.real(w), _jnp.real(v)
    return (
        _BA.from_jax(w, backend=a.backend),
        _BA.from_jax(v, backend=a.backend),
    )


def eigvals(a):
    """Eigenvalues only — same in-program pure_callback scheme as
    :func:`eig` (one boolean sync for the numpy-parity dtype)."""
    import numpy as _np

    cdt = _np.result_type(a.dtype, _np.complex64)
    kern = _eig_kernel(tuple(a.shape), cdt.name, True)
    w, all_real = kern(a.data)
    if not _np.issubdtype(a.dtype, _np.complexfloating) and bool(all_real):
        w = _jnp.real(w)
    return _BA.from_jax(w, backend=a.backend)


def matrix_norm(a, ord="fro"):  # noqa: A002
    if ord != "fro":
        raise NotImplementedError("Only the Frobenius norm.")
    from nums_tpu.core.application_manager import instance as _inst

    return _inst().sqrt((a * a).sum())


def matrix_transpose(x):
    return x.transpose()
