"""BlockArray: a grid-partitioned distributed array on a device mesh.

Parity target: ``nums/core/array/base.py:27-377`` +
``nums/core/array/blockarray.py:29-699`` (semantics only — fresh JAX-native
design). The reference materializes each block as a separate remote object
and drives per-block tasks from Python. Here a BlockArray is ONE
``jax.Array`` (sharded over the backend's mesh per its grid) plus
``ArrayGrid`` metadata; every op is a whole-array jitted XLA program, so
"scheduling" is XLA SPMD partitioning and "futures" are jax async dispatch
(``touch`` == ``block_until_ready``, ``get`` == ``device_get`` — parity with
blockarray.py:117-126 / base.py:348-360).
"""

import numpy as np

import jax
import jax.numpy as jnp

from nums_tpu.core.grid import ArrayGrid
from nums_tpu.core.array import utils as array_utils
from nums_tpu.core.ops import elementwise, linear, padded, reductions, shape_ops
from nums_tpu.core import lazy, settings, trace


def _normalize_shape(shape_args):
    if len(shape_args) == 1 and isinstance(shape_args[0], (tuple, list)):
        return tuple(int(s) for s in shape_args[0])
    return tuple(int(s) for s in shape_args)


def _norm_axis(axis):
    """Hashable axis spec for the lru-cached reduction kernels."""
    if axis is None or isinstance(axis, int):
        return axis
    return tuple(int(a) for a in axis)


def compute_shape(size: int, shape) -> tuple:
    """Resolve a reshape spec with at most one -1 (parity: blockarray.py:704-728)."""
    shape = tuple(shape)
    unknown = [i for i, s in enumerate(shape) if s == -1]
    if not unknown:
        if int(np.prod(shape)) != size:
            raise ValueError(f"cannot reshape array of size {size} into {shape}")
        return shape
    if len(unknown) > 1:
        raise ValueError("can only specify one unknown dimension")
    known = int(np.prod([s for s in shape if s != -1]))
    if known == 0 or size % known != 0:
        raise ValueError(f"cannot reshape array of size {size} into {shape}")
    inferred = size // known
    return tuple(inferred if s == -1 else s for s in shape)


class Block:
    """Lightweight per-block view (parity: ``Block``, base.py:27-246).

    In the reference a Block owns a remote object id; here it is a metadata
    window into the parent's single jax.Array. Exists for block-aware code
    paths (I/O, per-block minibatching, tests of grid integrity).
    """

    def __init__(self, parent, grid_entry):
        self._parent = parent
        self.grid_entry = tuple(grid_entry)
        self.grid_shape = parent.grid.grid_shape
        self.rect = parent.grid.get_slice_tuples(self.grid_entry)
        self.shape = parent.grid.get_block_shape(self.grid_entry)
        self.dtype = parent.dtype

    def get(self) -> np.ndarray:
        parent = self._parent
        sl = parent.grid.get_slice(self.grid_entry)
        if parent.is_transposed:
            # Slice the RAW buffer (reversed coords) and transpose the
            # small block on host — never materializes the full transpose.
            raw_block = parent.backend.get(parent.raw[tuple(reversed(sl))])
            return np.asarray(raw_block).transpose()
        # Block rects lie within the logical extent, so slicing the raw
        # (possibly padded) buffer directly is always valid and avoids
        # materializing the unpadded array. backend.get handles the
        # multi-controller case (collective gather of remote shards).
        return np.asarray(parent.backend.get(parent.raw[sl]))


class BlockArray:
    # Defer all numpy-operator dispatch to our reflected operators.
    __array_ufunc__ = None
    __array_priority__ = 100.0

    def __init__(self, data, grid: ArrayGrid, backend, transposed=False):
        # ``transposed`` marks a LAZY logical transpose: ``grid`` describes
        # the logical (transposed) shape while ``data`` holds the original
        # buffer. Consumers fuse the transpose into their jitted programs
        # (parity with the reference's zero-copy metadata transpose,
        # base.py:72-85) — it is never materialized in HBM unless an op
        # needs the layout (indexing, reshape, I/O).
        raw_logical = (
            tuple(reversed(grid.shape)) if transposed else tuple(grid.shape)
        )
        raw_shape = tuple(data.shape)
        if raw_shape == raw_logical:
            # Logical-shaped buffer: re-pad to the backend's at-rest rule
            # (pad-and-mask: mesh-indivisible axes round up to the mesh
            # multiple; pads are never read).
            hint = (
                tuple(reversed(grid.grid_shape)) if transposed
                else grid.grid_shape
            )
            pshape = backend.physical_shape(raw_logical, hint)
            if pshape != raw_shape:
                data = padded.repad(data, pshape, backend)
        else:
            # Already-padded buffer (from a fused kernel / device_put):
            # must cover the logical extent on every axis.
            assert len(raw_shape) == len(raw_logical) and all(
                p >= s for p, s in zip(raw_shape, raw_logical)
            ), (data.shape, grid.shape, transposed)
        if data.dtype.name != grid.dtype:
            # The device may have coerced the requested dtype (e.g. x64
            # auto-off on an accelerator downcasts float64→float32). Metadata must
            # report the ACTUAL on-device dtype, or a.dtype, checkpoints
            # and derived ops disagree with a.get().dtype.
            grid = ArrayGrid(grid.shape, grid.block_shape, data.dtype.name)
        self._data = data
        self._transposed = transposed
        self.grid = grid
        self.backend = backend

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    @classmethod
    def from_np(cls, arr: np.ndarray, block_shape=None, copy=False, backend=None):
        arr = np.asarray(arr)
        if copy:
            arr = np.copy(arr)
        block_shape = tuple(block_shape) if block_shape is not None else arr.shape
        grid = ArrayGrid(arr.shape, block_shape, arr.dtype.name)
        data = backend.device_put(arr, grid)
        return cls(data, grid, backend)

    @classmethod
    def from_scalar(cls, value, backend):
        if isinstance(value, (bool, int, float, complex, np.generic)):
            arr = np.array(value)
        else:
            arr = np.asarray(value)
            assert arr.ndim == 0
        return cls.from_np(arr, block_shape=(), backend=backend)

    @classmethod
    def from_jax(cls, data, block_shape=None, backend=None):
        block_shape = (
            tuple(block_shape) if block_shape is not None else tuple(data.shape)
        )
        grid = ArrayGrid(tuple(data.shape), block_shape, data.dtype.name)
        return cls(data, grid, backend)

    def _new(self, data, block_shape=None, shape=None):
        """Wrap a derived jax.Array, deriving block metadata from self.

        ``shape`` is the LOGICAL shape; required when ``data`` came from a
        pad-and-mask fused kernel (its buffer shape may exceed logical).
        """
        shape = tuple(shape) if shape is not None else tuple(data.shape)
        if block_shape is None:
            block_shape = array_utils.default_block_shape_for(
                shape, self.block_shape
            )
        grid = ArrayGrid(shape, block_shape, data.dtype.name)
        return BlockArray(data, grid, self.backend)

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------

    def _raw_logical_shape(self):
        """Logical extent of the raw buffer (reversed when lazily transposed)."""
        if self._transposed:
            return tuple(reversed(self.grid.shape))
        return tuple(self.grid.shape)

    @property
    def is_padded(self):
        return tuple(self._data.shape) != self._raw_logical_shape()

    @property
    def data(self):
        """Materialized (logical-layout, logical-shape) jax.Array.

        On a padded at-rest buffer this returns a fresh sliced array and
        does NOT cache it (caching would replace the sharded padded buffer
        with an unshardable uneven one). Hot paths avoid this property and
        fuse the slice into their kernels via ops.padded.
        """
        raw_logical = self._raw_logical_shape()
        raw = self.raw  # sync point: forces any deferred expression
        if not self._transposed:
            if tuple(raw.shape) == raw_logical:
                return raw
            return shape_ops.slice_to(raw_logical)(raw)
        if tuple(raw.shape) == raw_logical:
            self._data = elementwise.materialize_t()(raw)
            self._transposed = False
            return self._data
        return shape_ops.slice_t(raw_logical)(raw)

    @property
    def raw(self):
        """Underlying buffer, possibly transposed-layout and/or padded.

        SYNC POINT for lazy batching: forces any deferred expression
        (compiling the whole chain as one program)."""
        d = self._data
        if isinstance(d, lazy.LazyOut):
            self._data = d.force()
        if settings.debug_sharding:
            self.check_sharding()
        return self._data

    def expected_sharding(self):
        """The sharding the grid metadata implies for the raw buffer
        (None when the backend doesn't shard or the buffer layout makes
        the rule inapplicable)."""
        backend = self.backend
        if backend.mesh is None:
            return None
        hint = (
            tuple(reversed(self.grid.grid_shape)) if self._transposed
            else self.grid.grid_shape
        )
        raw_logical = self._raw_logical_shape()
        pshape = backend.physical_shape(raw_logical, hint)
        if tuple(self._data.shape) != pshape:
            return None  # differently-padded buffer: rule inapplicable
        return backend.sharding_for_shape(pshape, hint)

    def check_sharding(self):
        """Debug invariant (VERDICT weak #7): warn when the materialized
        buffer is replicated although the grid implies a sharded layout
        — a silent N×-memory / 1/N-throughput outcome."""
        expected = self.expected_sharding()
        d = self._data
        if expected is None or isinstance(d, lazy.LazyOut):
            return True
        actual = getattr(d, "sharding", None)
        if actual is None:
            return True
        import warnings

        from jax.sharding import PartitionSpec as _P

        exp_sharded = expected.spec != _P(*([None] * len(d.shape)))
        if exp_sharded and actual.is_fully_replicated:
            warnings.warn(
                f"BlockArray buffer is fully replicated but grid "
                f"{self.grid.shape}/{self.grid.block_shape} implies "
                f"{expected.spec} on the mesh",
                RuntimeWarning,
                stacklevel=3,
            )
            return False
        return True

    @property
    def is_transposed(self):
        return self._transposed

    def _store(self, data, transposed=False):
        """Rebind the buffer, re-padding to the at-rest rule if needed."""
        raw_logical = (
            tuple(reversed(self.grid.shape)) if transposed
            else tuple(self.grid.shape)
        )
        if tuple(data.shape) == raw_logical:
            # Same grid-shape hint as __init__ — a hint-less call can
            # pad/shard axes the grid says are single-block (replicated),
            # leaving a buffer expected_sharding() calls inapplicable.
            hint = (
                tuple(reversed(self.grid.grid_shape)) if transposed
                else self.grid.grid_shape
            )
            pshape = self.backend.physical_shape(raw_logical, hint)
            if pshape != raw_logical:
                data = padded.repad(data, pshape, self.backend)
        self._data = data
        self._transposed = transposed

    @property
    def shape(self):
        return self.grid.shape

    @property
    def block_shape(self):
        return self.grid.block_shape

    @property
    def grid_shape(self):
        return self.grid.grid_shape

    @property
    def dtype(self):
        return np.dtype(self.grid.dtype)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self):
        return self.dtype.itemsize * self.size

    @property
    def T(self):
        return self.transpose()

    @property
    def blocks(self):
        out = np.empty(self.grid.grid_shape, dtype=object)
        for entry in self.grid.get_entry_iterator():
            out[entry] = Block(self, entry)
        return out

    def is_single_block(self):
        return self.grid.num_blocks == 1

    # ------------------------------------------------------------------
    # Materialization
    # ------------------------------------------------------------------

    def get(self) -> np.ndarray:
        # backend.get is multi-controller-aware: on >1 process it is a
        # COLLECTIVE (all processes call, all receive the global value).
        arr = np.asarray(self.backend.get(self.raw))
        raw_logical = self._raw_logical_shape()
        if arr.shape != raw_logical:
            # Strip at-rest padding (host-side view, no copy).
            arr = arr[tuple(slice(0, d) for d in raw_logical)]
        # Host-side transpose is a zero-copy view.
        return arr.transpose() if self._transposed else arr

    def touch(self):
        """Block until materialized without fetching (parity blockarray.py:117-126)."""
        jax.block_until_ready(self.raw)
        return self

    def copy(self):
        return BlockArray(
            lazy.apply(elementwise.touch, self._data), self.grid.copy(),
            self.backend, transposed=self._transposed,
        )

    # ------------------------------------------------------------------
    # Structure ops
    # ------------------------------------------------------------------

    def astype(self, dtype):
        name = array_utils.to_dtype_name(dtype)
        data = lazy.apply(elementwise.astype(name), self._data)
        grid = ArrayGrid(self.shape, self.block_shape, data.dtype.name)
        return BlockArray(data, grid, self.backend,
                          transposed=self._transposed)

    def transpose(self, *axes):
        if axes and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        perm = tuple(axes) if axes else tuple(reversed(range(self.ndim)))
        block_shape = tuple(self.block_shape[p] for p in perm)
        if perm == tuple(reversed(range(self.ndim))):
            # Zero-copy lazy transpose (parity: base.py:72-85).
            if self.ndim <= 1:
                return self
            shape = tuple(self.shape[p] for p in perm)
            grid = ArrayGrid(shape, block_shape, self.grid.dtype)
            return BlockArray(
                self._data, grid, self.backend,
                transposed=not self._transposed,
            )
        data = linear.transpose(perm)(self.data)
        return self._new(data, block_shape)

    def reshape(self, *shape, **kwargs):
        block_shape = kwargs.pop("block_shape", None)
        assert not kwargs, f"unexpected kwargs {kwargs}"
        if shape:
            new_shape = compute_shape(self.size, _normalize_shape(shape))
        else:
            new_shape = self.shape
        if new_shape == self.shape:
            data = self.data
        else:
            data = shape_ops.reshape(new_shape)(self.data)
        if block_shape is None:
            if new_shape == self.shape:
                return self
            block_shape = array_utils.default_block_shape_for(new_shape)
        block_shape = tuple(block_shape)
        grid = ArrayGrid(new_shape, block_shape, data.dtype.name)
        # Re-block = change of sharding only; move shards if the backend
        # maps the new grid differently (resharding collective under mesh).
        # Ragged shapes skip the explicit device_put (uneven explicit
        # shardings are illegal) — __init__ re-pads and shards instead.
        pshape = self.backend.physical_shape(new_shape, grid.grid_shape)
        if pshape == tuple(data.shape):
            target = self.backend.sharding_for_grid(grid)
            if target is not None and data.sharding != target:
                data = jax.device_put(data, target)
        return BlockArray(data, grid, self.backend)

    def broadcast_to(self, shape):
        """Parity: BlockArrayBase.broadcast_to (base.py:362-377)."""
        shape = tuple(shape)
        fn = shape_ops.broadcast_to(shape)
        return self._new(fn(self.data))

    def expand_dims(self, axis):
        data = shape_ops.expand_dims(axis)(self.data)
        return self._new(data)

    def squeeze(self):
        data = shape_ops.squeeze(self.data)
        bs = tuple(b for b, s in zip(self.block_shape, self.shape) if s != 1)
        return self._new(data, bs)

    def flattened_oids(self):
        # Parity shim for APIs that enumerate per-block objects.
        return [Block(self, e) for e in self.grid.get_entry_iterator()]

    # ------------------------------------------------------------------
    # Elementwise / reductions
    # ------------------------------------------------------------------

    def ufunc(self, op_name):
        # Elementwise ops commute with transpose (the flag carries
        # through) but NOT with at-rest padding: f(0) != 0 ops (exp,
        # cos, log, ...) would write nonzero values into the zero-filled
        # pads that raw-buffer contractions (the summa schedules) rely
        # on being zero. padded.call slices
        # pads away and re-pads the output with zeros, fused into the
        # same jitted program — the op writes the full buffer either
        # way, so this costs nothing on top of the raw path (and is a
        # no-op entirely when no at-rest padding is configured).
        trace.log_op(op_name, self)
        data, _ = padded.call(
            elementwise.uop(op_name), (self._data,),
            (self._raw_logical_shape(),), self.backend,
        )
        grid = ArrayGrid(self.shape, self.block_shape, data.dtype.name)
        return BlockArray(data, grid, self.backend,
                          transposed=self._transposed)

    def _reduce_call(self, kernel, axis, keepdims):
        """Run a reduction kernel with pad-stripping fused in."""
        data, lshape = padded.call(
            kernel, (self._data,), (self._raw_logical_shape(),), self.backend
        )
        bs = array_utils.reduced_block_shape(self.block_shape, axis, keepdims)
        return self._new(data, bs, shape=lshape)

    def reduce_axis(self, op_name, axis, keepdims=False, dtype=None):
        trace.log_op(op_name, self)
        kernel = reductions.reduce(
            op_name, axis, bool(keepdims), array_utils.to_dtype_name(dtype),
            self._transposed,
        )
        return self._reduce_call(kernel, axis, keepdims)

    def sum(self, axis=None, keepdims=False, dtype=None):
        trace.log_op("sum", self)
        axis = _norm_axis(axis)
        kernel = reductions.reduce(
            "sum", axis, bool(keepdims), array_utils.to_dtype_name(dtype),
            self._transposed,
        )
        return self._reduce_call(kernel, axis, keepdims)

    def mean(self, axis=None, keepdims=False, dtype=None):
        trace.log_op("mean", self)
        axis = _norm_axis(axis)
        kernel = reductions.reduce(
            "mean", axis, bool(keepdims), array_utils.to_dtype_name(dtype),
            self._transposed,
        )
        return self._reduce_call(kernel, axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self.reduce_axis("min", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self.reduce_axis("max", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self.reduce_axis("prod", axis, keepdims)

    def argmin(self, axis=None):
        kernel = reductions.arg_op("argmin", axis, self._transposed)
        data, lshape = padded.call(
            kernel, (self._data,), (self._raw_logical_shape(),), self.backend
        )
        return self._new(data, shape=lshape)

    def argmax(self, axis=None):
        kernel = reductions.arg_op("argmax", axis, self._transposed)
        data, lshape = padded.call(
            kernel, (self._data,), (self._raw_logical_shape(),), self.backend
        )
        return self._new(data, shape=lshape)

    def var(self, axis=None, ddof=0, keepdims=False, dtype=None):
        trace.log_op("var", self)
        axis = _norm_axis(axis)
        kernel = reductions.var(
            axis, int(ddof), bool(keepdims), array_utils.to_dtype_name(dtype),
            self._transposed,
        )
        return self._reduce_call(kernel, axis, keepdims)

    def std(self, axis=None, ddof=0, keepdims=False, dtype=None):
        trace.log_op("std", self)
        axis = _norm_axis(axis)
        kernel = reductions.std(
            axis, int(ddof), bool(keepdims), array_utils.to_dtype_name(dtype),
            self._transposed,
        )
        return self._reduce_call(kernel, axis, keepdims)

    # ------------------------------------------------------------------
    # Binary ops
    # ------------------------------------------------------------------

    def check_or_convert_other(self, other, compute_block_shape=False):
        """Coerce an operand to something our jitted bops accept.

        Parity: blockarray.py:322-335. Python scalars stay raw (jax weak
        typing reproduces NumPy value-based promotion); ndarrays are
        device_put and wrapped.
        """
        del compute_block_shape
        if isinstance(other, BlockArray):
            return other
        if array_utils.is_scalar_like(other):
            return other
        if isinstance(other, (np.ndarray, list, tuple)):
            return BlockArray.from_np(np.asarray(other), backend=self.backend)
        if isinstance(other, jax.Array):
            return BlockArray.from_jax(other, backend=self.backend)
        raise ValueError(f"Cannot operate on {type(other)}")

    def _bop(self, op_name, other, reverse=False):
        other = self.check_or_convert_other(other)
        if isinstance(other, BlockArray):
            o_data, o_shape, o_bs = other._data, other.shape, other.block_shape
            o_t = other._transposed
            o_logical = other._raw_logical_shape()
        else:
            o_data, o_shape, o_bs = other, (), ()
            o_t = False
            o_logical = None
        s_logical = self._raw_logical_shape()
        if reverse:
            a, b, ta, tb = o_data, self._data, o_t, self._transposed
            la, lb = o_logical, s_logical
        else:
            a, b, ta, tb = self._data, o_data, self._transposed, o_t
            la, lb = s_logical, o_logical
        trace.log_op(op_name, self, other)
        data, lshape = padded.call(
            elementwise.bop(op_name, ta, tb), (a, b), (la, lb), self.backend
        )
        bs = array_utils.broadcast_block_shape(
            lshape, self.shape, self.block_shape, o_shape, o_bs
        )
        return self._new(data, bs, shape=lshape)

    # Arithmetic
    def __add__(self, other):
        return self._bop("add", other)

    def __radd__(self, other):
        return self._bop("add", other, reverse=True)

    def __sub__(self, other):
        return self._bop("subtract", other)

    def __rsub__(self, other):
        return self._bop("subtract", other, reverse=True)

    def __mul__(self, other):
        return self._bop("multiply", other)

    def __rmul__(self, other):
        return self._bop("multiply", other, reverse=True)

    def __truediv__(self, other):
        return self._bop("true_divide", other)

    def __rtruediv__(self, other):
        return self._bop("true_divide", other, reverse=True)

    def __floordiv__(self, other):
        return self._bop("floor_divide", other)

    def __rfloordiv__(self, other):
        return self._bop("floor_divide", other, reverse=True)

    def __mod__(self, other):
        return self._bop("mod", other)

    def __rmod__(self, other):
        return self._bop("mod", other, reverse=True)

    def __pow__(self, other):
        return self._bop("power", other)

    def __rpow__(self, other):
        return self._bop("power", other, reverse=True)

    # In-place aliases (functional under the hood; parity blockarray.py:612-617)
    __iadd__ = __add__
    __isub__ = __sub__
    __imul__ = __mul__
    __itruediv__ = __truediv__
    __ipow__ = __pow__

    # Comparison
    def _const_bool(self, value: bool):
        """Full-shape bool constant (pads re-zeroed): NumPy's result
        for equality against an incomparable operand like None."""
        data, _ = padded.call(
            elementwise.const_bool(bool(value)), (self._data,),
            (self._raw_logical_shape(),), self.backend,
        )
        grid = ArrayGrid(self.shape, self.block_shape, "bool")
        return BlockArray(data, grid, self.backend,
                          transposed=self._transposed)

    def __eq__(self, other):
        if other is None:  # np.ndarray == None -> elementwise False
            return self._const_bool(False)
        return self._bop("equal", other)

    def __ne__(self, other):
        if other is None:  # np.ndarray != None -> elementwise True
            return self._const_bool(True)
        return self._bop("not_equal", other)

    def __lt__(self, other):
        return self._bop("less", other)

    def __le__(self, other):
        return self._bop("less_equal", other)

    def __gt__(self, other):
        return self._bop("greater", other)

    def __ge__(self, other):
        return self._bop("greater_equal", other)

    __hash__ = None

    # Bitwise / logical (NumPy semantics: & | ^ are bitwise; on bools they
    # coincide with logical ops).
    def __and__(self, other):
        return self._bop("bitwise_and", other)

    def __rand__(self, other):
        return self._bop("bitwise_and", other, reverse=True)

    def __or__(self, other):
        return self._bop("bitwise_or", other)

    def __ror__(self, other):
        return self._bop("bitwise_or", other, reverse=True)

    def __xor__(self, other):
        return self._bop("bitwise_xor", other)

    def __rxor__(self, other):
        return self._bop("bitwise_xor", other, reverse=True)

    def __lshift__(self, other):
        return self._bop("left_shift", other)

    def __rshift__(self, other):
        return self._bop("right_shift", other)

    # Unary
    def __neg__(self):
        return self.ufunc("negative")

    def __pos__(self):
        return self.ufunc("positive")

    def __abs__(self):
        return self.ufunc("abs")

    def __invert__(self):
        return self.ufunc("invert")

    # ------------------------------------------------------------------
    # Contractions
    # ------------------------------------------------------------------

    def tensordot(self, other, axes=2):
        other = self.check_or_convert_other(other)
        if not isinstance(other, BlockArray):
            other = BlockArray.from_scalar(other, self.backend)
        if isinstance(axes, int):
            static_axes = int(axes)
        else:
            static_axes = tuple(tuple(a) for a in axes)
        trace.log_op("tensordot", self, other)
        collective = self._collective_matmul(other, static_axes)
        if collective is not None:
            return collective
        if other._data is self._data:
            data, lshape = padded.call(
                linear.tensordot_same(
                    static_axes, self._transposed, other._transposed
                ),
                (self._data,), (self._raw_logical_shape(),), self.backend,
            )
        else:
            data, lshape = padded.call(
                linear.tensordot(
                    static_axes, self._transposed, other._transposed
                ),
                (self._data, other._data),
                (self._raw_logical_shape(), other._raw_logical_shape()),
                self.backend,
            )
        if isinstance(static_axes, int):
            bs = array_utils.tensordot_block_shape(
                self.block_shape, other.block_shape, static_axes
            )
        else:
            bs = array_utils.default_block_shape_for(lshape)
        return self._new(data, bs, shape=lshape)

    @staticmethod
    def _explicit_choice(backend, mode, ta, tb, a_phys, b_phys):
        """Schedule for an explicit mode (ring|summa): transposed
        patterns always take their dedicated kernel; NN (and TT, which
        is NN on the swapped raws) takes the NAMED schedule when the
        physical shapes divide the mesh, else None (→ XLA)."""
        from nums_tpu.core.ops import summa

        if ta and not tb:
            return (
                "tn" if summa.tn_supported(backend, a_phys, b_phys)
                else None
            )
        if tb and not ta:
            return (
                "nt" if summa.nt_supported(backend, a_phys, b_phys)
                else None
            )
        if ta and tb:  # NN schedule runs on the swapped raws
            a_phys, b_phys = b_phys, a_phys
        if mode == "ring" and summa.ring_supported(backend, a_phys, b_phys):
            return "ring"
        if mode == "summa" and summa.supported(backend, a_phys, b_phys):
            return "summa"
        return None

    def _collective_matmul(self, other, static_axes):
        """Hand-scheduled mesh GEMM (NUMS_TPU_COLLECTIVE_MATMUL=
        ring|summa|auto).

        The analogue of the reference's NCCL p2p path: explicit device
        collectives instead of auto-SPMD. Covers all four transpose
        patterns: NN rides the ring/SUMMA schedule; TN (the x.T @ x
        headline) is a local GEMM + one reduce-scatter with the
        transpose fused into the contraction; NT all-gathers the B
        panel; TT runs the NN schedule on the swapped raw buffers and
        marks the result lazily transposed (zero extra data movement).
        ``auto`` picks per-shape via ``summa.choose_schedule`` — the
        dispatch analogue of the reference's per-operand transfer
        routing (gpu_systems.py:556-606 there). Ragged (pad-and-mask)
        operands need no masking: at-rest pads are ZERO-filled
        (ops/padded._pad_out), so pad rows contribute zero to every
        contraction. Returns None (→ default XLA partitioning) when
        disabled or no schedule fits; the schedule actually dispatched
        is recorded in ``summa.LAST_DISPATCH``.
        """
        from nums_tpu.core import settings as _settings

        mode = _settings.collective_matmul
        if mode not in ("ring", "summa", "auto"):
            return None
        if (
            static_axes != 1
            or self.ndim != 2
            or other.ndim != 2
            or self.backend.mesh is None
        ):
            return None
        from nums_tpu.core.ops import summa

        ta, tb = self._transposed, other._transposed
        # Physical (possibly padded) buffer shapes; LazyOut knows its
        # shape without forcing, so this never splits the lazy DAG.
        a_phys = tuple(self._data.shape)
        b_phys = tuple(other._data.shape)
        if mode == "auto":
            choice = summa.choose_schedule(
                self.backend, ta, tb, a_phys, b_phys,
                np.dtype(self._data.dtype).itemsize,
            )
        else:
            choice = self._explicit_choice(
                self.backend, mode, ta, tb, a_phys, b_phys
            )
        summa.LAST_DISPATCH = choice or "xla"
        if choice is None:
            return None
        kernel = {
            "tn": summa.tn_matmul,
            "nt": summa.nt_matmul,
            "ring": summa.ring_matmul,
            "summa": summa.summa_matmul,
        }[choice](self.backend)
        lshape = (self.shape[0], other.shape[1])
        bs = array_utils.tensordot_block_shape(
            self.block_shape, other.block_shape, 1
        )
        if ta and tb:
            # C = Aᵀ·Bᵀ = (Braw @ Araw)ᵀ
            data = lazy.apply(kernel, other._data, self._data)
            grid = ArrayGrid(lshape, bs, np.dtype(data.dtype).name)
            return BlockArray(data, grid, self.backend, transposed=True)
        data = lazy.apply(kernel, self._data, other._data)
        return self._new(data, bs, shape=lshape)

    def __matmul__(self, other):
        other = self.check_or_convert_other(other)
        if self.ndim > 2 or (isinstance(other, BlockArray) and other.ndim > 2):
            if isinstance(other, BlockArray):
                o, o_t, o_l = other._data, other._transposed, (
                    other._raw_logical_shape()
                )
            else:
                o, o_t, o_l = other, False, None
            data, lshape = padded.call(
                linear.matmul(self._transposed, o_t),
                (self._data, o), (self._raw_logical_shape(), o_l),
                self.backend,
            )
            return self._new(data, shape=lshape)
        return self.tensordot(other, axes=1)

    def __rmatmul__(self, other):
        other = self.check_or_convert_other(other)
        if not isinstance(other, BlockArray):
            raise ValueError("matmul requires array operands")
        return other.__matmul__(self)

    # ------------------------------------------------------------------
    # Indexing
    # ------------------------------------------------------------------

    @staticmethod
    def _is_bool_mask(s):
        return (
            isinstance(s, BlockArray) and s.dtype == np.bool_
        ) or (isinstance(s, np.ndarray) and s.dtype == np.bool_)

    def _normalize_subscript(self, item, for_set=False):
        if not isinstance(item, tuple):
            item = (item,)
        out = []
        for s in item:
            if self._is_bool_mask(s):
                if for_set:
                    raise NotImplementedError(
                        "use __setitem__'s dedicated mask path"
                    )
                if isinstance(s, BlockArray):
                    # Device-side resolution: ONE scalar host sync (the
                    # true-count); index arrays never leave the device
                    # (the reference raises here; round-1 fetched the
                    # whole mask to host).
                    from nums_tpu.core.ops import masking

                    _, idx_arrays = masking.device_where(s)
                    out.extend(idx_arrays)
                else:
                    for idx in np.where(s):
                        out.append(jnp.asarray(idx))
            elif isinstance(s, BlockArray):
                out.append(s.data)
            elif isinstance(s, np.ndarray):
                out.append(jnp.asarray(s))
            else:
                out.append(s)
        return tuple(out)

    def __getitem__(self, item):
        key = self._normalize_subscript(item)
        data = self.data[key]
        # Derive block shape: keep old blocking on surviving sliced axes.
        return self._new(data)

    def __setitem__(self, item, value):
        if isinstance(value, BlockArray):
            v = value.data
        elif isinstance(value, (np.ndarray, list, tuple)):
            v = jnp.asarray(np.asarray(value))
        else:
            v = value
        # Boolean-mask assignment: fully on-device select — static shapes,
        # no host sync (the masked WRITE, unlike the masked read, never
        # needs the dynamic index set).
        if not isinstance(item, tuple) and self._is_bool_mask(item):
            mask = item.data if isinstance(item, BlockArray) else jnp.asarray(item)
            v_shape = tuple(getattr(v, "shape", ()))
            # NumPy semantics: a[mask] = v broadcasts only when v is
            # scalar-like; any non-scalar v assigns PACKED (row-major
            # True-position order), never positionally via broadcast.
            scalar_like = int(np.prod(v_shape, dtype=np.int64)) == 1
            if scalar_like:
                if mask.ndim < self.ndim:
                    mask = jnp.expand_dims(
                        mask, tuple(range(mask.ndim, self.ndim))
                    )
                self._store(jnp.where(mask, v, self.data))
            else:
                # Packed-vector form (v has one element per True): the
                # index set is data-dependent. Device-held masks resolve
                # via the capacity idiom — ONE scalar sync (the
                # true-count), the mask never crosses the host boundary
                # (mirrors the read path in _normalize_subscript).
                if isinstance(item, BlockArray):
                    from nums_tpu.core.ops import masking

                    _, idx = masking.device_where(item)
                else:
                    idx = tuple(
                        jnp.asarray(i) for i in np.where(np.asarray(item))
                    )
                self._store(self.data.at[idx].set(v))
            return
        key = self._normalize_subscript(item)
        self._store(self.data.at[key].set(v))

    # ------------------------------------------------------------------
    # Scalar conversions
    # ------------------------------------------------------------------

    def _scalar_value(self):
        if self.size != 1:
            raise ValueError(
                "The truth value of an array with more than one element is "
                "ambiguous."
            )
        return self.get().reshape(())[()]

    def __bool__(self):
        # Parity: reference __bool__ (blockarray.py:620-628) — size-1 bool
        # arrays evaluate their value; everything else is truthy (so
        # ``if beta:`` on a parameter vector means "is present").
        if self.dtype == np.bool_ and all(s == 1 for s in self.shape):
            return bool(self._scalar_value())
        return True

    def __float__(self):
        return float(self._scalar_value())

    def __int__(self):
        return int(self._scalar_value())

    def __complex__(self):
        return complex(self._scalar_value())

    # ------------------------------------------------------------------
    # ndarray-style convenience methods (drop-in friendliness; delegate
    # to the facade's jitted implementations)
    # ------------------------------------------------------------------

    def all(self, axis=None):
        from nums_tpu.numpy import extra

        return extra.all(self, axis=axis)

    def any(self, axis=None):
        from nums_tpu.numpy import extra

        return extra.any(self, axis=axis)

    def clip(self, a_min=None, a_max=None):
        from nums_tpu.numpy import extra

        return extra.clip(self, a_min, a_max)

    def round(self, decimals=0):
        from nums_tpu.numpy import extra

        return extra.around(self, decimals)

    def cumsum(self, axis=None):
        from nums_tpu.numpy import extra

        return extra.cumsum(self, axis=axis)

    def cumprod(self, axis=None):
        from nums_tpu.numpy import extra

        return extra.cumprod(self, axis=axis)

    def take(self, indices, axis=None):
        from nums_tpu.numpy import extra

        return extra.take(self, indices, axis=axis)

    def repeat(self, repeats, axis=None):
        from nums_tpu.numpy import extra

        return extra.repeat(self, repeats, axis=axis)

    def ravel(self):
        return self.reshape(self.size)

    def flatten(self):
        return self.reshape(self.size)

    def swapaxes(self, axis1, axis2):
        from nums_tpu.numpy import extra

        return extra.swapaxes(self, axis1, axis2)

    def sort(self, axis=-1):
        # NumPy sorts in place; rebind the wrapper (same convention as
        # __setitem__).
        from nums_tpu.numpy import extra

        out = extra.sort(self, axis=axis)
        self._store(out.data)
        return None

    def argsort(self, axis=-1):
        from nums_tpu.numpy import extra

        return extra.argsort(self, axis=axis)

    def nonzero(self):
        from nums_tpu.numpy import extra

        return extra.nonzero(self)

    def conj(self):
        return self.ufunc("conj")

    conjugate = conj

    @property
    def real(self):
        from nums_tpu.numpy import extra

        return extra.real(self)

    @property
    def imag(self):
        from nums_tpu.numpy import extra

        return extra.imag(self)

    def dot(self, other):
        from nums_tpu.numpy import extra

        return extra.dot(self, other)

    def trace(self, offset=0):
        from nums_tpu.numpy import extra

        return extra.trace(self, offset=offset)

    def diagonal(self, offset=0):
        from nums_tpu.numpy import extra

        return extra.diagonal(self, offset=offset)

    def item(self):
        return self._scalar_value()

    def tolist(self):
        return self.get().tolist()

    def __array__(self, dtype=None, copy=None):
        """NumPy interop: np.asarray(ba) fetches the materialized array
        (host sync). Binary numpy-op dispatch still defers to our
        operators via __array_ufunc__ = None."""
        del copy
        out = self.get()
        return out.astype(dtype) if dtype is not None else out

    def __repr__(self):
        return f"BlockArray({self.get()})"

    def __str__(self):
        return str(self.get())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]
