"""ArrayApplication: the featureful mid-layer.

Parity target: ``nums/core/array/application.py:35-1062`` (semantics only).
Constructors, block-shape policy, reductions, distributed linalg
(TSQR/SVD/inv/Cholesky/regressions), and I/O orchestration — rebuilt so
each operation is one (or a few) jitted XLA programs instead of a driver
loop of per-block tasks.
"""

import numpy as np

from nums_tpu.core import settings
from nums_tpu.core.backend import Backend, MeshBackend
from nums_tpu.core.grid import ArrayGrid
from nums_tpu.core.array import utils as array_utils
from nums_tpu.core.array.blockarray import BlockArray
from nums_tpu.core.array.random import NumsRandomState
from nums_tpu.core.ops import (
    creation,
    elementwise,
    linalg,
    padded,
    shape_ops,
)


def _device_rows(panel, lo, hi, rows, fill):
    """Host rows [lo, hi) of the PADDED panel: logical rows come from
    ``panel`` (ndarray, or a lazy ``PanelRef`` loading only this range
    from disk); rows at/past ``rows`` are the pad, filled with ``fill``."""
    llo, lhi = min(lo, rows), min(hi, rows)
    if hasattr(panel, "load"):  # PanelRef: O(local rows) disk IO
        body = panel.load(llo, lhi)
    else:
        body = panel[llo:lhi]
    if lhi - llo == hi - lo:
        return body
    filler = np.full(
        (hi - lo - (lhi - llo),) + tuple(body.shape[1:]),
        fill, np.dtype(panel.dtype),
    )
    return np.concatenate([body, filler], axis=0) if body.shape[0] else filler


def _global_put(get_rows, gshape, sharding):
    """Assemble a GLOBAL jax.Array under multi-controller: each process
    device_puts only the row ranges its addressable devices cover
    (``get_rows(lo, hi)``), then the shards join into one global array.
    The multi-controller replacement for ``jax.device_put(host, s)``
    (which faults on non-addressable devices)."""
    import jax

    arrays = []
    for dev, idx in sharding.addressable_devices_indices_map(gshape).items():
        if len(gshape):
            s0 = idx[0] if len(idx) else slice(None)
            lo = s0.start or 0
            hi = s0.stop if s0.stop is not None else gshape[0]
        else:
            lo, hi = 0, 0  # 0-d (replicated scalar)
        arrays.append(jax.device_put(get_rows(lo, hi), dev))
    return jax.make_array_from_single_device_arrays(
        gshape, sharding, arrays
    )


def ooc_put(backend, panel, fill=0.0, augment_ones=False):
    """Host panel → device, ROW-SHARDED over the whole mesh (rows pad
    to the device-count multiple with ``fill``); single-device backends
    place it whole. Returns (device_panel, n_valid_rows). Streaming
    kernels consuming padded panels must be fill-neutral (0 for
    additive stats, ±inf for min/max) or row-masked (GLM/KMeans stats
    mask via the n_valid argument).

    ``panel`` may be a host ndarray or a ``PanelRef`` (lazy disk panel).
    Under multi-controller SPMD every process calls this collectively;
    each puts only the rows of ITS addressable devices (a PanelRef then
    reads 1/P of the panel from disk — the reference's cluster-wide
    aggregate-bandwidth execution, systems.py:156-191 there).

    ``augment_ones`` (serial backend only) appends the GLM intercept
    column (all ones; serial panels have no pad rows to mask) on the
    host, before the transfer."""
    import jax

    from nums_tpu.core import multiprocess as _mp

    mesh = getattr(backend, "mesh", None)
    rows = panel.shape[0]
    if mesh is not None and augment_ones:
        raise ValueError(
            "augment_ones is serial-backend only (mesh panels carry pad "
            "rows that an all-ones intercept column would contaminate); "
            "pre-shape the panel instead"
        )
    if mesh is None:
        if hasattr(panel, "full"):
            panel = panel.full()
        if augment_ones:
            ones = np.ones((rows, 1), panel.dtype)
            panel = np.concatenate([panel, ones], axis=-1)
        return jax.device_put(panel), rows
    n_dev = int(np.prod(mesh.devices.shape))
    pad = (-rows) % n_dev
    spec = jax.sharding.PartitionSpec(
        tuple(mesh.axis_names), *([None] * (len(panel.shape) - 1))
    )
    sharding = jax.sharding.NamedSharding(mesh, spec)
    if _mp.is_multiprocess():
        gshape = (rows + pad,) + tuple(panel.shape[1:])
        arr = _global_put(
            lambda lo, hi: _device_rows(panel, lo, hi, rows, fill),
            gshape, sharding,
        )
        return arr, rows
    if hasattr(panel, "full"):
        panel = panel.full()
    if pad:
        filler = np.full((pad,) + panel.shape[1:], fill, panel.dtype)
        panel = np.concatenate([panel, filler], axis=0)
    return jax.device_put(panel, sharding), rows


def ooc_accumulator(backend, value):
    """Device accumulator for a streaming fold. Single-process: the
    value as-is (jnp array). Multi-controller: re-placed as a mesh-
    REPLICATED global array — a per-process local array cannot appear in
    the same jitted update as a global panel (incompatible devices)."""
    from nums_tpu.core import multiprocess as _mp

    mesh = getattr(backend, "mesh", None)
    if mesh is None or not _mp.is_multiprocess():
        return value
    import jax

    host = np.asarray(value)
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(*([None] * host.ndim))
    )
    return _global_put(
        lambda lo, hi: host[lo:hi] if host.ndim else host,
        tuple(host.shape), sharding,
    )


def ooc_panels(X):
    """Row-panel stream for an OOC fold: full host panels (prefetched)
    single-process; lazy PanelRefs under multi-controller so each
    process reads only its addressable rows."""
    from nums_tpu.core import multiprocess as _mp

    if _mp.is_multiprocess():
        return X.iter_panel_refs()
    return X.iter_row_panels()


def _ooc_y_getter(X, y):
    """(start, length) → host y slice aligned with X's row panels.

    y may be a 1-D DiskArray sharing X's row partitioning, a BlockArray,
    or a host array (an (n,) float64 vector is 160 MB even at n=20M —
    host-resident is fine when X itself is the out-of-core operand).
    """
    from nums_tpu.core.array.diskarray import DiskArray

    if isinstance(y, DiskArray):
        assert y.ndim == 1, y.shape
        assert list(y.grid.grid_slices[0]) == list(X.grid.grid_slices[0]), (
            "y DiskArray must share X's row partitioning"
        )
        index = {s: i for i, (s, _) in enumerate(y.grid.grid_slices[0])}

        def get(start, length):
            arr = y.row_panel(index[start])
            assert arr.shape[0] == length, (arr.shape, length)
            return arr

        return get
    host = y.get() if isinstance(y, BlockArray) else np.asarray(y)
    if host.shape[:1] != (X.shape[0],):
        raise ValueError(
            f"y has {host.shape[0] if host.ndim else 'scalar'} rows, "
            f"X has {X.shape[0]} — an oversized y would be silently "
            f"truncated to X's row range"
        )

    def get(start, length):
        return host[start:start + length]

    return get


class ArrayApplication:
    def __init__(self, backend: Backend, filesystem=None):
        self.backend = backend
        # `system` alias preserves the reference attribute name.
        self.system = backend
        self._filesystem = filesystem
        self._block_shape_map = {}
        self._random = None
        self.one_half = self.scalar(0.5)
        self.two = self.scalar(2.0)
        self.one = self.scalar(1.0)
        self.zero = self.scalar(0.0)

    @property
    def fs(self):
        if self._filesystem is None:
            from nums_tpu.core.io.filesystem import FileSystem

            self._filesystem = FileSystem(self.backend)
        return self._filesystem

    def num_cores_total(self):
        return self.backend.num_cores_total

    # ------------------------------------------------------------------
    # Block-shape policy (parity: application.py:59-142)
    # ------------------------------------------------------------------

    def compute_block_shape(
        self, shape: tuple, dtype, cluster_shape=None, num_cores=None
    ):
        """Choose a block shape for a new array.

        Mirrors the reference policy (application.py:59-130): small arrays
        (<100MB) get a single block; otherwise the grid is sized to ~the
        device count, weighted toward long axes. On the mesh backend the
        grid aligns to the mesh so sharding is even.
        """
        dtype = array_utils.to_np_dtype(dtype)
        nbytes = dtype.itemsize
        size = int(np.prod(shape)) * nbytes if len(shape) else nbytes
        if size < 10**8:
            return tuple(shape)

        if num_cores is None:
            num_cores = self.num_cores_total()
        if cluster_shape is None:
            if isinstance(self.backend, MeshBackend):
                cluster_shape = self.backend.cluster_shape
            else:
                cluster_shape = (1, 1)

        if len(shape) < len(cluster_shape):
            cluster_shape = cluster_shape[: len(shape)]
        elif len(shape) > len(cluster_shape):
            cluster_shape = tuple(cluster_shape) + (1,) * (
                len(shape) - len(cluster_shape)
            )

        shape_np = np.array(shape, dtype=np.int64)
        cluster_weights = np.exp(np.array(cluster_shape)) / np.sum(
            np.exp(cluster_shape)
        )
        shape_fracs = shape_np / np.sum(shape_np)
        weighted = cluster_weights * shape_fracs
        weighted = weighted / np.sum(weighted)
        grid_shape_frac = num_cores**weighted
        grid_shape = np.floor(grid_shape_frac)
        remaining = np.sum(grid_shape_frac - grid_shape)
        grid_shape[np.argmax(shape_np)] += remaining
        grid_shape = np.ceil(grid_shape).astype(np.int64)
        block_shape = tuple(
            int(x) for x in (shape_np + grid_shape - 1) // grid_shape
        )
        return block_shape

    def get_block_shape(self, shape, dtype):
        """Memoized per-dimension block sizes (parity: application.py:132-142)."""
        block_shape = self.compute_block_shape(shape, dtype)
        final = []
        for axis in range(len(shape)):
            dim = shape[axis]
            if dim not in self._block_shape_map:
                self._block_shape_map[dim] = block_shape[axis]
            final.append(self._block_shape_map[dim])
        return tuple(final)

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    def scalar(self, value):
        return BlockArray.from_scalar(value, self.backend)

    def array(self, array: np.ndarray, block_shape: tuple = None):
        array = np.asarray(array)
        if block_shape is None:
            block_shape = self.get_block_shape(array.shape, array.dtype)
        assert len(array.shape) == len(block_shape)
        return BlockArray.from_np(
            array, block_shape=block_shape, copy=False, backend=self.backend
        )

    def _grid_physical(self, grid):
        """(physical_shape, sharding) for a grid — creation kernels compile
        straight into the padded at-rest shape (pads are never read)."""
        return (
            self.backend.physical_shape(grid.shape, grid.grid_shape),
            self.backend.sharding_for_grid(grid),
        )

    def _new_array(self, op_name, shape, block_shape, dtype=None):
        if dtype is None:
            dtype = settings.default_float
        dtype_name = array_utils.to_dtype_name(dtype)
        grid = ArrayGrid(tuple(shape), tuple(block_shape), dtype_name)
        # Generate at the LOGICAL shape, zero-pad to the at-rest shape
        # inside the same program: keeps the global invariant that pads
        # are zero (ones at pshape would fill pads with ones).
        pshape, sharding = self._grid_physical(grid)
        data = creation.new_array(
            op_name, grid.shape, dtype_name, sharding, pshape
        )()
        return BlockArray(data, grid, self.backend)

    def zeros(self, shape, block_shape, dtype=None):
        return self._new_array("zeros", shape, block_shape, dtype)

    def ones(self, shape, block_shape, dtype=None):
        return self._new_array("ones", shape, block_shape, dtype)

    def empty(self, shape, block_shape, dtype=None):
        return self._new_array("empty", shape, block_shape, dtype)

    def full(self, shape, block_shape, fill_value, dtype=None):
        if dtype is None:
            dtype = np.asarray(fill_value).dtype
        dtype_name = array_utils.to_dtype_name(dtype)
        grid = ArrayGrid(tuple(shape), tuple(block_shape), dtype_name)
        pshape, sharding = self._grid_physical(grid)
        data = creation.full(
            grid.shape, dtype_name, sharding, pshape
        )(fill_value)
        return BlockArray(data, grid, self.backend)

    def eye(self, shape, block_shape, dtype=None):
        assert len(shape) == len(block_shape) == 2
        if dtype is None:
            dtype = settings.default_float
        return self.eye_k(shape, block_shape, k=0, dtype=dtype)

    def eye_k(self, shape, block_shape, k=0, dtype=None):
        if dtype is None:
            dtype = settings.default_float
        dtype_name = array_utils.to_dtype_name(dtype)
        grid = ArrayGrid(tuple(shape), tuple(block_shape), dtype_name)
        # eye is slice-stable for READS, but the diagonal can run through
        # the pad region (eye(17, 25) padded to 20 rows puts 1s at rows
        # 17-19) — generate at logical shape and zero-pad so at-rest pads
        # stay zero (collective-matmul invariant).
        pshape, sharding = self._grid_physical(grid)
        data = creation.eye(grid.shape, int(k), dtype_name, sharding, pshape)()
        return BlockArray(data, grid, self.backend)

    def diag(self, X: BlockArray) -> BlockArray:
        if X.ndim == 1:
            block_shape = (X.block_shape[0], X.block_shape[0])
        elif X.ndim == 2:
            assert X.shape[0] == X.shape[1], "X must be square."
            block_shape = (X.block_shape[0],)
        else:
            raise ValueError("X must have 1 or 2 axes.")
        data, lshape = padded.call(
            creation.diag, (X._data,), (X._raw_logical_shape(),),
            self.backend, transposes=(X.is_transposed,),
        )
        grid = ArrayGrid(lshape, block_shape, np.dtype(data.dtype).name)
        return BlockArray(data, grid, self.backend)

    def arange(self, shape, block_shape, step=1, dtype=None) -> BlockArray:
        if dtype is None:
            dtype = settings.default_int
        assert step == 1
        dtype_name = array_utils.to_dtype_name(dtype)
        grid = ArrayGrid(tuple(shape), tuple(block_shape), dtype_name)
        # arange iota values in the pad are never READ, but non-zero pads
        # would break the pad-blind collective matmul — generate at the
        # logical length and zero-pad.
        pshape, sharding = self._grid_physical(grid)
        data = creation.arange(
            0, grid.shape[0], step, dtype_name, sharding, pshape
        )()
        return BlockArray(data, grid, self.backend)

    def linspace(
        self, start, stop, shape, block_shape, endpoint=True, retstep=False,
        dtype=None, axis=0,
    ):
        assert axis == 0 and retstep is False
        dtype_name = array_utils.to_dtype_name(dtype) if dtype else "float64"
        grid = ArrayGrid(tuple(shape), tuple(block_shape), dtype_name)
        # linspace is NOT slice-stable (step depends on num): generate at
        # the logical length, pad inside the same program.
        pshape, sharding = self._grid_physical(grid)
        data = creation.linspace(
            grid.shape[0], bool(endpoint), dtype_name, 0, sharding, pshape
        )(start, stop)
        return BlockArray(data, grid, self.backend)

    def concatenate(self, arrays, axis, axis_block_size=None):
        if len(arrays) == 1:
            return arrays[0]
        first = arrays[0]
        for a in arrays:
            assert a.ndim == first.ndim, "Unequal num axes."
        data, lshape = padded.call(
            shape_ops.concatenate(int(axis), len(arrays)),
            tuple(a._data for a in arrays),  # deferred chains stay fused
            tuple(a._raw_logical_shape() for a in arrays),
            self.backend,
            transposes=tuple(a.is_transposed for a in arrays),
        )
        result_block_shape = list(first.block_shape)
        result_block_shape[axis] = (
            axis_block_size
            if axis_block_size is not None
            else first.block_shape[axis]
        )
        result_block_shape = tuple(
            min(b, s) for b, s in zip(result_block_shape, lshape)
        )
        grid = ArrayGrid(
            lshape, result_block_shape, np.dtype(data.dtype).name
        )
        return BlockArray(data, grid, self.backend)

    def split(self, X: BlockArray, indices_or_sections, axis=0):
        if not isinstance(indices_or_sections, int):
            raise NotImplementedError("Split currently supports integers only.")
        dim = X.shape[axis]
        assert dim % indices_or_sections == 0, (
            "array split does not result in an equal division"
        )
        step = dim // indices_or_sections
        out = []
        for i in range(indices_or_sections):
            sel = tuple(
                slice(i * step, (i + 1) * step) if ax == axis else slice(None)
                for ax in range(X.ndim)
            )
            out.append(X[sel])
        return out

    # ------------------------------------------------------------------
    # Elementwise / reductions (parity: application.py:474-613)
    # ------------------------------------------------------------------

    def log(self, X):
        return self.map_uop("log", X)

    def exp(self, X):
        return self.map_uop("exp", X)

    def abs(self, X):
        return self.map_uop("abs", X)

    def sqrt(self, X):
        if X.dtype not in (float, np.float32, np.float64):
            X = X.astype(np.float64)
        return X.ufunc("sqrt")

    def norm(self, X):
        return self.sqrt(X.T @ X)

    def xlogy(self, x: BlockArray, y) -> BlockArray:
        if x.dtype not in (float, np.float32, np.float64):
            x = x.astype(np.float64)
        return self.map_bop("xlogy", x, y)

    def min(self, X, axis=None, keepdims=False):
        return self.reduce("min", X, axis, keepdims)

    def max(self, X, axis=None, keepdims=False):
        return self.reduce("max", X, axis, keepdims)

    def sum(self, X, axis=None, keepdims=False, dtype=None):
        return self.reduce("sum", X, axis, keepdims, dtype)

    def reduce(self, op_name, X, axis=None, keepdims=False, dtype=None):
        # dtype reaches the reduction KERNEL (the accumulator dtype),
        # not a post-cast: np.sum(int32, dtype=int64) accumulates in
        # int64 — casting after the int32 reduction would keep the
        # overflow (and a float64 request would lose the precision the
        # caller asked for).
        return X.reduce_axis(op_name, axis, keepdims=keepdims, dtype=dtype)

    def mean(self, X, axis=None, keepdims=False, dtype=None):
        if X.dtype not in (float, np.float32, np.float64):
            X = X.astype(np.float64)
        return X.mean(axis=axis, keepdims=keepdims, dtype=dtype)

    def var(self, X, axis=None, ddof=0, keepdims=False, dtype=None):
        if X.dtype not in (float, np.float32, np.float64):
            X = X.astype(np.float64)
        return X.var(axis=axis, ddof=ddof, keepdims=keepdims, dtype=dtype)

    def std(self, X, axis=None, ddof=0, keepdims=False, dtype=None):
        if X.dtype not in (float, np.float32, np.float64):
            X = X.astype(np.float64)
        return X.std(axis=axis, ddof=ddof, keepdims=keepdims, dtype=dtype)

    def argmin(self, X, axis=None):
        return self.argop("argmin", X, axis)

    def argmax(self, X, axis=None):
        return self.argop("argmax", X, axis)

    def argop(self, op_name, arr, axis=None):
        """Parity: application.py:525-549 (1-D restriction preserved)."""
        if arr.ndim > 1:
            raise NotImplementedError(
                f"{op_name} currently supports one-dimensional arrays."
            )
        if axis is None:
            axis = 0
        assert axis == 0
        return getattr(arr, op_name)(axis=None).astype(np.int64)

    def where(self, condition: BlockArray, x=None, y=None):
        """Parity: application.py:566-613.

        ``where(c)`` -> per-axis index arrays, resolved ON DEVICE: one
        scalar host sync (the true-count) + a capacity-padded
        ``jnp.nonzero`` — O(result) bytes moved, never O(condition)
        (round-1 fetched the whole condition array to host; the reference
        computes per-block indices worker-side, numpy_compute.py:188-201).
        ``where(c, x, y)`` -> elementwise select, fully on-device.
        """
        if x is not None or y is not None:
            assert x is not None and y is not None
            x = condition.check_or_convert_other(x)
            y = condition.check_or_convert_other(y)
            operands = [condition, x, y]
            args, lshapes, ts = [], [], []
            for o in operands:
                if isinstance(o, BlockArray):
                    args.append(o._data)
                    lshapes.append(o._raw_logical_shape())
                    ts.append(o.is_transposed)
                else:
                    args.append(o)
                    lshapes.append(None)
                    ts.append(False)
            data, lshape = padded.call(
                shape_ops.where3, tuple(args), tuple(lshapes),
                self.backend, transposes=tuple(ts),
            )
            grid = ArrayGrid(
                lshape,
                array_utils.default_block_shape_for(
                    lshape, condition.block_shape
                ),
                np.dtype(data.dtype).name,
            )
            return BlockArray(data, grid, self.backend)
        from nums_tpu.core.ops import masking

        count, index_arrays = masking.device_where(condition)
        result = []
        for arr in index_arrays:
            if count == 0:
                result.append(
                    self.array(np.zeros((0,), np.int64), block_shape=(0,))
                )
                continue
            bs = self.compute_block_shape((count,), np.int64)
            result.append(
                BlockArray.from_jax(
                    arr.astype(np.int64), block_shape=bs,
                    backend=self.backend,
                )
            )
        return tuple(result)

    def map_uop(
        self, op_name, arr, out=None, where=True, args=None, kwargs=None
    ):
        """Parity: application.py:615-654 (out/where unsupported, as there)."""
        if where is not True or out is not None:
            raise NotImplementedError("'out' and 'where' are not supported.")
        del args, kwargs
        return arr.ufunc(op_name)

    def matmul(self, arr_1, arr_2):
        return arr_1 @ arr_2

    def tensordot(self, arr_1, arr_2, axes=2):
        return arr_1.tensordot(arr_2, axes)

    def map_bop(
        self, op_name, arr_1, arr_2, out=None, where=True, args=None,
        kwargs=None,
    ):
        if where is not True or out is not None:
            raise NotImplementedError("'out' and 'where' are not supported.")
        del args, kwargs
        if not isinstance(arr_1, BlockArray):
            arr_2_ba = arr_2 if isinstance(arr_2, BlockArray) else self.scalar(arr_2)
            return arr_2_ba._bop(op_name, arr_1, reverse=True)
        return arr_1._bop(op_name, arr_2)

    def get(self, *arrs):
        if len(arrs) == 1:
            a = arrs[0]
            return a.get() if isinstance(a, BlockArray) else a
        return [
            a.get() if isinstance(a, BlockArray) else a for a in arrs
        ]

    def touch(self, *arrs):
        for a in arrs:
            a.touch()
        return arrs[0] if len(arrs) == 1 else arrs

    def allclose(self, a: BlockArray, b: BlockArray, rtol=1.0e-5, atol=1.0e-8):
        assert a.shape == b.shape
        data, _ = padded.call(
            elementwise.allclose_kernel(float(rtol), float(atol)),
            (a._data, b._data),
            (a._raw_logical_shape(), b._raw_logical_shape()),
            self.backend,
            transposes=(a.is_transposed, b.is_transposed),
        )
        grid = ArrayGrid((), (), np.dtype(data.dtype).name)
        return BlockArray(data, grid, self.backend)

    # ------------------------------------------------------------------
    # Linalg (parity: application.py:769-1045)
    # ------------------------------------------------------------------

    def qr(self, X: BlockArray):
        return self.indirect_tsqr(X)

    def _tsqr_chunk(self, X):
        return linalg.choose_chunk(X.shape[0], X.shape[1])

    def _use_cholqr(self, X=None) -> bool:
        # CholeskyQR needs full column rank (m >= n); wide matrices take
        # the Householder path on any backend.
        if X is not None and X.shape[0] < X.shape[1]:
            return False
        method = settings.tsqr_method
        if method == "cholqr2":
            return True
        if method == "householder":
            return False
        # auto: CholeskyQR2 on any accelerator. It is two grams and two
        # triangular solves, all large matrix products; the Householder
        # tree is a chain of small batched QR factorizations. The CPU
        # keeps Householder, which is robust for any conditioning.
        try:
            import jax

            return jax.default_backend() not in ("cpu",)
        except Exception:  # pragma: no cover
            return False

    def _fused_linalg(self, kernel, *arrays):
        """Run a linalg kernel on logical inputs with pad-stripping (and
        any lazy transpose) fused into the same program."""
        return padded.call(
            kernel,
            tuple(a._data for a in arrays),  # deferred chains stay fused
            tuple(a._raw_logical_shape() for a in arrays),
            self.backend,
            transposes=tuple(a.is_transposed for a in arrays),
        )

    def indirect_tsr(self, X: BlockArray, reshape_output=True) -> BlockArray:
        """R factor via TSQR reduction tree (parity: application.py:772-823)."""
        assert X.ndim == 2
        del reshape_output
        if self._use_cholqr(X):
            r, lshape = self._fused_linalg(linalg.cholqr_r(), X)
        else:
            r, lshape = self._fused_linalg(
                linalg.tsqr_r(self._tsqr_chunk(X)), X
            )
        bs = (min(X.block_shape[1], lshape[0]), X.block_shape[1])
        grid = ArrayGrid(lshape, bs, r.dtype.name)
        return BlockArray(r, grid, self.backend)

    def indirect_tsqr(self, X: BlockArray, reshape_output=True):
        """Q = X R^{-1} (parity: application.py:825-846)."""
        R = self.indirect_tsr(X, reshape_output)
        R_inv = self.inv(R)
        Q = X @ R_inv
        return Q, R

    def direct_tsqr(self, X: BlockArray, reshape_output=True,
                    overwrite_x=False):
        """Parity: application.py:848-933, extended to a recursive tree.

        ``overwrite_x=True`` donates X's buffer to Q (streamed in-place
        CholeskyQR2) — peak HBM ~1x X instead of 2x; X is invalid after.
        """
        assert X.ndim == 2
        del reshape_output
        if overwrite_x:
            # Donated streaming path: peak HBM ~1x X. Uses .data (logical)
            # directly — donation semantics need the raw jitted kernel.
            q, r = linalg.cholqr2_stream()(X.data)
            X._store(q)  # X's old buffer is donated; repoint defensively.
            (q_l, r_l) = (tuple(q.shape), tuple(r.shape))
        elif self._use_cholqr(X):
            (q, r), (q_l, r_l) = self._fused_linalg(linalg.cholqr2(), X)
        else:
            (q, r), (q_l, r_l) = self._fused_linalg(
                linalg.direct_tsqr(self._tsqr_chunk(X)), X
            )
        q_bs = (X.block_shape[0], min(X.block_shape[1], q_l[1]))
        r_bs = (min(X.block_shape[1], r_l[0]), X.block_shape[1])
        Q = BlockArray(
            q, ArrayGrid(q_l, q_bs, q.dtype.name), self.backend
        )
        R = BlockArray(
            r, ArrayGrid(r_l, r_bs, r.dtype.name), self.backend
        )
        return Q, R

    def svd(self, X: BlockArray):
        """Tall-skinny SVD via TSQR (parity: application.py:935-954)."""
        assert X.ndim == 2
        if self._use_cholqr(X):
            (u, s, vt), lshapes = self._fused_linalg(linalg.svd_cholqr(), X)
        else:
            (u, s, vt), lshapes = self._fused_linalg(
                linalg.svd(self._tsqr_chunk(X)), X
            )
        u_l, s_l, vt_l = lshapes
        mk = lambda d, ls, bs: BlockArray(
            d, ArrayGrid(ls, bs, d.dtype.name), self.backend
        )
        n = X.shape[1]
        U = mk(u, u_l, (X.block_shape[0], min(X.block_shape[1], u_l[1])))
        S = mk(s, s_l, (min(X.block_shape[1], n),))
        VT = mk(vt, vt_l, (min(X.block_shape[1], n), min(X.block_shape[1], n)))
        return U, S, VT

    def randomized_svd(self, X: BlockArray, k: int, n_oversamples: int = 10,
                       n_iter: int = 2, seed: int = 0):
        """Randomized top-k SVD (Halko–Martinsson–Tropp 2011, Alg. 4.4/5.1).

        For matrices where BOTH dimensions are large (the full SVD's QR
        panel no longer fits a shard), a Gaussian sketch reduces the
        problem to tall-skinny factorizations of width k+p: range finding
        Y = XΩ, power iterations with QR re-orthonormalization (accuracy
        ∝ σ_{k+1}/σ_k^{2q+1}), then an exact SVD of the (k+p, n)
        projection B = QᵀX. Every step is a big matrix product or the
        framework's TSQR tree — no step materializes more than
        max(m, n)·(k+p). Beyond the reference (its SVD is single-node
        fan-in only, application.py:935-954 there).

        Deterministic for a given seed (counter-based RNG: the sketch is
        identical under any sharding).

        The whole pipeline — sketch GEMM, power iterations with TSQR
        re-orthonormalization, the (ell, n) SVD, back-projection —
        compiles as ONE program (zero per-stage syncs; XLA overlaps the
        GEMMs with the tree reductions).
        """
        assert X.ndim == 2
        m, n = X.shape
        k = int(k)
        assert 1 <= k <= min(m, n)
        ell = min(k + int(n_oversamples), min(m, n))
        omega = self.random_state(seed).normal(
            shape=(n, ell),
            block_shape=(min(X.block_shape[1], n), ell),
            dtype=X.dtype,
        )
        kernel = linalg.randomized_svd(
            k, int(n_iter), self._tsqr_chunk(X)
        )
        (u, s, vt), lshapes = self._fused_linalg(kernel, X, omega)
        u_l, s_l, vt_l = lshapes
        mk = lambda d, ls, bs: BlockArray(
            d, ArrayGrid(ls, bs, d.dtype.name), self.backend
        )
        U = mk(u, u_l, (X.block_shape[0], k))
        S = mk(s, s_l, (k,))
        VT = mk(vt, vt_l, (k, min(X.block_shape[1], n)))
        return U, S, VT

    def inv(self, X: BlockArray) -> BlockArray:
        assert X.ndim == 2 and X.shape[0] == X.shape[1]
        data, _ = self._fused_linalg(linalg.inv, X)
        return BlockArray(data, X.grid.copy(), self.backend)

    def cholesky(self, X: BlockArray) -> BlockArray:
        assert X.ndim == 2 and X.shape[0] == X.shape[1]
        data, _ = self._fused_linalg(linalg.cholesky, X)
        return BlockArray(data, X.grid.copy(), self.backend)

    def posdef_solve(self, A: BlockArray, b: BlockArray) -> BlockArray:
        """Cholesky solve — replaces explicit inv in Newton-type solvers.

        Lazy-aware: in an eager solver loop the Hessian/gradient chains,
        the solve, and the beta update all fuse into ONE program per
        iteration (forced at the convergence check)."""
        data, lshape = self._fused_linalg(linalg.posdef_solve, A, b)
        return BlockArray(
            data,
            ArrayGrid(
                lshape,
                array_utils.default_block_shape_for(lshape, b.block_shape),
                np.dtype(data.dtype).name,
            ),
            self.backend,
        )

    def fast_linear_regression(self, X: BlockArray, y: BlockArray):
        """Parity: application.py:1003-1017; via indirect TSQR."""
        assert X.ndim == 2 and y.ndim == 1
        Q, R = self.indirect_tsqr(X)
        R_inv = self.inv(R)
        return R_inv @ (Q.T @ y)

    def linear_regression(self, X: BlockArray, y: BlockArray):
        """Parity: application.py:1019-1031; via direct TSQR + tri solve."""
        assert X.ndim == 2 and y.ndim == 1
        if self._use_cholqr(X):
            theta, lshape = self._fused_linalg(linalg.lstsq_cholqr(), X, y)
        else:
            theta, lshape = self._fused_linalg(
                linalg.lstsq(self._tsqr_chunk(X)), X, y
            )
        return BlockArray(
            theta,
            ArrayGrid(
                lshape,
                (min(X.block_shape[1], lshape[0]),),
                theta.dtype.name,
            ),
            self.backend,
        )

    def lstsq(self, X: BlockArray, y: BlockArray):
        return self.linear_regression(X, y)

    def ridge_regression(self, X: BlockArray, y: BlockArray, lamb: float):
        """Parity: application.py:1033-1045."""
        assert X.ndim == 2 and y.ndim == 1 and lamb >= 0
        R = self.indirect_tsr(X)
        n = R.shape[0]
        lamb_eye = self.eye_k(
            (n, n), (R.block_shape[0], R.block_shape[0]), dtype=X.dtype
        ) * lamb
        return self.inv(lamb_eye + R.T @ R) @ (X.T @ y)

    # ------------------------------------------------------------------
    # I/O orchestration (parity: application.py:154-290) — delegates to
    # FileSystem; see nums_tpu/core/io/filesystem.py.
    # ------------------------------------------------------------------

    def write_fs(self, ba: BlockArray, filename: str, replicas: int = None):
        return self.fs.write_fs(ba, filename, replicas=replicas)

    def read_fs(self, filename: str, verify: bool = False) -> BlockArray:
        return self.fs.read_fs(filename, verify=verify)

    def verify_fs(self, filename: str, repair: bool = False) -> dict:
        return self.fs.verify_fs(filename, repair=repair)

    # ------------------------------------------------------------------
    # Out-of-core (DiskArray) streaming ops: datasets larger than HBM
    # stream row panels through the device with donated accumulators.
    # The reference's analogue is Ray plasma's implicit disk spilling.
    # ------------------------------------------------------------------

    def open_fs(self, filename: str, verify: bool = False):
        """View an existing ``write_fs`` checkpoint as a DiskArray.
        ``verify=True`` CRC-checks every block on every panel read."""
        from nums_tpu.core.array.diskarray import DiskArray
        from nums_tpu.core.io.filesystem import _fs_path

        return DiskArray(_fs_path(filename), self.fs, verify=verify)

    def spill(self, ba: BlockArray, filename: str, replicas: int = None):
        """Write ``ba`` to disk and return the DiskArray view."""
        self.write_fs(ba, filename, replicas=replicas)
        return self.open_fs(filename)

    def _ooc_put(self, panel, fill=0.0):
        return ooc_put(self.backend, panel, fill=fill)

    def _ooc_accumulate(self, X, init, update, fill=0.0):
        """Fold ``update(acc, panel_on_device)`` over X's row panels;
        under a mesh each panel is row-sharded across every device (the
        per-panel GEMM/reduction partitions with a psum). COLLECTIVE
        under multi-controller: the accumulator is mesh-replicated and
        each process streams only its addressable panel rows."""
        acc = ooc_accumulator(self.backend, init)
        for _, panel in ooc_panels(X):
            p, _ = self._ooc_put(panel, fill=fill)
            acc = update(acc, p)
        return acc

    def gram_ooc(self, X, dtype=None) -> BlockArray:
        """XᵀX for a DiskArray X in ONE streamed pass (HBM: one panel
        + the (d, d) accumulator)."""
        import jax.numpy as jnp

        from nums_tpu.core.ops import streaming

        assert X.ndim == 2
        d = X.shape[1]
        # jnp round-trip resolves dtype coercion (f64→f32 when x64 is off).
        dtype = jnp.asarray(np.zeros(0, dtype or X.dtype)).dtype
        upd = streaming.gram_update()
        G = self._ooc_accumulate(
            X, jnp.zeros((d, d), dtype),
            lambda acc, p: upd(acc, p.astype(dtype)),
        )
        return BlockArray.from_jax(G, backend=self.backend)

    def _reduce0_ooc(self, X, op):
        import jax.numpy as jnp

        from nums_tpu.core.ops import streaming

        d = X.shape[1] if X.ndim == 2 else 1
        dtype = jnp.asarray(np.zeros(0, X.dtype)).dtype
        if np.issubdtype(np.dtype(dtype), np.integer):
            # np.full would cast +-inf to INT_MIN (an ABSORBING element
            # for min) — use the identity bounds of the CANONICALIZED
            # dtype (int64 → int32 when x64 is off: int64's max would
            # overflow/wrap in the accumulator).
            info = np.iinfo(np.dtype(dtype))
            init_val = {"sum": 0, "min": info.max, "max": info.min}[op]
        else:
            init_val = {"sum": 0.0, "min": np.inf, "max": -np.inf}[op]
        upd = streaming.reduce0_update(op)
        shape = (d,) if X.ndim == 2 else ()
        acc = self._ooc_accumulate(
            X, jnp.full(shape, init_val, dtype),
            lambda a, p: upd(a, p.astype(dtype)),
            # Pad rows must be the op's identity element.
            fill=init_val,
        )
        return BlockArray.from_jax(acc, backend=self.backend)

    def sum_ooc(self, X) -> BlockArray:
        """Column sums (axis=0) of a DiskArray, one streamed pass."""
        return self._reduce0_ooc(X, "sum")

    def min_ooc(self, X) -> BlockArray:
        return self._reduce0_ooc(X, "min")

    def max_ooc(self, X) -> BlockArray:
        return self._reduce0_ooc(X, "max")

    def mean_ooc(self, X) -> BlockArray:
        return self.sum_ooc(X) / float(X.shape[0])

    def tsqr_r_ooc(self, X) -> BlockArray:
        """R factor of a DiskArray via streamed Householder combine
        R ← qr_r([R; panel]) — robust for any conditioning; peak HBM is
        one panel + (d, d)."""
        import jax.numpy as jnp

        from nums_tpu.core.ops import streaming

        assert X.ndim == 2
        d = X.shape[1]
        dtype = jnp.asarray(np.zeros(0, X.dtype)).dtype
        chunk = linalg.choose_chunk(X.shape[0], d)
        upd = streaming.tsqr_r_update(chunk)
        R = self._ooc_accumulate(
            X, jnp.zeros((d, d), dtype),
            lambda acc, p: upd(acc, p.astype(dtype)),
        )
        return BlockArray.from_jax(R, backend=self.backend)

    def linear_regression_ooc(self, X, y, lamb: float = 0.0) -> BlockArray:
        """(Ridge) regression on a DiskArray via streamed normal
        equations: one pass accumulates (XᵀX, Xᵀy); one (d, d) solve."""
        import jax.numpy as jnp

        from nums_tpu.core.ops import streaming

        assert X.ndim == 2
        d = X.shape[1]
        dtype = jnp.asarray(np.zeros(0, X.dtype)).dtype
        y_at = _ooc_y_getter(X, y)
        upd = streaming.normal_eq_update()
        G = ooc_accumulator(self.backend, jnp.zeros((d, d), dtype))
        b = ooc_accumulator(self.backend, jnp.zeros((d,), dtype))
        for start, panel in ooc_panels(X):
            p, _ = self._ooc_put(panel)
            yp, _ = self._ooc_put(y_at(start, panel.shape[0]))
            G, b = upd(G, b, p.astype(dtype), yp.astype(dtype))
        if lamb:
            G = G + lamb * jnp.eye(d, dtype=dtype)
        theta = linalg.posdef_solve(G, b)
        return BlockArray.from_jax(theta, backend=self.backend)

    def delete_fs(self, filename: str):
        return self.fs.delete_fs(filename)

    def write_s3(self, ba: BlockArray, filename: str):
        return self.fs.write_s3(ba, filename)

    def read_s3(self, filename: str) -> BlockArray:
        return self.fs.read_s3(filename)

    def delete_s3(self, filename: str):
        return self.fs.delete_s3(filename)

    def read_csv(
        self, filename, dtype=float, delimiter=",", has_header=False,
        num_workers=None,
    ):
        arr = self.fs.read_csv(
            filename, dtype=dtype, delimiter=delimiter, has_header=has_header,
            num_workers=num_workers,
        )
        block_shape = self.get_block_shape(arr.shape, arr.dtype)
        if block_shape != arr.block_shape:
            arr = arr.reshape(block_shape=block_shape)
        return arr

    def loadtxt(
        self, fname, dtype=float, comments="# ", delimiter=" ",
        converters=None, skiprows=0, usecols=None, unpack=False, ndmin=0,
        encoding="bytes", max_rows=None, num_workers=None,
    ) -> BlockArray:
        arr = self.fs.loadtxt(
            fname, dtype=dtype, comments=comments, delimiter=delimiter,
            converters=converters, skiprows=skiprows, usecols=usecols,
            unpack=unpack, ndmin=ndmin, encoding=encoding, max_rows=max_rows,
            num_workers=num_workers,
        )
        block_shape = self.get_block_shape(arr.shape, arr.dtype)
        if block_shape != arr.block_shape:
            arr = arr.reshape(block_shape=block_shape)
        return arr

    @property
    def random(self) -> NumsRandomState:
        if self._random is None:
            self._random = self.random_state()
        return self._random

    def random_state(self, seed=None):
        return NumsRandomState(self.backend, seed)
