"""Out-of-core arrays: grid-on-disk with streaming device ops.

The reference gets larger-than-memory aggregates implicitly — Ray's
plasma object store spills blocks to disk and tasks fault them back in.
The equivalent here is EXPLICIT streaming: a ``DiskArray`` is the
``write_fs`` checkpoint format (one .npy per grid block + meta.pkl,
replication/CRC compatible) viewed as an array, and the hot ops
(gram, normal equations, row reductions, TSQR-R, GLM training) stream
row panels host→HBM with a prefetch thread overlapping disk IO against
device compute. Peak HBM is O(panel + accumulator), so one device
processes datasets far beyond its memory — configurations the reference
needed an 8-GPU cluster for (BASELINE.md N≥5M rows).

Usage::

    da = app.spill(ba, "bigX")          # BlockArray -> disk
    da = app.open_fs("bigX")            # open an existing checkpoint
    G = app.gram_ooc(da)                # X^T X, one streamed pass
    model.fit(da, y)                    # GLMs train out-of-core
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from nums_tpu.core.grid import ArrayGrid


class PanelRef:
    """Lazy handle to one row panel of a DiskArray.

    Under multi-controller SPMD each process must feed the device ONLY
    the rows its addressable shards cover — loading every full panel on
    every process would multiply disk traffic by the process count. A
    PanelRef exposes the panel's logical shape without loading anything
    and serves arbitrary row ranges via memory-mapped block reads
    (``np.load(mmap_mode='r')`` touches only the pages of the requested
    rows), so P processes stream 1/P of each panel. This is the
    streaming analogue of the reference's cluster-wide object store
    (Ray plasma spans nodes, systems.py:156-191 there): aggregate IO
    bandwidth scales with the process count.
    """

    def __init__(self, da, panel_index: int, nrows: int):
        self._da = da
        self._i = int(panel_index)
        self.shape = (
            (nrows,) if da.ndim == 1 else (nrows, da.shape[1])
        )
        self.dtype = da.dtype

    def full(self) -> np.ndarray:
        """The whole panel (replica/CRC-guarded load)."""
        return self._da.row_panel(self._i)

    def load(self, lo: int, hi: int) -> np.ndarray:
        """Host rows [lo, hi) of this panel (panel-relative indices).

        Served from mmap'd primaries when possible; any unreadable
        block falls back to the replica/CRC-checked full-block loader.
        """
        assert 0 <= lo <= hi <= self.shape[0], (lo, hi, self.shape)
        from nums_tpu.core.io.filesystem import _block_fname

        da = self._da
        if lo == 0 and hi == self.shape[0]:
            return self.full()
        if da.ndim == 1:
            blk = da._mmap_block(_block_fname((self._i,)))
            return np.ascontiguousarray(blk[lo:hi])
        cols = [
            np.ascontiguousarray(
                da._mmap_block(_block_fname((self._i, j)))[lo:hi]
            )
            for j in range(da.grid.grid_shape[1])
        ]
        return cols[0] if len(cols) == 1 else np.concatenate(cols, axis=1)


class DiskArray:
    """A 2-D (or 1-D) array resident on disk as grid blocks.

    Immutable view over a ``write_fs`` directory; all compute happens in
    the streaming ops (``ArrayApplication.*_ooc``), which consume
    ``iter_row_panels``.
    """

    def __init__(self, path: str, fs, verify: bool = False):
        self._path = path
        self._fs = fs
        meta = fs.read_meta_fs(path)
        self.grid = ArrayGrid.from_meta(meta["grid"])
        assert len(self.grid.shape) in (1, 2), (
            "DiskArray supports 1-D/2-D arrays", self.grid.shape
        )
        # Same resilience semantics as read_fs: a missing/unreadable
        # primary block fails over to replica copies CRC-guarded;
        # verify=True additionally CRC-checks primaries on every read.
        self._checks = meta.get("checksums")
        self._verify = bool(verify)

    def _mmap_block(self, fname: str) -> np.ndarray:
        """Memory-mapped view of one primary block (row-range reads touch
        only the needed pages). Falls back to the replica/CRC-guarded
        full load when the primary is unreadable."""
        primary = os.path.join(self._path, fname)
        if not self._verify:
            try:
                return np.load(primary, mmap_mode="r")
            except Exception:
                pass
        return self._load_block(fname)

    def _load_block(self, fname: str) -> np.ndarray:
        from nums_tpu.core.io.filesystem import (
            FileSystem, _existing_replicas,
        )

        primary = os.path.join(self._path, fname)
        if not self._verify:
            try:
                return np.load(primary)
            except Exception:
                pass  # fail over (CRC-guarded) to replica copies
        return FileSystem._load_block_checked(
            primary, _existing_replicas(self._path), self._checks
        )

    @property
    def path(self):
        return self._path

    @property
    def backend(self):
        """The owning backend (sharded streaming puts resolve through
        this — one source of truth for every OOC consumer)."""
        return self._fs.backend

    @property
    def shape(self):
        return self.grid.shape

    @property
    def dtype(self):
        return np.dtype(self.grid.dtype)

    @property
    def ndim(self):
        return len(self.grid.shape)

    @property
    def nbytes(self):
        return int(np.prod(self.shape)) * self.dtype.itemsize

    def row_panel(self, i: int) -> np.ndarray:
        """Row stripe i assembled across column blocks (host memory)."""
        from nums_tpu.core.io.filesystem import _block_fname

        grid = self.grid
        if self.ndim == 1:
            return self._load_block(_block_fname((i,)))
        cols = [
            self._load_block(_block_fname((i, j)))
            for j in range(grid.grid_shape[1])
        ]
        return cols[0] if len(cols) == 1 else np.concatenate(cols, axis=1)

    @property
    def num_row_panels(self):
        return self.grid.grid_shape[0]

    def iter_row_panels(self, prefetch: bool = True):
        """Yield (start_row, panel) host arrays in row order.

        With ``prefetch`` the next stripe loads on a worker thread while
        the caller computes on the current one (NumPy IO releases the
        GIL), overlapping disk against device time.
        """
        n_panels = self.num_row_panels
        starts = [s for s, _ in self.grid.grid_slices[0]]
        if not prefetch or n_panels <= 1:
            for i in range(n_panels):
                yield starts[i], self.row_panel(i)
            return
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(self.row_panel, 0)
            for i in range(n_panels):
                panel = fut.result()
                if i + 1 < n_panels:
                    fut = ex.submit(self.row_panel, i + 1)
                yield starts[i], panel

    def iter_panel_refs(self):
        """Yield (start_row, PanelRef) in row order — the lazy analogue
        of ``iter_row_panels`` for multi-controller streaming: nothing
        is read until a row range is requested, so each process pulls
        only its addressable rows."""
        starts = [s for s, _ in self.grid.grid_slices[0]]
        stops = [e for _, e in self.grid.grid_slices[0]]
        for i in range(self.num_row_panels):
            yield starts[i], PanelRef(self, i, stops[i] - starts[i])

    @classmethod
    def from_panels(cls, path: str, fs, panels, shape, dtype,
                    block_rows: int):
        """Write a DiskArray from a stream of row panels.

        ``panels`` yields host arrays whose rows concatenate to
        ``shape``; each panel must span a whole number of row blocks
        (``block_rows`` rows per block, last block ragged). Uses the
        same crash-consistent publish as ``write_fs`` (tmp dir, CRC
        checksums, meta.pkl last + fsync, atomic rename with an .old-
        backup in the overwrite window) so the result is a first-class
        checkpoint. Peak host memory is one panel.

        COLLECTIVE under multi-controller: every process must call this
        and iterate the SAME panel stream (producers may contain
        collectives — e.g. predict_ooc's device kernels — so lockstep
        iteration is required); only process 0 writes to the shared FS,
        the rest drain the stream and open the result after a barrier.
        """
        from nums_tpu.core import multiprocess as _mp
        from nums_tpu.core.io.filesystem import _fs_path

        tag = f"DiskArray.from_panels:{_fs_path(path)}"
        marker = f"{_fs_path(path)}.ingest-failed"
        if _mp.is_multiprocess() and _mp.process_index() != 0:
            try:
                for _ in panels:  # lockstep with process 0's collectives
                    pass
            except BaseException:
                # Reach the barrier FIRST (process 0 is waiting there),
                # then surface this process's own producer failure.
                _mp.barrier(tag)
                raise
            _mp.await_published(tag, marker,
                                f"DiskArray.from_panels({path!r})")
            return cls(_fs_path(path), fs)

        path = _fs_path(path)  # relative names live under data_dir
        if _mp.is_multiprocess():
            # Marker lifecycle + release-barrier ordering live in
            # multiprocess.publishing; the site-specific part is the
            # failure drain below.
            with _mp.publishing(tag, marker):
                try:
                    return cls._write_panels_p0(
                        path, fs, panels, shape, dtype, block_rows
                    )
                except BaseException:
                    # A WRITE failure (disk full, bad panel) abandons
                    # the stream mid-way — drain the rest so producers
                    # that contain collectives stay matched with the
                    # peers' lockstep iteration (else they hang in the
                    # producer, never reaching the release barrier). A
                    # producer that itself raised is already closed;
                    # the drain is a no-op.
                    try:
                        for _ in panels:
                            pass
                    except BaseException:  # noqa: BLE001 - keep original
                        pass
                    raise
        return cls._write_panels_p0(path, fs, panels, shape, dtype,
                                    block_rows)

    @classmethod
    def _write_panels_p0(cls, path, fs, panels, shape, dtype,
                         block_rows):
        import pickle
        import shutil

        from nums_tpu.core.io.filesystem import _block_crc, _block_fname

        shape = tuple(int(s) for s in shape)
        assert len(shape) in (1, 2), shape
        block_shape = (
            (block_rows,) if len(shape) == 1
            else (block_rows, shape[1])
        )
        grid = ArrayGrid(shape, block_shape, np.dtype(dtype).name)
        tmp = f"{path}.tmp-{os.getpid()}"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        checksums = {}
        row = 0
        block_i = 0
        for panel in panels:
            panel = np.asarray(panel, dtype=dtype)
            assert panel.shape[1:] == shape[1:], (panel.shape, shape)
            off = 0
            while off < panel.shape[0]:
                blk = panel[off:off + block_rows]
                assert blk.shape[0] == min(
                    block_rows, shape[0] - row
                ), "panels must align to block_rows boundaries"
                entry = (block_i,) if len(shape) == 1 else (block_i, 0)
                fname = _block_fname(entry)
                np.save(os.path.join(tmp, fname), blk)
                checksums[fname] = _block_crc(blk)
                off += blk.shape[0]
                row += blk.shape[0]
                block_i += 1
        assert row == shape[0], (row, shape)
        meta = {"grid": grid.to_meta(), "checksums": checksums}
        from nums_tpu.core import settings
        from nums_tpu.core.io.filesystem import _fsync_tree

        with open(os.path.join(tmp, "meta.pkl"), "wb") as f:
            f.write(pickle.dumps(meta))
            f.flush()
            if settings.checkpoint_fsync:
                os.fsync(f.fileno())
        _fsync_tree(tmp)
        # Same publish discipline as write_fs: old version becomes an
        # .old- backup (recoverable by readers if we crash mid-window),
        # never rmtree'd before the new version is in place.
        if os.path.isdir(path):
            trash = f"{path}.old-{os.getpid()}"
            shutil.rmtree(trash, ignore_errors=True)
            os.rename(path, trash)
            os.rename(tmp, path)
            shutil.rmtree(trash, ignore_errors=True)
        else:
            os.rename(tmp, path)
        return cls(path, fs)

    def to_block_array(self, block_shape=None):
        """Materialize fully into (sharded) device memory."""
        out = self._fs.read_fs(self._path)
        if block_shape is not None and block_shape != out.block_shape:
            out = out.reshape(out.shape, block_shape=block_shape)
        return out

    def __repr__(self):
        return (
            f"DiskArray(shape={self.shape}, dtype={self.dtype.name}, "
            f"panels={self.num_row_panels}, path={self._path!r})"
        )
