"""DataFrame → BlockArray conversion (pandas + Modin).

Parity target: ``nums/experimental/nums_modin.py:8-58``. The reference
zero-copies Modin's Ray partitions via ``from_oid`` and concatenates;
without a shared object store the equivalent here streams partitions
host-side into the sharded device array PARTITION-AT-A-TIME (peak host
memory O(partition), not O(frame)) via the same region-callback restore
used by checkpoint reads.

``from_pandas`` is the fully-tested core (pandas ships in this image);
``from_modin`` extracts Modin's row partitions when modin is importable
and otherwise raises (import-safe optional dependency, as upstream).
"""

import numpy as np

from nums_tpu.core.application_manager import instance as _instance

try:  # pragma: no cover - exercised only where modin is installed
    import modin.pandas as _mpd

    _HAS_MODIN = True
except Exception:  # pragma: no cover
    _mpd = None
    _HAS_MODIN = False


def _from_row_parts(parts, dtype=None, block_shape=None):
    """Row-partitioned list of 2-D np arrays → sharded BlockArray.

    Each device shard is assembled from just the partitions it overlaps
    (``make_array_from_callback``), so no full-frame host copy exists.
    """
    import jax

    from nums_tpu.core.array.blockarray import BlockArray
    from nums_tpu.core.grid import ArrayGrid

    app = _instance()
    parts = [np.asarray(p) for p in parts]
    if dtype is None:
        dtype = np.result_type(*[p.dtype for p in parts])
        if dtype == object:
            dtype = np.float64
    rows = [p.shape[0] for p in parts]
    n, d = sum(rows), parts[0].shape[1]
    starts = np.concatenate([[0], np.cumsum(rows)])
    if block_shape is None:
        block_shape = app.get_block_shape((n, d), dtype)
    grid = ArrayGrid((n, d), block_shape, np.dtype(dtype).name)
    sharding = app.backend.sharding_for_grid(grid)
    pshape = app.backend.physical_shape(grid.shape, grid.grid_shape)

    # Regions are PHYSICAL coordinates (pad-and-mask can pad axis 1
    # too); allocate at physical width so a shard's column slice never
    # clamps — mirrors read_fs's region loader.
    pcols = pshape[1] if len(pshape) > 1 else d

    def load_region(index):
        r = index[0]
        r0 = 0 if r.start is None else r.start
        r1 = pshape[0] if r.stop is None else r.stop
        out = np.zeros((r1 - r0, pcols), dtype=dtype)
        for p, s0, s1 in zip(parts, starts[:-1], starts[1:]):
            lo, hi = max(r0, s0), min(r1, s1)
            if lo >= hi:
                continue
            out[lo - r0:hi - r0, :d] = p[lo - s0:hi - s0]
        return out[:, index[1]] if len(index) > 1 else out[:, :d]

    if sharding is None:
        data = app.backend.device_put(
            load_region((slice(0, n), slice(0, d))), grid
        )
        return BlockArray(data, grid, app.backend)
    data = jax.make_array_from_callback(pshape, sharding, load_region)
    return BlockArray(data, grid, app.backend)


def from_pandas(df, dtype=None):
    """pandas DataFrame (or Series) → BlockArray."""
    import pandas as pd

    if isinstance(df, pd.Series):
        df = df.to_frame()
    assert isinstance(df, pd.DataFrame), type(df)
    arr = df.to_numpy()
    if arr.dtype == object and dtype is None:
        dtype = np.float64
    if dtype is not None:
        arr = arr.astype(dtype)
    # A single frame is one "partition"; the region loader shards it.
    return _from_row_parts([arr], dtype=arr.dtype)


def from_modin(df):
    if not _HAS_MODIN:
        raise RuntimeError(
            "modin is not available in this environment; install it to use "
            "nums_tpu.experimental.nums_modin (from_pandas works without)."
        )
    # Extract Modin's row partitions so conversion streams per-partition
    # (the reference's from_oid-per-partition, nums_modin.py:8-58). The
    # documented API for this is unwrap_partitions.
    try:
        from modin.distributed.dataframe.pandas import unwrap_partitions

        row_parts = unwrap_partitions(df, axis=0)
        import ray

        parts = [
            np.asarray(
                (ray.get(p) if hasattr(p, "task_id") or hasattr(p, "hex")
                 else p).to_numpy()
            )
            for p in row_parts
        ]
        if parts:
            return _from_row_parts(parts)
    except Exception:
        pass
    # Robust fallback across modin versions: materialize the frame.
    return from_pandas(df._to_pandas() if hasattr(df, "_to_pandas") else df)
