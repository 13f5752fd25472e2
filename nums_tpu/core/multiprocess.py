"""Multi-controller (multi-host) SPMD support.

The reference's cluster story is Ray tasks spanning nodes
(``nums/core/systems/systems.py:145-249``; node discovery at
``schedulers.py:74-106``). The equivalent here is jax
multi-controller SPMD: every host runs the SAME program against a
coordinator (``jax.distributed.initialize``), ``jax.devices()`` spans
all hosts, and one global ``Mesh`` shards every array across them —
no task RPC layer exists because the program IS the schedule.

This module concentrates the process-awareness the rest of the stack
needs:

- ``initialize()`` — wires ``jax.distributed`` from NUMS_TPU_* env
  (called by ``nums_tpu.init()``; a no-op when already connected or
  single-process).
- ``allgather_to_host(arr)`` — the multi-controller replacement for
  ``jax.device_get`` of a global array: every process participates in
  one collective and receives the full value (``BlockArray.get``).
- ``host_values_equal`` / ``barrier`` — checkpoint coordination.

PROGRAMMING MODEL (same contract as jax itself): all processes execute
the same operations in the same order. Methods documented as collective
(``get``, ``write_fs``, ``read_csv``, any computation) must be called
on every process; per-process divergence is only inside them (each
process touches only its addressable shards).
"""

import contextlib
import os

import numpy as np

import jax


def process_count() -> int:
    try:
        return jax.process_count()
    except Exception:  # distributed runtime not initialized
        return 1


def process_index() -> int:
    try:
        return jax.process_index()
    except Exception:
        return 0


def is_multiprocess() -> bool:
    return process_count() > 1


def initialize():
    """Connect this process to the jax distributed runtime when the
    NUMS_TPU_COORDINATOR / NUMS_TPU_NUM_PROCESSES / NUMS_TPU_PROCESS_ID
    env triple is present (the explicit-config path; a user call to
    plain ``jax.distributed.initialize()`` before ``nums_tpu.init()``
    also works and is detected). Idempotent."""
    coord = os.environ.get("NUMS_TPU_COORDINATOR")
    if not coord:
        return False
    # Probe ONLY the distributed client here: jax.process_count()
    # (is_multiprocess) would itself initialize the XLA backend, which
    # locks jax.distributed.initialize out.
    if _already_initialized():
        return True
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["NUMS_TPU_NUM_PROCESSES"]),
        process_id=int(os.environ["NUMS_TPU_PROCESS_ID"]),
    )
    return True


def _already_initialized() -> bool:
    try:
        from jax._src import distributed

        return distributed.global_state.client is not None
    except Exception:
        return False


def allgather_to_host(jax_array) -> np.ndarray:
    """Full global value on EVERY host (collective).

    ``jax.device_get`` on a multi-host global array raises (shards on
    other hosts are not addressable); the SPMD answer is one
    all-gather in which every process participates.
    """
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(jax_array, tiled=True)
    )


def barrier(name: str):
    """Block until every process reaches this point (collective)."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def checked_barrier(name: str, ok: bool, what: str):
    """Barrier that also AGREES ON SUCCESS: every process contributes
    its ``ok`` flag via one tiny all-gather; if any process failed,
    every OTHER process raises after the barrier (the failing process
    re-raises its own exception at the call site).

    This replaces the bare-barrier pattern in collective writers where
    one process's exception would strand its peers in
    ``sync_global_devices`` at the next collective. Unlike the
    marker-file protocol (:func:`publishing`), it needs no shared
    filesystem — it works for object-store writers too. Call pattern::

        ok, err = True, None
        try:
            ...   # this process's slice of the stage
        except BaseException as e:
            ok, err = False, e
        checked_barrier("write:blocks", ok, "write blocks")
        if err is not None:
            raise err
    """
    from jax.experimental import multihost_utils

    flags = np.asarray(multihost_utils.process_allgather(
        np.array([0 if ok else 1], dtype=np.int32)
    ))
    if int(flags.sum()) != 0:
        if ok:
            raise RuntimeError(
                f"{what} failed on a peer process at stage {name!r} "
                "(see its traceback)"
            )


@contextlib.contextmanager
def publishing(tag: str, marker: str):
    """Process-0 side of the collective publish protocol.

    One process streams a long write to the shared FS while its peers
    wait at a barrier; a mid-write failure (disk full, kernel error)
    must not leave the peers hanging in ``sync_global_devices``. The
    ordering is subtle and MUST be shared, not hand-rolled per site
    (read_parquet / write_parquet / DiskArray.from_panels all use it):

    1. consume any stale marker from a PRIOR failed run (else a retry
       succeeds here but every peer raises on the old marker —
       divergent control flow that hangs the next collective);
    2. on failure, drop the marker BEFORE the barrier releases the
       peers, so they raise instead of opening a torn file;
    3. the barrier runs in a finally — success or failure, the peers
       are always released.

    Stream-drain semantics (keeping peers' lockstep iteration matched
    when the producer contains collectives) genuinely differ per site
    and stay with the caller.
    """
    try:
        os.remove(marker)
    except OSError:
        pass
    try:
        yield
    except BaseException:
        try:
            open(marker, "w").close()
        except OSError:
            pass
        raise
    finally:
        barrier(tag)


def await_published(tag: str, marker: str, what: str):
    """Peer side of :func:`publishing`: wait for process 0's release
    barrier, then turn its failure marker into an error instead of
    treating a torn file as complete."""
    barrier(tag)
    if os.path.exists(marker):
        raise RuntimeError(f"{what} failed on process 0 "
                           "(see its traceback)")


def owned_regions(jax_array):
    """(index, np.ndarray) for each distinct addressable shard region,
    deduplicated across replica devices — the per-process slice of a
    global array, with replicated regions claimed by exactly one
    process (the one owning the lowest-id replica device) so
    checkpoint writers never double-write a block."""
    shape = tuple(jax_array.shape)

    def key_of(index):
        return tuple(
            (s.start or 0, s.stop if s.stop is not None else dim)
            for s, dim in zip(index, shape)
        )

    my_proc = process_index()
    # Deduplicate by region across ALL devices (addressable or not):
    # the owner of a region is the process of the lowest-id device
    # holding it.
    owner = {}
    for shard in jax_array.global_shards:
        dev = shard.device
        prev = owner.get(key_of(shard.index))
        if prev is None or (dev.process_index, dev.id) < prev:
            owner[key_of(shard.index)] = (dev.process_index, dev.id)
    seen = set()
    out = []
    for shard in jax_array.addressable_shards:
        key = key_of(shard.index)
        if key in seen:
            continue
        seen.add(key)
        if owner[key][0] != my_proc:
            continue
        out.append((shard.index, np.asarray(shard.data)))
    return out
