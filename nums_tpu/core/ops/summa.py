"""Explicit SUMMA GEMM over a 2-D device mesh (shard_map + collectives).

The reference's blocked tensordot is a driver-side SUMMA without the
broadcast optimization (one Ray task per (i,j,k) block product and a
sequential add chain, blockarray.py:442-473). XLA's SPMD partitioner
already produces a good SUMMA automatically for sharded `dot_general`
(that is the default path); this module is the HAND-SCHEDULED version —
explicit all-gathers of A's row panels / B's column panels and a
local GEMM per shard — for when the auto-partitioner's choice is
wrong, and as the substrate for future ppermute-pipelined (memory-bound)
variants.

C[i, j] = Σ_k A[i, k] B[k, j] with A sharded (m0, m1), B sharded (m0, m1),
C sharded (m0, m1): each (i, j) shard needs A's full row-block-row i
(all-gather over m1) and B's full column-block-col j (all-gather over m0).
"""

import functools


import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

# ---------------------------------------------------------------------------
# Auto-dispatch cost model (NUMS_TPU_COLLECTIVE_MATMUL=auto).
#
# The reference auto-routes transfers per-operand at dispatch time
# (gpu_systems.py:556-606 there); the analogue here is choosing between
# XLA's auto-SPMD schedule and the hand-scheduled kernels below. Each
# constant is named and isolated so a tuning round on real links can
# recalibrate them independently from measured sweeps
# (scripts/benchmark_collective.py writes the per-schedule columns).
# ---------------------------------------------------------------------------

# TN replaces XLA's gather+GEMM with a local GEMM + ONE reduce-scatter
# (transpose fused into the contraction) — profitable whenever the
# per-device (m, n) partial product stays comfortably in HBM.
AUTO_TN_MAX_PARTIAL_BYTES = 256 * 2**20
# NT all-gathers the full Braw (n, K) panel onto every device; past this
# budget XLA's contracting-dim sharding avoids materializing the panel.
AUTO_NT_MAX_GATHER_BYTES = 256 * 2**20
# NN: XLA's single fused all-gather wins while the gathered B panel is
# small; past this per-device budget prefer a streamed schedule (ring
# circulates one B shard; SUMMA gathers 1/p-size row/col panels).
AUTO_NN_GATHER_BUDGET_BYTES = 256 * 2**20
# Ring amortizes one ppermute hop per step against a (m/p, k/p)·(k/p, n)
# GEMM; below this per-step k-panel the hop latency dominates.
AUTO_RING_MIN_K_PANEL = 256

#: Test/debug hook — the schedule BlockArray._collective_matmul last
#: dispatched: "tn" | "nt" | "ring" | "summa" | "xla" (fallback) | None
#: (never dispatched). Written on every collective-eligible matmul.
LAST_DISPATCH = None


def choose_schedule(mesh_backend, ta, tb, a_phys, b_phys, itemsize=4):
    """Pick a hand-scheduled kernel for ``auto`` mode, or None for XLA.

    ``ta``/``tb``: whether A/B are lazily transposed (physical buffers
    are the untransposed raws). ``a_phys``/``b_phys``: PHYSICAL (at-rest
    padded) buffer shapes. Returns "tn" | "nt" | "ring" | "summa" |
    None. Pure function of (mesh, shapes) so dispatch tests can assert
    the choice per shape without running the kernels.
    """
    if mesh_backend.mesh is None:
        return None
    if ta and tb:
        # C = Aᵀ·Bᵀ = (Braw @ Araw)ᵀ — NN schedule on the swapped raws.
        inner = choose_schedule(
            mesh_backend, False, False, b_phys, a_phys, itemsize
        )
        return inner if inner in ("ring", "summa") else None
    if ta:
        # x.T @ x headline pattern: one reduce-scatter, no transpose.
        if not tn_supported(mesh_backend, a_phys, b_phys):
            return None
        m, n = a_phys[1], b_phys[1]
        if m * n * itemsize <= AUTO_TN_MAX_PARTIAL_BYTES:
            return "tn"
        return None
    if tb:
        if not nt_supported(mesh_backend, a_phys, b_phys):
            return None
        n, k = b_phys
        if n * k * itemsize <= AUTO_NT_MAX_GATHER_BYTES:
            return "nt"
        return None
    # NN: hand-schedule only when XLA's full-panel gather would blow the
    # per-device budget (its fused all-gather+GEMM wins below it).
    k, n = b_phys
    if k * n * itemsize <= AUTO_NN_GATHER_BUDGET_BYTES:
        return None
    ms = mesh_backend.device_grid.mesh_shape
    if len(ms) > 1 and ms[1] > 1 and supported(mesh_backend, a_phys, b_phys):
        return "summa"
    if (
        ring_supported(mesh_backend, a_phys, b_phys)
        and a_phys[1] // ms[0] >= AUTO_RING_MIN_K_PANEL
    ):
        return "ring"
    return None


def _shard_map(fn, mesh, in_specs, out_specs):
    try:
        return jax.shard_map(
            fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs
        )
    except AttributeError:  # older jax
        from jax.experimental.shard_map import shard_map

        return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


@functools.lru_cache(maxsize=None)
def summa_matmul(mesh_backend, precision=None):
    """C = A @ B with explicit collectives over the backend's 2-D mesh.

    Requires A (m, k), B (k, n) with m, k, n divisible by the respective
    mesh axes. Returns a jitted callable.
    """
    mesh = mesh_backend.mesh
    ax0, ax1 = mesh_backend.device_grid.axis_names[:2]

    def local(a_blk, b_blk):
        # a_blk: (m/p0, k/p1) ; b_blk: (k/p0, n/p1)
        a_row = jax.lax.all_gather(
            a_blk, ax1, axis=1, tiled=True
        )  # (m/p0, k)
        b_col = jax.lax.all_gather(
            b_blk, ax0, axis=0, tiled=True
        )  # (k, n/p1)
        return jnp.matmul(a_row, b_col, precision=precision)

    fn = _shard_map(
        local,
        mesh,
        in_specs=(P(ax0, ax1), P(ax0, ax1)),
        out_specs=P(ax0, ax1),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def ring_matmul(mesh_backend, precision=None):
    """C = A @ B via a double-buffered 1-D ring over mesh axis m0.

    A is row-sharded (m/p, k); B is k-sharded (k/p, n); C comes out
    row-sharded. Each of the p steps multiplies the matching k-slice of
    the local A panel with the circulating B shard. The transfer of the
    NEXT shard (``lax.ppermute``) is issued BEFORE this step's GEMM and
    is not consumed until the next iteration, so XLA's async-collective
    scheduling overlaps the device-to-device hop with the GEMM — the
    analogue of the reference's NCCL p2p win over object-store copies
    (``nums/core/systems/gpu_systems.py:421-461``). The last step does
    no permute (p-1 hops total, same as the theoretical minimum).

    On small meshes XLA's auto-SPMD all-gather is usually competitive;
    this is the memory-bound / pod-scale pattern (per-step working set is
    one B shard instead of the full gathered panel).
    """
    mesh = mesh_backend.mesh
    ax0 = mesh_backend.device_grid.axis_names[0]
    p = mesh_backend.device_grid.mesh_shape[0]
    perm = [(s, (s + 1) % p) for s in range(p)]

    def local(a_blk, b_blk):
        # a_blk: (m/p, k); b_blk: (k/p, n)
        i = jax.lax.axis_index(ax0)
        kp = b_blk.shape[0]

        def partial(t, a_blk, b_cur):
            # Device i holds B shard ((i - t) mod p) at step t.
            j = (i.astype(jnp.int32) - t) % p
            a_slice = jax.lax.dynamic_slice(
                a_blk, (jnp.int32(0), j * kp), (a_blk.shape[0], kp)
            )
            return jnp.matmul(a_slice, b_cur, precision=precision)

        def body(t, carry):
            b_cur, acc = carry
            # Issue the neighbor transfer FIRST: its result is consumed
            # only next iteration, so it runs concurrently with the GEMM
            # below (double buffer).
            b_next = jax.lax.ppermute(b_cur, ax0, perm)
            acc = acc + partial(t, a_blk, b_cur)
            return b_next, acc

        acc0 = jnp.zeros((a_blk.shape[0], b_blk.shape[1]),
                         dtype=jnp.result_type(a_blk.dtype, b_blk.dtype))
        # Mark the fresh accumulator device-varying so the loop carry
        # types match (shard_map varying-manual-axes rule).
        try:
            acc0 = jax.lax.pcast(acc0, ax0, to="varying")
        except (AttributeError, TypeError):  # older jax spells it pvary
            acc0 = jax.lax.pvary(acc0, ax0)
        b_last, acc = jax.lax.fori_loop(0, p - 1, body, (b_blk, acc0))
        # Final step: no permute (p-1 total hops).
        return acc + partial(p - 1, a_blk, b_last)

    fn = _shard_map(
        local,
        mesh,
        in_specs=(P(ax0, None), P(ax0, None)),
        out_specs=P(ax0, None),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def tn_matmul(mesh_backend, precision=None):
    """C = Araw.T @ B — the transposed-left (x.T @ x headline) pattern,
    hand-scheduled: no materialized transpose and ONE collective.

    Araw (K, m) and B (K, n) arrive row-sharded over mesh axis 0 (their
    at-rest layout); each device computes its full (m, n) partial
    product, then a single ``psum_scatter`` (reduce-scatter)
    over the row axis both sums the K-partials and leaves C row-sharded
    — a log-depth tree where the reference chains adds sequentially
    (blockarray.py:464-472 there). Zero-filled at-rest pads on the K
    axis contribute zero to the sum, so ragged (pad-and-mask) operands
    are handled with no masking.
    """
    mesh = mesh_backend.mesh
    ax0 = mesh_backend.device_grid.axis_names[0]

    def local(a_blk, b_blk):
        partial = jnp.matmul(
            jnp.transpose(a_blk), b_blk, precision=precision
        )  # (m, n) — K-partial for this shard's rows
        return jax.lax.psum_scatter(
            partial, ax0, scatter_dimension=0, tiled=True
        )

    fn = _shard_map(
        local, mesh,
        in_specs=(P(ax0, None), P(ax0, None)),
        out_specs=P(ax0, None),
    )
    return jax.jit(fn)


def tn_supported(mesh_backend, a_raw_shape, b_raw_shape) -> bool:
    """Araw (K, m), B (K, n), both row-sharded; C (m, n) row-sharded.
    Shapes are PHYSICAL (at-rest padded) extents."""
    if mesh_backend.mesh is None:
        return False
    if len(a_raw_shape) != 2 or len(b_raw_shape) != 2:
        return False
    p = mesh_backend.device_grid.mesh_shape[0]
    k, m = a_raw_shape
    k2, _ = b_raw_shape
    return k == k2 and p > 1 and k % p == 0 and m % p == 0


@functools.lru_cache(maxsize=None)
def nt_matmul(mesh_backend, precision=None):
    """C = A @ Braw.T — transposed-right pattern, hand-scheduled.

    A (m, K) row-sharded; Braw (n, K) row-sharded. The B panel is
    all-gathered (its n axis is the sharded one, so the gather
    is the only collective) and contracted against the local A rows
    with the transpose fused into the GEMM — no materialized transpose,
    C comes out row-sharded with no further communication.
    """
    mesh = mesh_backend.mesh
    ax0 = mesh_backend.device_grid.axis_names[0]

    def local(a_blk, b_blk):
        b_full = jax.lax.all_gather(
            b_blk, ax0, axis=0, tiled=True
        )  # (n, K)
        return jnp.matmul(
            a_blk, jnp.transpose(b_full), precision=precision
        )

    fn = _shard_map(
        local, mesh,
        in_specs=(P(ax0, None), P(ax0, None)),
        out_specs=P(ax0, None),
    )
    return jax.jit(fn)


def nt_supported(mesh_backend, a_shape, b_raw_shape) -> bool:
    """A (m, K), Braw (n, K), physical extents, row-sharded."""
    if mesh_backend.mesh is None:
        return False
    if len(a_shape) != 2 or len(b_raw_shape) != 2:
        return False
    p = mesh_backend.device_grid.mesh_shape[0]
    m, k = a_shape
    n, k2 = b_raw_shape
    return k == k2 and p > 1 and m % p == 0 and n % p == 0


def ring_supported(mesh_backend, a_shape, b_shape) -> bool:
    if mesh_backend.mesh is None:
        return False
    ms = mesh_backend.device_grid.mesh_shape
    if len(a_shape) != 2 or len(b_shape) != 2:
        return False
    p = ms[0]
    m, k = a_shape
    k2, n = b_shape
    return k == k2 and p > 1 and m % p == 0 and k % p == 0


def supported(mesh_backend, a_shape, b_shape) -> bool:
    if mesh_backend.mesh is None:
        return False
    ms = mesh_backend.device_grid.mesh_shape
    if len(ms) < 2 or len(a_shape) != 2 or len(b_shape) != 2:
        return False
    p0, p1 = ms[:2]
    m, k = a_shape
    k2, n = b_shape
    return (
        k == k2
        and m % p0 == 0
        and k % p1 == 0
        and k % p0 == 0
        and n % p1 == 0
    )
