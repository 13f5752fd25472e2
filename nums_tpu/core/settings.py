"""Global configuration for nums_tpu.

Mirrors the role of the reference's env-var config module
(``nums/core/settings.py:17-68``): backend selection, cluster/mesh shape,
and operator alias tables. The backend vocabulary maps the reference's
``NUMS_SYSTEM`` ∈ {serial, ray-task, ray-cyclic} onto JAX execution
modes:

- ``serial``: single-device jit (the testable-anywhere backend, analogous to
  the reference's ``SerialSystem``).
- ``mesh``: SPMD over a ``jax.sharding.Mesh`` (the analogue of the
  block-cyclic Ray cluster; XLA sharding propagation replaces the
  task scheduler).

``cluster_shape`` names the mesh shape, mirroring the reference's
``cluster_shape`` (``nums/core/settings.py:36-37``).
"""

import os

import numpy as np


def _env_tuple(name, default):
    raw = os.environ.get(name, "")
    if not raw:
        return default
    return tuple(int(x) for x in raw.split(",") if x.strip())


# Backend: "serial" (single device) or "mesh" (SPMD over all visible devices).
backend_name = os.environ.get("NUMS_TPU_BACKEND", "serial")

# Mesh shape for the mesh backend. Empty tuple = auto (all devices on axis 0,
# i.e. shape (n_devices, 1) for the standard 2-D mesh).
cluster_shape = _env_tuple("NUMS_TPU_CLUSTER_SHAPE", ())

# Enable float64 on the CPU so the NumPy-oracle tests match at 1e-6.
# "auto" enables x64 iff the default backend is CPU (see configure_x64).
x64_mode = os.environ.get("NUMS_TPU_X64", "auto")

# Local data directory for FS-backed array persistence (mirrors
# nums/core/settings.py:22-27).
data_dir = os.environ.get(
    "NUMS_TPU_DATA_DIR", os.path.join(os.path.expanduser("~"), ".nums_tpu")
)

# Default matmul precision for fp32 inputs. "default" leaves XLA's own
# choice: on an NVIDIA GPU (Ampere and later) f32 dots then run on the
# tensor cores in TF32 (10-bit mantissa inputs, f32 accumulation, about
# 5e-4 relative error per product); on the CPU they are full f32.
# "float32"/"highest" force full fp32 products on the GPU as well.
matmul_precision = os.environ.get("NUMS_TPU_MATMUL_PRECISION", "default")


_cache_configured = False


# Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset:
# a fixed directory beside the package (the path is part of the cache
# key, so a directory that moves never hits). Git-ignored.
default_cache_dir = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def configure_compilation_cache():
    """Persist XLA compilations across processes.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache goes to
    ``default_cache_dir``."""
    global _cache_configured
    if _cache_configured:
        return
    _cache_configured = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", default_cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


# Bounded device-runtime probes: a device runtime that does not answer
# blocks FOREVER inside jax.default_backend()/jax.devices() — the
# reference's ray.init at least fails with an error. Every init-path
# probe below runs under this budget and raises loudly on expiry.
# 0 disables the watchdog (probes run unbounded).
init_timeout_s = float(os.environ.get("NUMS_TPU_INIT_TIMEOUT_S", "300"))


def _bounded_probe(fn, what, timeout_s):
    """Run ``fn`` in a daemon thread with a deadline. A wedged device
    runtime leaves the probe thread blocked (daemon: it dies with the
    process) and raises RuntimeError here instead of hanging the
    caller unboundedly."""
    import threading

    result = []
    error = []

    def probe():
        try:
            result.append(fn())
        except BaseException as e:  # noqa: BLE001 - reported to caller
            error.append(e)

    t = threading.Thread(target=probe, daemon=True, name=f"probe-{what}")
    t.start()
    t.join(timeout_s if timeout_s and timeout_s > 0 else None)
    if error:
        raise error[0]
    if not result:
        raise RuntimeError(
            f"{what} did not respond within {timeout_s:.0f}s — the "
            "device runtime is not answering. "
            "Raise NUMS_TPU_INIT_TIMEOUT_S to wait longer, or set "
            "JAX_PLATFORMS=cpu (via jax.config.update('jax_platforms', "
            "'cpu') before first device use) to run on host."
        )
    return result[0]


def probe_default_backend(timeout_s=None):
    """``jax.default_backend()`` without the unbounded-hang failure mode.

    Short-circuits on an explicit platform request (``jax_platforms``
    config or ``JAX_PLATFORMS`` env) — deciding the platform then needs
    no backend initialization at all. Otherwise the probe initializes
    the registered backend under ``init_timeout_s``.
    """
    import jax

    plats = None
    try:
        plats = jax.config.jax_platforms
    except Exception:  # pragma: no cover - config attr is stable
        pass
    plats = plats or os.environ.get("JAX_PLATFORMS", "")
    if plats:
        entries = [p for p in (q.strip().lower()
                               for q in plats.split(",")) if p]
        if len(entries) == 1:
            return entries[0]
        # A priority LIST ("cuda,cpu") resolves to whichever entry
        # actually initializes — that needs the real (bounded) probe.
    if timeout_s is None:
        timeout_s = init_timeout_s
    return _bounded_probe(jax.default_backend, "jax.default_backend()",
                          timeout_s)


def ensure_runtime_alive(timeout_s=None):
    """Bounded ``jax.devices()`` — the init-path watchdog.

    Called by ``application_manager.create()`` before the backend is
    built so a runtime that does not answer produces a loud RuntimeError
    instead of an unbounded hang. On success the runtime is warm and
    every later device call is non-blocking-on-init.
    """
    import jax

    if timeout_s is None:
        timeout_s = init_timeout_s
    return _bounded_probe(jax.devices, "jax.devices()", timeout_s)


_x64_configured = False


def configure_x64():
    """Enable jax x64 mode on the CPU (NumPy dtype parity).

    Idempotent; invoked from ``application_manager.create()``. On an
    accelerator x64 stays off for now: every fp32 path (benchmarks,
    tolerances, memory sizing) was built for 32-bit arrays, and turning
    x64 on would silently double the bytes of every NumPy-default
    float64 input. Native float64 on the GPU is an open roadmap item.
    Raises (and un-latches) if the platform probe fails, so init errors
    loudly in one timeout instead of mis-latching x64.
    """
    global _x64_configured
    if _x64_configured:
        return
    _x64_configured = True
    import jax

    configure_compilation_cache()
    if matmul_precision not in ("default", None, ""):
        jax.config.update("jax_default_matmul_precision", matmul_precision)
    if x64_mode == "0":
        return
    if x64_mode in ("1", "true"):
        jax.config.update("jax_enable_x64", True)
        return
    # auto — bounded probe: an explicit jax_platforms/JAX_PLATFORMS
    # request resolves with no backend init; otherwise the probe runs
    # under init_timeout_s. A failed probe must NOT guess "cpu": that
    # would latch x64 for the whole process on an accelerator whose
    # runtime merely answered late. It un-latches (so a retried init()
    # re-probes) and re-raises — init fails loudly ONCE here, and
    # ensure_runtime_alive never pays a second timeout on the same
    # unanswering runtime.
    try:
        platform = probe_default_backend()
    except BaseException:
        _x64_configured = False
        raise
    if platform == "cpu":
        jax.config.update("jax_enable_x64", True)


# Operator alias map: NumPy ufunc names that the op vocabulary spells
# differently (mirrors np_ufunc_map, nums/core/settings.py:48-61).
np_ufunc_map = {
    "truediv": "true_divide",
    "sub": "subtract",
    "pow": "power",
    "mult": "multiply",
    "mul": "multiply",
    "tensordot": "multiply",
    "lt": "less",
    "le": "less_equal",
    "gt": "greater",
    "ge": "greater_equal",
    "eq": "equal",
    "ne": "not_equal",
}

# Pairwise reduction aliases (mirrors np_pairwise_reduction_map,
# nums/core/settings.py:63-68): NaN-ignoring pairwise min/max.
np_pairwise_reduction_map = {
    "min": "fmin",
    "amin": "fmin",
    "max": "fmax",
    "amax": "fmax",
    "nansum": "add",
}

# TSQR algorithm: "auto" (CholeskyQR2 on an accelerator — all large
# matrix products; Householder panel tree on the CPU), or force
# "cholqr2"/"householder".
# CholeskyQR2 is exact-orthogonal for cond(X) ≲ 1/sqrt(eps); the
# Householder tree is the robust fallback for ill-conditioned inputs.
tsqr_method = os.environ.get("NUMS_TPU_TSQR", "auto")

# Debug: warn whenever a materialized buffer's sharding diverges from
# what the grid metadata implies (e.g. an op silently replicated a
# result the grid claims is sharded). Costs a check per materialization.
debug_sharding = os.environ.get("NUMS_TPU_DEBUG_SHARDING", "0") == "1"

# Hand-scheduled collective matmul for the mesh backend's 2-D tensordot:
# "0" (default) lets XLA's SPMD partitioner schedule the collectives
# (usually best on small meshes); "ring" = double-buffered ppermute ring
# (pod-scale / memory-bound pattern); "summa" = explicit all-gather SUMMA;
# "auto" = per-shape dispatch via the named cost model in ops/summa.py
# (TN/NT for transposed patterns, streamed schedules past the gather
# budget, XLA otherwise). Falls back to the default path when the shapes
# aren't supported.
collective_matmul = os.environ.get("NUMS_TPU_COLLECTIVE_MATMUL", "0")

# Lazy expression batching (SURVEY hard-part #7): BlockArray ops build a
# deferred DAG; the first sync point compiles the whole chain as ONE
# jitted program (cached structurally). "0" executes one program per op.
lazy_batch = os.environ.get("NUMS_TPU_LAZY", "1") == "1"
lazy_max_depth = int(os.environ.get("NUMS_TPU_LAZY_MAX_DEPTH", "128"))
# LRU bound on cached compiled lazy programs (a long-running job with a
# pathological stream of structurally-unique graphs would otherwise grow
# the executor cache without limit).
lazy_program_cache = int(os.environ.get("NUMS_TPU_LAZY_PROGRAM_CACHE", "1024"))

# Checkpoint resilience: number of full copies write_fs produces
# (1 = no replication) and the roots replica directories live under
# (colon-separated; in a real deployment, mounts on distinct failure
# domains — empty means sibling `<path>.replica<k>` dirs).
checkpoint_replicas = int(os.environ.get("NUMS_TPU_CHECKPOINT_REPLICAS", "1"))
# fsync checkpoint files + dirs before/after the publish renames so a
# published checkpoint survives power loss (0 = rename-ordering only).
checkpoint_fsync = os.environ.get("NUMS_TPU_CHECKPOINT_FSYNC", "1") == "1"
replica_roots = [
    p for p in os.environ.get("NUMS_TPU_REPLICA_DIRS", "").split(":") if p
]

# Pad-and-mask ragged sharding (SURVEY hard-part #5): mesh-indivisible
# axes are rounded up to the mesh multiple at rest and sliced back to the
# logical shape inside every consuming program (pads are never read).
# "0" reverts to replicating ragged axes.
pad_shard = os.environ.get("NUMS_TPU_PAD_SHARD", "1") == "1"

# Fuse GLM Newton training into one on-device while_loop program
# (zero per-iteration host syncs). "1" (default) fuses supported
# configurations; "0" forces the eager per-op solver loop.
glm_fuse = os.environ.get("NUMS_TPU_GLM_FUSE", "1")

# Default dtypes, mirroring NumPy semantics used by the reference.
default_float = np.float64
default_int = np.int64
