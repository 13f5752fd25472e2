"""Process-global application lifecycle.

Parity: ``nums/core/application_manager.py:31-100`` — lazy singleton that
builds Backend + FileSystem + ArrayApplication from settings. Where the
reference boots a Ray cluster here init just constructs a mesh over
already-attached devices (no cluster boundary to cross).
"""

import logging
import sys

from nums_tpu.core import settings
from nums_tpu.core.backend import make_backend
from nums_tpu.core.array.application import ArrayApplication

_instance: ArrayApplication = None


def is_initialized() -> bool:
    return _instance is not None


def instance() -> ArrayApplication:
    global _instance
    if _instance is None:
        _instance = create()
    return _instance


def set_instance(app: ArrayApplication):
    global _instance
    _instance = app


def create() -> ArrayApplication:
    configure_logging()
    from nums_tpu.core import multiprocess

    # Multi-host: connect to the jax.distributed coordinator when the
    # NUMS_TPU_COORDINATOR env triple is set (idempotent; a user call to
    # jax.distributed.initialize() before init() is detected the same
    # way). MUST run before configure_x64 — that probes
    # jax.default_backend(), which initializes XLA and would lock the
    # process out of joining the distributed runtime. The reference's
    # analogue is RaySystem.init's cluster join (systems.py:156-162).
    multiprocess.initialize()
    settings.configure_x64()
    # Init watchdog: a device runtime that does not answer blocks
    # forever inside the first jax.devices() call the backend would
    # make. Probe it under a deadline so init fails LOUDLY in bounded
    # time instead (the reference's ray.init errors likewise).
    settings.ensure_runtime_alive()
    backend_name = settings.backend_name
    if multiprocess.is_multiprocess() and backend_name != "mesh":
        logging.getLogger(__name__).warning(
            "multi-process jax runtime detected: forcing the mesh "
            "backend (backend %r cannot address remote shards)",
            backend_name,
        )
        backend_name = "mesh"
    backend = make_backend(backend_name)
    from nums_tpu.core.io.filesystem import FileSystem

    return ArrayApplication(backend, FileSystem(backend))


def destroy():
    global _instance
    if _instance is None:
        return
    _instance.backend.shutdown()
    _instance = None


def configure_logging():
    root = logging.getLogger()
    if not any(
        isinstance(h, logging.StreamHandler) and h.stream is sys.stdout
        for h in root.handlers
    ):
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(levelname)s %(name)s: %(message)s"))
        root.addHandler(handler)
