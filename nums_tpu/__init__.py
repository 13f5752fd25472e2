"""nums_tpu: a distributed NumPy on JAX.

Rebuild of NumS (reference: merrymercy/nums) on JAX: arrays are
grid-partitioned over a ``jax.sharding.Mesh``, ops are jitted XLA
programs, and device collectives replace the object store.

Parity: ``nums/__init__.py:17-30``.
"""

from nums_tpu._version import __version__
from nums_tpu.api import (read, write, delete, read_csv, read_parquet,
                          write_parquet)
from nums_tpu.core import application_manager


def init():
    """Eagerly initialize the backend (parity: nums/__init__.py:26-30).

    Bounded: a device runtime that does not answer raises RuntimeError after
    ``NUMS_TPU_INIT_TIMEOUT_S`` (default 300 s) instead of hanging
    (``settings.ensure_runtime_alive``)."""
    return application_manager.instance()


__all__ = ["read", "write", "delete", "read_csv", "read_parquet",
           "write_parquet", "init", "__version__"]
