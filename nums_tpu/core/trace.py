"""Tracing / profiling hooks.

The reference's observability is a DEBUG root logger plus per-placement
scheduler logs (``BlockCyclicScheduler(verbose=True)``,
schedulers.py:229-244). The equivalent here:

- an op-event log at the dispatch layer (every BlockArray op, with name,
  operand shapes, and logical output shape) — enable with
  ``NUMS_TPU_TRACE=1`` or ``trace.enable()``;
- ``profile(path)``: context manager around ``jax.profiler.trace`` to
  capture an XLA device trace viewable in TensorBoard/Perfetto;
- ``annotate(name)``: named region in the profiler timeline.
"""

import contextlib
import logging
import os
import time

logger = logging.getLogger("nums_tpu.ops")

_enabled = os.environ.get("NUMS_TPU_TRACE", "0") not in ("0", "", "false")
_events = []
_record = False


def enable(record: bool = False):
    """Turn on op-event logging; record=True also buffers events."""
    global _enabled, _record
    _enabled = True
    _record = record
    if not logger.handlers and not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logger.setLevel(logging.INFO)


def disable():
    global _enabled, _record
    _enabled = False
    _record = False


def events():
    return list(_events)


def clear():
    _events.clear()


def log_op(op_name: str, *operands, out=None):
    """Called from the BlockArray dispatch layer on every op."""
    if not _enabled:
        return
    shapes = ",".join(str(getattr(o, "shape", o)) for o in operands)
    msg = f"{op_name}({shapes})" + (f" -> {out}" if out is not None else "")
    logger.info(msg)
    if _record:
        _events.append((time.time(), op_name, shapes, out))


def is_enabled():
    return _enabled


@contextlib.contextmanager
def profile(logdir: str):
    """Capture a device profile (XLA ops, kernels, memory) to
    ``logdir``; open with TensorBoard's profile plugin or Perfetto."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region in the profiler timeline (TraceAnnotation)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
