"""Init-path watchdog: a device runtime that does not answer must
produce a loud RuntimeError in bounded time, not an unbounded hang
inside the first backend probe."""

import time

import pytest

from nums_tpu.core import settings


def test_probe_short_circuits_on_explicit_platform():
    """An explicit jax_platforms request (the conftest pins cpu) must
    resolve with NO backend init — timeout can't even be reached."""
    assert settings.probe_default_backend(timeout_s=0.001) == "cpu"


def test_priority_list_uses_real_probe(monkeypatch):
    """A multi-entry priority list ("cuda,cpu") must NOT short-circuit
    to its first entry: the platform that actually initializes may be
    the fallback, and configure_x64 would mis-decide x64 for it."""
    import jax

    calls = []

    def fake_probe(fn, what, timeout_s):
        calls.append(what)
        return "cpu"

    monkeypatch.setattr(settings, "_bounded_probe", fake_probe)
    jax.config.update("jax_platforms", "cpu,cpu")
    try:
        assert settings.probe_default_backend(timeout_s=1) == "cpu"
    finally:
        jax.config.update("jax_platforms", "cpu")
    assert calls  # the real (bounded) probe ran; no first-entry guess


def test_bounded_probe_times_out():
    def hang():
        time.sleep(60)

    with pytest.raises(RuntimeError, match="not answering"):
        settings._bounded_probe(hang, "hang-probe", 0.2)


def test_bounded_probe_propagates_errors():
    def boom():
        raise ValueError("backend setup error")

    with pytest.raises(ValueError, match="backend setup error"):
        settings._bounded_probe(boom, "err-probe", 5.0)


def test_bounded_probe_returns_value():
    assert settings._bounded_probe(lambda: 42, "ok-probe", 5.0) == 42


def test_ensure_runtime_alive_on_healthy_runtime():
    devices = settings.ensure_runtime_alive(timeout_s=60)
    assert len(devices) >= 1


def test_ensure_runtime_alive_times_out_on_wedge(monkeypatch):
    import jax

    def hang():
        time.sleep(60)

    monkeypatch.setattr(jax, "devices", hang)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="did not respond"):
        settings.ensure_runtime_alive(timeout_s=0.3)
    assert time.perf_counter() - t0 < 10  # bounded, not a hang


def test_zero_timeout_disables_watchdog():
    # 0 = unbounded (probe joins without deadline); healthy runtime
    # returns immediately.
    assert settings._bounded_probe(lambda: "ok", "p", 0) == "ok"


def test_configure_x64_fails_loudly_and_unlatches(monkeypatch):
    """A failed platform probe must NOT guess cpu (which would latch
    x64 on an accelerator whose runtime merely answered late): it
    raises, leaves x64 untouched, and un-latches so a retried init
    re-probes."""
    import jax

    def wedged(timeout_s=None):
        raise RuntimeError("probe did not respond: wedged")

    monkeypatch.setattr(settings, "probe_default_backend", wedged)
    monkeypatch.setattr(settings, "_x64_configured", False)
    monkeypatch.setattr(settings, "x64_mode", "auto")
    before = jax.config.jax_enable_x64
    with pytest.raises(RuntimeError, match="wedged"):
        settings.configure_x64()
    assert jax.config.jax_enable_x64 == before  # no mis-latch
    assert settings._x64_configured is False  # retry re-probes

    # After "recovery" (probe succeeds) the same process configures.
    monkeypatch.setattr(settings, "probe_default_backend",
                        lambda timeout_s=None: "gpu")
    settings.configure_x64()
    assert settings._x64_configured is True
    assert jax.config.jax_enable_x64 == before  # gpu keeps x64 off
    # Restore module latch for other tests (monkeypatch undoes attrs,
    # but be explicit about the global).
