"""Test fixtures.

Mirrors the reference's backend-parameterized fixture strategy
(``tests/conftest.py:28-72`` there): every core-array test runs against
multiple backends. Here the backends are {serial single-device jit,
mesh over 8 virtual CPU devices} — the virtual mesh exercises the same
sharded SPMD path as a real multi-GPU host without the hardware (the
reference similarly simulated multinode on a single Ray instance).
"""

import os

# Must run before the CPU backend initializes (switching jax_platforms to
# cpu below also overrides any accelerator the environment registered).
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

from nums_tpu.core import settings  # noqa: E402
from nums_tpu.core import application_manager  # noqa: E402

settings.configure_x64()


def _make_app(backend_name):
    settings.backend_name = backend_name
    application_manager.destroy()
    return application_manager.create()


@pytest.fixture(scope="module", params=["serial", "mesh"])
def app_inst(request):
    app = _make_app(request.param)
    application_manager.set_instance(app)
    yield app
    application_manager.destroy()


@pytest.fixture(scope="module", params=["serial", "mesh"])
def nps_app_inst(request):
    """Drives the public nums_tpu.numpy API via the settings singleton."""
    app = _make_app(request.param)
    application_manager.set_instance(app)
    yield app
    application_manager.destroy()
