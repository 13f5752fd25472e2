"""Compile-cache placement and the x64 / matmul-precision policy when
the platform probe reports a GPU."""

import os
import subprocess
import sys

import pytest

from nums_tpu.core import settings

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture()
def config_spy(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setattr(settings, "_cache_configured", False)
    monkeypatch.setattr(settings, "_x64_configured", False)
    return calls


def test_cache_dir_left_to_jax_when_env_set(config_spy, monkeypatch,
                                            tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    settings.configure_compilation_cache()
    assert "jax_compilation_cache_dir" not in dict(config_spy)


def test_cache_dir_defaults_to_repo_root(config_spy, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    settings.configure_compilation_cache()
    assert dict(config_spy)["jax_compilation_cache_dir"] == os.path.join(
        REPO, ".jax_cache")
    assert settings.default_cache_dir == os.path.join(REPO, ".jax_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_cache_configured_once(config_spy, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    settings.configure_compilation_cache()
    n = len(config_spy)
    settings.configure_compilation_cache()
    assert len(config_spy) == n


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_lands_where_configured(tmp_path, env_set):
    """End to end in a fresh process: the cache directory JAX uses
    after nums_tpu.init()."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    code = ("import jax, nums_tpu; nums_tpu.init(); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = (str(tmp_path / "cache") if env_set
            else os.path.join(REPO, ".jax_cache"))
    assert out.stdout.strip().splitlines()[-1] == want


@pytest.mark.parametrize("platform,x64_mode,want_x64", [
    ("gpu", "auto", None),   # accelerator: x64 stays off
    ("cuda", "auto", None),
    ("cpu", "auto", True),   # NumPy dtype parity on the CPU
    ("gpu", "1", True),      # explicit opt-in wins on any platform
    ("gpu", "0", None),
])
def test_x64_policy(config_spy, monkeypatch, platform, x64_mode, want_x64):
    monkeypatch.setattr(settings, "probe_default_backend",
                        lambda timeout_s=None: platform)
    monkeypatch.setattr(settings, "x64_mode", x64_mode)
    settings.configure_x64()
    assert dict(config_spy).get("jax_enable_x64") is want_x64


@pytest.mark.parametrize("precision,want", [
    ("default", None),       # XLA's choice: TF32 for f32 dots on a GPU
    ("highest", "highest"),
    ("float32", "float32"),
])
def test_matmul_precision_policy(config_spy, monkeypatch, precision, want):
    monkeypatch.setattr(settings, "probe_default_backend",
                        lambda timeout_s=None: "gpu")
    monkeypatch.setattr(settings, "matmul_precision", precision)
    settings.configure_x64()
    assert dict(config_spy).get("jax_default_matmul_precision") == want


def test_no_at_rest_padding_on_serial():
    from nums_tpu.core.backend import SerialBackend

    assert [a for a in dir(settings) if "lane" in a] == []
    assert SerialBackend().physical_shape((10, 1000)) == (10, 1000)
