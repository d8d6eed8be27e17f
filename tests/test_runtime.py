"""utils/runtime.py: where the compile cache goes, and the GPU gate."""

import os

import pytest

from transport_analysis_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_wins_and_nothing_is_set(monkeypatch, config_updates):
    monkeypatch.setenv(runtime.CACHE_ENV, "/some/where/else")
    assert runtime.enable_compile_cache() == "/some/where/else"
    assert config_updates == []


def test_default_is_the_checkout_directory(monkeypatch, config_updates):
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    path = runtime.enable_compile_cache()
    assert path == runtime.CHECKOUT_CACHE_DIR
    assert config_updates == [("jax_compilation_cache_dir", path)]


def test_checkout_directory_is_fixed_and_ignored():
    assert runtime.CHECKOUT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(runtime.NoGPUError, match="no GPU"):
        runtime.require_gpu()


def test_require_gpu_reports_the_device(monkeypatch):
    import jax

    class _Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda: [_Dev(), _Dev()])
    assert runtime.require_gpu() == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 2}
