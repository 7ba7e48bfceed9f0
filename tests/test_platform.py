"""utils.platform: the GPU as the default platform, the device memory
budget, and where the persistent compile cache goes."""
import os
import subprocess
import sys

import jax
import pytest

from metacache_tpu.utils import platform as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 1 << 30


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = "fake"
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.fixture
def no_override(monkeypatch):
    monkeypatch.delenv("MC_HBM_GB", raising=False)


def test_cpu_budget_is_the_named_test_budget(no_override):
    total = P.CPU_TEST_BUDGET_BYTES
    assert total == 16 * GIB
    assert P.hbm_budget_bytes(jax.devices("cpu")[0]) == \
        total - max(2 * GIB, total // 5)


def test_gpu_budget_reads_bytes_limit(no_override):
    d = _FakeDevice("gpu", {"bytes_limit": 60 * GIB})
    assert P.hbm_budget_bytes(d) == 48 * GIB


@pytest.mark.parametrize("stats", [{}, None, {"bytes_in_use": 1}])
def test_gpu_without_bytes_limit_raises(no_override, stats):
    with pytest.raises(RuntimeError, match="bytes_limit"):
        P.hbm_budget_bytes(_FakeDevice("gpu", stats))


def test_budget_override(monkeypatch):
    monkeypatch.setenv("MC_HBM_GB", "10")
    assert P.hbm_budget_bytes(_FakeDevice("gpu", {})) == 8 * GIB


def test_cache_dir_defaults_to_ignored_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert P.compile_cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_dir_env_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert P.compile_cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    P.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


def _cli(platforms, *args, **extra_env):
    """Run the CLI with JAX_PLATFORMS set to `platforms` (None: unset)."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    if platforms:
        env["JAX_PLATFORMS"] = platforms
    env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-m", "metacache_tpu", *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)


def test_default_platform_requires_a_gpu():
    """No platform named and no GPU visible: an error naming the GPU."""
    r = _cli(None, "query", f"{REPO}/tests/data/refdb/refdb",
             CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "no GPU found" in r.stderr and "JAX_PLATFORMS=cpu" in r.stderr


def test_cpu_runs_when_asked():
    r = _cli("cpu", "info", f"{REPO}/tests/data/refdb/refdb")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip()


@pytest.mark.gpu
def test_default_platform_is_the_gpu():
    r = subprocess.run(
        [sys.executable, "-c",
         "from metacache_tpu.utils.platform import force_platform; "
         "force_platform(); import jax; print(jax.devices()[0].platform)"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["gpu"]
