"""Backend choice by platform, the compile-cache rule, and chip_smoke.py's
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

from cornelis.options import RenderOptions, resolve_backend
from cornelis.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,backend", [("cpu", "xla"), ("gpu", "pallas")])
def test_backend_follows_platform(platform, backend):
    assert resolve_backend(platform) == backend


@pytest.mark.parametrize("platform", ["rocm", "metal", "interpreter"])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no render backend"):
        resolve_backend(platform)


@pytest.mark.parametrize("forced", ["xla", "pallas"])
def test_forced_backend_wins(forced):
    assert RenderOptions(backend=forced).resolved_backend() == forced


def test_auto_backend_on_cpu_is_wavefront():
    assert RenderOptions().resolved_backend() == "xla"


def test_session_reports_its_backend():
    from cornelis.render import RenderSession
    from cornelis.scene.library import cornell_box

    opts = RenderOptions(width=8, height=8, samples_aa=1, max_depth=2, output=None)
    assert RenderSession(cornell_box(), opts).render().backend == "xla"


def test_cache_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_checkout(monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_enable_points_jax_at_the_rule(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    try:
        assert cache.enable_persistent_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    res = _run_smoke(REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
