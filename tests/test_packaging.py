# -*- coding: utf-8 -*-
"""Packaging smoke test: the project installs with pip (local build, no
network) and the installed package + console entry point import/run."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

slow = pytest.mark.skipif(
    os.environ.get("MCSAS_TPU_SLOW_TESTS", "") != "1",
    reason="set MCSAS_TPU_SLOW_TESTS=1 to run the pip-install smoke test")


@slow
def test_pip_install_smoke(tmp_path):
    target = tmp_path / "site"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--quiet", "--no-deps",
         "--no-build-isolation", "--target", str(target), REPO],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    # import the *installed* copy (strip the repo from the path) and run
    # the CLI module surface
    env = dict(os.environ)
    env["PYTHONPATH"] = str(target)
    code = ("import mcsas_tpu, mcsas_tpu.cli; "
            "from mcsas_tpu.models import REGISTRY; "
            "assert 'Sphere' in REGISTRY and len(REGISTRY) >= 11; "
            "print('install-ok')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "install-ok" in r.stdout


@slow
def test_console_script_listed():
    import tomllib
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fd:
        meta = tomllib.load(fd)
    assert meta["project"]["scripts"]["mcsas-tpu"] == "mcsas_tpu.cli:main"


@pytest.fixture
def restore_cache_dir():
    import jax
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set the package sets no cache
    directory of its own."""
    import jax
    import mcsas_tpu
    jax.config.update("jax_compilation_cache_dir", "/elsewhere")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    mcsas_tpu._setup()
    assert jax.config.jax_compilation_cache_dir == "/elsewhere"


def test_compile_cache_default_is_checkout(monkeypatch, restore_cache_dir):
    """Without it the cache is the fixed <checkout>/.jax_cache, whatever
    the home directory."""
    import jax
    import mcsas_tpu
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", "/nonexistent-home")
    mcsas_tpu._setup()
    want = os.path.join(REPO, ".jax_cache")
    assert mcsas_tpu.default_cache_dir() == want
    assert jax.config.jax_compilation_cache_dir == want
