# -*- coding: utf-8 -*-
"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices so the multi-device
sharding paths are exercised without GPUs, and with x64 enabled so
golden-curve validation happens at full precision (the engine is explicitly
float32 everywhere it matters, so this also catches any implicit-dtype
leaks).  Importing mcsas_tpu places JAX's compile cache (see
mcsas_tpu/__init__.py).

Tests marked ``gpu`` need an NVIDIA GPU: the ``gpu`` fixture makes the
first GPU the default device for the test, and skips where there is
none.  Run them on the card with ``JAX_PLATFORMS=cuda,cpu python -m
pytest -m gpu tests/``.
"""
import os
import pathlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "true")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# arrays land on the CPU backend even where a GPU backend is also
# enabled; the gpu fixture moves a test onto the card explicitly
jax.config.update("jax_default_device", jax.devices("cpu")[0])

_REPO = pathlib.Path(__file__).resolve().parent.parent

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU as the default device for one test; skips on a
    machine without one (decided here, at run time, never at import)."""
    try:
        dev = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu)")
    prev = jax.config.jax_default_device
    jax.config.update("jax_default_device", dev)
    try:
        yield dev
    finally:
        jax.config.update("jax_default_device", prev)


# golden data ships with the repo (testdata/ — measurement *data*, not
# code, copied from the reference's published test datasets) so the
# suite runs in a bare checkout; the reference tree is the fallback
_BUNDLED = _REPO / "testdata"
REFDATA = (_BUNDLED if _BUNDLED.is_dir()
           else pathlib.Path("/root/reference/testdata"))
_BUNDLED_MODELS = _BUNDLED / "models"
REFMODELDATA = (_BUNDLED_MODELS if _BUNDLED_MODELS.is_dir()
                else pathlib.Path(
                    "/root/reference/src/mcsas/models/testData"))


@pytest.fixture(scope="session")
def refdata():
    if not REFDATA.is_dir():
        pytest.skip("golden testdata not available")
    return REFDATA


@pytest.fixture(scope="session")
def refmodeldata():
    if not REFMODELDATA.is_dir():
        pytest.skip("golden model testData not available")
    return REFMODELDATA
