# -*- coding: utf-8 -*-
"""chip_smoke.py, the on-card smoke test: off a GPU it refuses to run and
prints no result; its last line has the fixed JSON shape.  The tests
marked ``gpu`` run its audit, kernel, post-tier and TF32 phases on the
card (``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``)."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import chip_smoke  # noqa: E402


def test_refuses_cpu():
    """Without a GPU the script exits nonzero and prints nothing on
    standard output."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=REPO)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "needs a GPU" in r.stderr


def test_require_gpu_exits_on_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(1)
    assert "needs a GPU" in str(e.value)


def test_result_line_format():
    class _Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([_Dev()] * 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


@pytest.fixture(scope="module")
def da():
    import drive_audit
    return drive_audit


@pytest.fixture(scope="module")
def card():
    try:
        return chip_smoke.card_line()
    except (OSError, subprocess.CalledProcessError):
        return "unknown card"


@pytest.mark.gpu
def test_drive_audit_on_card(gpu, da):
    chip_smoke.phase_audit(da)


@pytest.mark.gpu
def test_kernel_matches_scan_on_card(gpu, da, card):
    chip_smoke.phase_kernel(da, card)


@pytest.mark.gpu
def test_post_tier_and_tf32_on_card(gpu, da, card):
    entry = {e[0]: e for e in da.CONFIGS}["cylinders-smeared"]
    data, bound, cfg = da.build_config(entry)
    from mcsas_tpu.core.engine import McSASEngine
    kept = {("cylinders-smeared", ()): (
        data, bound, cfg, McSASEngine(data, bound, cfg).run())}
    chip_smoke.phase_post(kept)
    chip_smoke.phase_tf32(kept, card)
