# -*- coding: utf-8 -*-
"""Lint gate: the in-repo checker (tools/lint.py) must be clean over the
package, tests, tools and driver entry points — the modern equivalent of
the reference's pre-commit.sh/.pylintrc gate (reference:
pre-commit.sh:1-35, run_pylint.sh:1-27)."""
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))


def test_lint_clean():
    import lint
    findings = lint.lint_paths([
        str(REPO / "mcsas_tpu"), str(REPO / "tests"), str(REPO / "tools"),
        str(REPO / "bench.py"), str(REPO / "__graft_entry__.py"),
        str(REPO / "chip_smoke.py")])
    msg = "\n".join(f"{p}:{ln}: {code} {m}" for p, ln, code, m in findings)
    assert not findings, f"lint findings:\n{msg}"
