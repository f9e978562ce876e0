"""Smoke coverage for examples/*.py.

The examples ARE the public API contract (SURVEY §1's canonical user
program); API drift must surface here, not to users. Each example runs in
a subprocess on the CPU backend with ``GFS_EXAMPLE_FAST=1`` (tiny sizes /
few steps — the flag each example defines at the top); the test asserts a
clean exit, not output quality (the unit suite covers the math).
"""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "examples").glob("*.py"))


@pytest.mark.parametrize(
    "path", EXAMPLES, ids=[p.name for p in EXAMPLES]
)
def test_example_runs(path):
    env = dict(os.environ)
    env.update(
        GFS_EXAMPLE_FAST="1",
        # scripts run with examples/ as sys.path[0]; the package is
        # imported from the repo root
        PYTHONPATH=str(REPO),
        JAX_PLATFORMS="cpu",
        # 04_distributed_gpr uses every visible device
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    proc = subprocess.run(
        [sys.executable, str(path)],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, (
        f"{path.name} exited {proc.returncode}\n"
        f"--- stdout ---\n{proc.stdout[-2000:]}\n"
        f"--- stderr ---\n{proc.stderr[-2000:]}"
    )
