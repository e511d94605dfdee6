"""CLI startup robustness: fresh-process latency, concurrency safety, the
platform choice left to JAX, and the SEQALIGN_WATCHDOG hang-breaker."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env(**extra):
    env = dict(os.environ)
    env.update(extra)
    return env


def test_fresh_cli_processes_fast_and_concurrent():
    """Several simultaneous fresh CLI processes must all answer promptly
    (small inputs never import JAX, so nothing contends for a device)."""
    procs = [
        subprocess.Popen(
            [os.path.join(REPO, "bin", "needleman_wunsch"),
             "--printscores", "CAGACGT", "CGATA"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=_clean_env(),
        )
        for _ in range(4)
    ]
    for p in procs:
        out, err = p.communicate(timeout=60)
        assert p.returncode == 0, err
        assert b"score: -11" in out


def test_module_invocation_leaves_platform_choice():
    """Importing the CLI glue neither imports JAX nor touches
    JAX_PLATFORMS: device-sized inputs use whatever backend JAX picks
    (the GPU where there is one), and small ones stay JAX-free."""
    code = (
        "import os, sys;"
        "before = os.environ.get('JAX_PLATFORMS');"
        "import seqalign_tpu.cli._common;"
        "assert os.environ.get('JAX_PLATFORMS') == before;"
        "assert 'jax' not in sys.modules;"
        "print('ok')"
    )
    for platforms in ("cpu", None):
        env = _clean_env()
        env.pop("JAX_PLATFORMS", None)
        if platforms:
            env["JAX_PLATFORMS"] = platforms
        p = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, env=env,
            capture_output=True, timeout=120,
        )
        assert p.returncode == 0, p.stderr
        assert p.stdout.strip() == b"ok"


def test_watchdog_breaks_hang():
    code = (
        "import os; os.environ['SEQALIGN_WATCHDOG'] = '1.0';"
        "from seqalign_tpu.cli._common import arm_watchdog;"
        "arm_watchdog(); import time; time.sleep(30)"
    )
    p = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
        capture_output=True, timeout=25,
    )
    assert p.returncode != 0
    assert b"Timeout" in p.stderr or b"Thread" in p.stderr


def test_watchdog_disarms_on_completion():
    code = (
        "import os; os.environ['SEQALIGN_WATCHDOG'] = '1.0';"
        "from seqalign_tpu.cli.lcs import main;"
        "main(['lcs', 'abcabc']); import time; time.sleep(1.5);"
        "print('alive')"
    )
    p = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
        capture_output=True, timeout=60,
    )
    assert p.returncode == 0, p.stderr
    assert b"alive" in p.stdout
