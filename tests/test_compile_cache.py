"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR when set (JAX
reads it; the package sets no other), else a fixed directory in the
checkout, which git ignores."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = (
    "import jax\n"
    "from seqalign_tpu.ops import dp\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
    "print(dp.COMPILE_CACHE_DIR)\n"
)


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_dir(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    p = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path,
                       env=dict(env, PYTHONPATH=REPO), capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == [want, want]


def test_default_cache_dir_is_ignored():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
