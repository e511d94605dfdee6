"""Strict bug-compat parity: with SEQALIGN_SW_REF_MASK=1 the SW CLI must be
byte-identical to the UNPATCHED reference binary on multi-pair files — i.e.
including the reference's quarter-mask-reset bug (smith_waterman.c:149),
where stale overlap-mask bits from earlier pairs suppress hits in later
pairs of the same process.  (Default mode implements the intended semantics
and is pinned against the patched build — README "Known deviations".)
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFBUILD = "/tmp/refbuild"
UNPATCHED = os.path.join(REFBUILD, "smith_waterman_unpatched")


@pytest.fixture(scope="module")
def unpatched_ref():
    if not os.path.exists(UNPATCHED):
        r = subprocess.run(
            ["sh", os.path.join(REPO, "tools", "build_reference.sh")],
            capture_output=True, timeout=300,
        )
        if r.returncode != 0 or not os.path.exists(UNPATCHED):
            pytest.skip("reference toolchain unavailable: "
                        + r.stderr.decode()[-300:])
    return UNPATCHED


def _write_pairs(tmp_path, n_pairs, seed, lo=8, hi=60):
    """Repetitive, hit-dense pairs so overlap masks carry real state."""
    rng = np.random.default_rng(seed)
    p = tmp_path / "pairs.fa"
    with open(p, "w") as fh:
        for i in range(2 * n_pairs):
            s = "".join(rng.choice(list("acgt"), rng.integers(lo, hi)))
            if rng.random() < 0.5:  # seed shared motifs across pairs
                s = s + "acgtacgt" + s[: len(s) // 2]
            fh.write(f">s{i}\n{s}\n")
    return str(p)


@pytest.mark.parametrize("seed,n_pairs,extra", [
    (1, 12, []),
    (2, 20, ["--minscore", "3"]),
    (3, 8, ["--context", "2"]),
])
def test_sw_ref_mask_compat_byte_parity(tmp_path, unpatched_ref, seed,
                                        n_pairs, extra):
    path = _write_pairs(tmp_path, n_pairs, seed)
    args = extra + ["--file", path]
    ref = subprocess.run([unpatched_ref] + args, capture_output=True,
                         timeout=120)
    env = dict(os.environ, SEQALIGN_SW_REF_MASK="1", JAX_PLATFORMS="cpu")
    ours = subprocess.run(
        [sys.executable, "-m", "seqalign_tpu.cli.smith_waterman"] + args,
        capture_output=True, timeout=300, cwd=REPO, env=env,
    )
    assert ours.returncode == ref.returncode
    assert ours.stdout == ref.stdout
    assert ours.stderr == ref.stderr


def test_history_quarter_reset_semantics():
    """Unit check of the emulated mask lifecycle: grow keeps stale bits,
    reset clears exactly 8*((l+31)/32) leading bits."""
    from seqalign_tpu.ops.traceback import SwRefMaskHistory

    h = SwRefMaskHistory()
    m = h.begin_pair(100)  # fits initial 256-bit capacity
    assert h.capacity == 256 and len(m) == 256
    m[:] = True
    m2 = h.begin_pair(200)
    assert m2 is m  # same shared buffer
    # l=256: memset((256+31)/32)=8 bytes => bits [0,64) cleared, rest stale
    assert not m2[:64].any() and m2[64:].all()
    m3 = h.begin_pair(300)  # grow to 512: old bits kept, new zeroed,
    # then reset clears 8*((512+31)/32) = 128 leading bits
    assert h.capacity == 512 and len(m3) == 512
    assert not m3[:128].any()
    assert m3[128:256].all()
    assert not m3[256:].any()
