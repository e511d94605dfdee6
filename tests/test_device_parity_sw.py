"""Smith-Waterman on the XLA device path (SEQALIGN_FORCE=device) against
the host hit streams across the mode matrix: free gaps x scoring table,
the constrained modes and LCS, the chunked long-pair fill with and
without a min-score hint, and the device candidate walker."""

import numpy as np
import pytest

import device_cases as dc
from seqalign_tpu import aligners
from seqalign_tpu.aligners import SmithWaterman
from seqalign_tpu.scoring.config import ScoringConfig


@pytest.fixture(autouse=True)
def device_path(monkeypatch):
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.delenv("SEQALIGN_PALLAS", raising=False)


def _check_sw(sc, sa, sb, min_score=None):
    sw = SmithWaterman(sc)
    mins = None if min_score is None else [min_score] * len(sa)
    for it, a, b in zip(sw.align_batch(sa, sb, mins), sa, sb):
        want = dc.host_hits(sc, a, b, min_score)
        dc.assert_pruned_stream([dc.hit_key(h) for h in it], want,
                                min_score)
    best = [max([h[0] for h in dc.host_hits(sc, a, b)] or [0])
            for a, b in zip(sa, sb)]
    assert list(sw.best_score_batch(sa, sb)) == best


@pytest.mark.parametrize("kind", list(dc.SCORING))
@pytest.mark.parametrize("flags", dc.FREE_GAPS, ids=dc.flag_id)
def test_sw_free_gaps(flags, kind):
    """The reference applies the free-end-gap branches to SW too
    (alignment.c:122-127,140-145)."""
    make, alpha = dc.SCORING[kind]
    sa, sb = dc.batch(31 + len(kind) + 3 * len(flags), alpha)
    _check_sw(make(**flags), sa, sb)


@pytest.mark.parametrize("kind", ["equality", "wild"])
@pytest.mark.parametrize("flags", dc.CONSTRAINED_SW, ids=dc.flag_id)
def test_sw_constrained(flags, kind):
    make, alpha = dc.SCORING[kind]
    if flags.get("case_sensitive"):
        alpha = alpha.lower()
    sa, sb = dc.batch(29 + len(kind) + 5 * len(flags), alpha)
    _check_sw(make(**flags), sa, sb)


@pytest.mark.parametrize("kind", list(dc.SCORING))
def test_sw_tables_default_flags(kind):
    make, alpha = dc.SCORING[kind]
    sa, sb = dc.batch(9 + len(kind), alpha, n=7, lo=1, hi=120)
    _check_sw(make(), sa, sb)


@pytest.mark.parametrize("kind", ["equality", "matrix"])
@pytest.mark.parametrize("min_score", [None, 5])
@pytest.mark.parametrize("chunk", [16, 24])
def test_sw_align_long_chunked(chunk, min_score, kind):
    """align_long streams per-chunk candidates harvested on the device;
    the hit stream equals the host stream up to the hint."""
    make, alpha = dc.SCORING[kind]
    rng = np.random.default_rng(41 + chunk + len(kind))
    a = "".join(rng.choice(list(alpha), 80))
    b = "".join(rng.choice(list(alpha), 50))
    sc = make()
    it = SmithWaterman(sc).align_long(a, b, chunk=chunk, min_score=min_score)
    dc.assert_pruned_stream([dc.hit_key(h) for h in it],
                            dc.host_hits(sc, a, b, min_score), min_score)


@pytest.mark.parametrize("flags", [dict(), dict(no_end_gap_penalty=True)],
                         ids=dc.flag_id)
@pytest.mark.parametrize("walker", [True, False], ids=["device_walk",
                                                       "host_walk"])
def test_sw_candidates_walker(monkeypatch, walker, flags):
    """With a min-score hint the M matrix stays on the device (only
    candidates come back); paths are walked on the device below the
    candidate cutover and on the host above it (and always on the host
    for free end gaps, whose penalties the device walker lacks)."""
    monkeypatch.setattr(aligners, "_SW_DEVWALK_CANDS",
                        1 << 30 if walker else 0)
    sc = ScoringConfig(2, -2, -3, -1, **flags)
    sa, sb = dc.batch(13 + walker + 2 * len(flags), "acgt", n=5, lo=5,
                      hi=40)
    sw = SmithWaterman(sc)
    for it, a, b in zip(sw.align_batch(sa, sb, [4] * len(sa)), sa, sb):
        assert it.mmat is None  # device harvest: no M on host
        uses_walker = it.walker is not None
        assert uses_walker == (walker and not flags)
        dc.assert_pruned_stream([dc.hit_key(h) for h in it],
                                dc.host_hits(sc, a, b, 4), 4)


@pytest.mark.parametrize("min_score", [None, 4])
def test_sw_long_bucket(monkeypatch, min_score):
    monkeypatch.setattr(aligners, "LONG_PAIR_CELLS", 600)
    sa, sb = dc.batch(3 + (min_score or 0), "acgt", n=4, lo=25, hi=60)
    _check_sw(ScoringConfig(2, -2, -3, -1), sa, sb, min_score)


@pytest.mark.parametrize("seed", range(4))
def test_lcs_device_matches_host(monkeypatch, seed):
    """The LCS CLI recipe (SW self-alignment, no_gaps + no_mismatches +
    case_sensitive, lcs_cmdline.c:39-64) on the device path."""
    rng = np.random.default_rng(31 + seed)
    s = "".join(rng.choice(list("acgt"), rng.integers(6, 40)))
    got = list(aligners.lcs_hits(s))
    monkeypatch.setenv("SEQALIGN_FORCE", "host")
    want = list(aligners.lcs_hits(s))
    assert got == want and all(h.pos_a < h.pos_b for h in got)


@pytest.mark.parametrize("group", [1, 3])
def test_sw_harvest_in_groups(monkeypatch, group):
    """The candidate harvest splits a batch into pair groups that fit the
    device budget; the hit streams do not change."""
    from seqalign_tpu.ops import dp

    sa, sb = dc.batch(77 + group, "acgt", n=7, lo=10, hi=50)
    sc = ScoringConfig(2, -2, -3, -1)
    cells = (64 + 64 - 1) * 65  # skewed M cells of one padded 64x64 pair
    monkeypatch.setattr(aligners, "_device_budget",
                        lambda: group * aligners.HARVEST_BYTES_PER_CELL
                        * cells)
    calls = []
    orig = dp.sw_extract_candidates

    def spy(mmat, *a, **k):
        calls.append(mmat.shape[0])
        return orig(mmat, *a, **k)

    monkeypatch.setattr(dp, "sw_extract_candidates", spy)
    _check_sw(sc, sa, sb, 4)
    assert calls and max(calls) <= group
