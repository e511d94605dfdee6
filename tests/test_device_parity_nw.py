"""Needleman-Wunsch on the XLA device path (SEQALIGN_FORCE=device) against
the int64 host path across the mode matrix: free start/end gaps x scoring
table, the constrained no-gaps/no-mismatch modes, the chunked long-pair
fill and the long-pair bucket of align_batch."""

import numpy as np
import pytest

import device_cases as dc
from seqalign_tpu import aligners
from seqalign_tpu.aligners import NeedlemanWunsch
from seqalign_tpu.ops import dp, host_dp
from seqalign_tpu.scoring.config import ScoringConfig


@pytest.fixture(autouse=True)
def device_path(monkeypatch):
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.delenv("SEQALIGN_PALLAS", raising=False)


def _check_nw(sc, sa, sb):
    nw = NeedlemanWunsch(sc)
    want = [host_dp.nw_align(sc, a, b) for a, b in zip(sa, sb)]
    assert nw.align_batch(sa, sb) == want
    assert list(nw.score_batch(sa, sb)) == [w.score for w in want]


@pytest.mark.parametrize("kind", list(dc.SCORING))
@pytest.mark.parametrize("flags", dc.FREE_GAPS, ids=dc.flag_id)
def test_nw_free_gaps(flags, kind):
    """Free start/end gaps (alignment.c:59-81,122-145) with every scoring
    table: alignments and scores equal the host path."""
    make, alpha = dc.SCORING[kind]
    sa, sb = dc.batch(len(kind) + 3 * len(flags), alpha, n=6)
    _check_nw(make(**flags), sa, sb)


@pytest.mark.parametrize("kind", ["equality", "wild"])
@pytest.mark.parametrize("flags", dc.CONSTRAINED, ids=dc.flag_id)
def test_nw_constrained(flags, kind):
    """--nogapsin1/--nogapsin2/--nomismatches incl. the end-gap exception
    (alignment.c:121-137, tests.c:65-98)."""
    make, alpha = dc.SCORING[kind]
    sa, sb = dc.batch(17 + len(kind) + 5 * len(flags), alpha, n=6)
    _check_nw(make(**flags), sa, sb)


@pytest.mark.parametrize("kind", list(dc.SCORING))
def test_nw_tables_default_flags(kind):
    """Ragged batches spanning several length buckets, every table."""
    make, alpha = dc.SCORING[kind]
    sa, sb = dc.batch(5 + len(kind), alpha, n=9, lo=1, hi=150)
    _check_nw(make(), sa, sb)


@pytest.mark.parametrize("kind", ["equality", "wild", "matrix"])
@pytest.mark.parametrize("chunk", [16, 24])
def test_nw_align_long_chunked(chunk, kind):
    """align_long's chunked boundary-carry fill equals the one-shot host
    alignment, whatever the chunk boundary."""
    make, alpha = dc.SCORING[kind]
    rng = np.random.default_rng(chunk + len(kind))
    a = "".join(rng.choice(list(alpha), 70))
    b = "".join(rng.choice(list(alpha), 40))
    sc = make()
    got = NeedlemanWunsch(sc).align_long(a, b, chunk=chunk)
    want = host_dp.nw_align(sc, a, b)
    assert (got.result_a, got.result_b, got.score) == \
        (want.result_a, want.result_b, want.score)


@pytest.mark.parametrize("flags", [dict()] + dc.FREE_GAPS, ids=dc.flag_id)
def test_nw_long_bucket(monkeypatch, flags):
    """Pairs over LONG_PAIR_CELLS leave the batched fill for the chunked
    path inside align_batch; results are unchanged."""
    monkeypatch.setattr(aligners, "LONG_PAIR_CELLS", 600)
    sa, sb = dc.batch(3 + len(flags), "acgt", n=5, lo=10, hi=60)
    sc = ScoringConfig(1, -2, -4, -1, **flags)
    before = aligners.dispatch_counts().get("chunked_xla", 0)
    _check_nw(sc, sa, sb)
    assert aligners.dispatch_counts().get("chunked_xla", 0) > before


def test_sentinel_wrap_regime_routes_host():
    """NW no-gaps with penalties beyond the frozen |min_penalty| headroom:
    the reference overflows int32 (UB) and aborts; the regime always takes
    the int64 host fill — even under SEQALIGN_FORCE=device — and returns
    the mathematically optimal alignment (README known deviations)."""
    sc = ScoringConfig(1, -2, -7, -1, no_gaps_in_a=True, no_gaps_in_b=True)
    assert sc.sentinel_wrap_risk()
    a, b = "catcgggancncgnaacccnaantcg", "cnnncgagtcgcactnactacntnacct"
    got = NeedlemanWunsch(sc).align_batch([a], [b])[0]
    want = host_dp.nw_align(sc, a, b)
    assert (got.result_a, got.result_b, got.score) == \
        (want.result_a, want.result_b, want.score)
    assert got.score == -37  # pinned from the reference-crash repro
    assert aligners._route(10**9, 10**3, sc) == "host"
    assert aligners._route(10**9, 10**3) == "device"  # SW sites: no sentinel


def test_compact_codes_mixed_case_equality():
    """compact_inputs_mm codes compare equal exactly when the folded bytes
    match, across different a/b alphabets and mixed case — the contract
    the equality-scoring kernel relies on."""
    sc = ScoringConfig(2, -3, -4, -1)
    assert dp.mm_eligible(sc)
    seqs_a = ["ACacGG", "ttAC"]
    seqs_b = ["ggtACA", "CAtt"]
    a, _ = dp.pad_batch(seqs_a)
    b, _ = dp.pad_batch(seqs_b)
    acm, bcm = dp.compact_inputs_mm(sc, a, b)
    fold = sc.luts()[0]
    for i in range(2):
        for x in range(len(seqs_a[i])):
            for y in range(len(seqs_b[i])):
                assert bool(acm[i, x] == bcm[i, y]) == \
                    bool(fold[a[i, x]] == fold[b[i, y]])
    scs = ScoringConfig(2, -3, -4, -1, case_sensitive=True)
    acs, _ = dp.compact_inputs_mm(scs, a, b)
    assert (acs[0, 0] != acs[0, 2]) == (chr(a[0, 0]) != chr(a[0, 2]))


def test_mm_eligible_gates():
    from seqalign_tpu.scoring.presets import scoring_system_BLOSUM62

    assert dp.mm_eligible(ScoringConfig(1, -2, -4, -1))
    assert not dp.mm_eligible(ScoringConfig(1, -2, -4, -1)
                              .add_wildcard("N", 0))
    assert not dp.mm_eligible(ScoringConfig(1, -2, -4, -1)
                              .add_mutation("a", "c", 3))
    assert not dp.mm_eligible(scoring_system_BLOSUM62())
