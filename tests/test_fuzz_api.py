"""API-level fuzz: random scoring configs + sequences through the real
device path must match the numpy oracle exactly (score, strings, SW hit
streams).  Complements the fixed 497-case golden corpus."""

import numpy as np
import pytest

from seqalign_tpu.aligners import NeedlemanWunsch, SmithWaterman
from seqalign_tpu.io.seqio import read_seqs_sharded
from seqalign_tpu.ops import oracle
from seqalign_tpu.scoring.config import ScoringConfig

FLAGSETS = [
    dict(),
    dict(no_start_gap_penalty=True),
    dict(no_end_gap_penalty=True, no_start_gap_penalty=True),
    dict(no_gaps_in_b=True),
    dict(no_mismatches=True),
    dict(case_sensitive=True),
]


def _rand_case(rng, flags):
    m = int(rng.integers(0, 4))
    mm = int(rng.integers(-6, min(1, m + 1)))
    go = int(rng.integers(-8, 1))
    ge = int(rng.integers(-3, 0))
    sc = ScoringConfig(m, mm, go, ge, **flags)
    if rng.random() < 0.4:
        sc.add_wildcard("n", int(rng.integers(-2, 3)))
    alpha = list("acgtACGT" if flags.get("case_sensitive") else "acgtn")
    la, lb = rng.integers(1, 60, 2)
    a = "".join(rng.choice(alpha, la))
    b = "".join(rng.choice(alpha, lb))
    return sc, a, b


@pytest.mark.parametrize("flags", FLAGSETS, ids=lambda f: "+".join(f) or "dflt")
def test_fuzz_nw_matches_oracle(flags):
    rng = np.random.default_rng(hash(tuple(sorted(flags))) % 2**31)
    for _ in range(4):
        sc, a, b = _rand_case(rng, flags)
        nw = NeedlemanWunsch(sc)
        got = nw.align(a, b)
        want = oracle.nw_align(sc, a, b)
        assert (got.result_a, got.result_b, got.score) == want, (a, b)
        assert nw.score(a, b) == want[2]


@pytest.mark.parametrize("flags", FLAGSETS[:4],
                         ids=lambda f: "+".join(f) or "dflt")
def test_fuzz_sw_matches_oracle(flags):
    rng = np.random.default_rng(1 + hash(tuple(sorted(flags))) % 2**31)
    for _ in range(3):
        sc, a, b = _rand_case(rng, flags)
        got = [
            (h.score, h.pos_a, h.pos_b, h.result_a, h.result_b)
            for h in SmithWaterman(sc).align(a, b)
        ]
        want = [
            (h["score"], h["pos_a"], h["pos_b"], h["result_a"], h["result_b"])
            for h in oracle.SwOracle(sc, a, b).hits()
        ]
        assert got == want, (a, b)


_DEVICE_FLAGSETS = [
    dict(),
    dict(no_start_gap_penalty=True, no_end_gap_penalty=True),
    dict(no_gaps_in_a=True),
    dict(no_gaps_in_b=True, case_sensitive=True),
    dict(no_mismatches=True),
    dict(no_gaps_in_a=True, no_gaps_in_b=True, no_mismatches=True,
         case_sensitive=True),  # the LCS recipe
]


@pytest.mark.parametrize("flags", _DEVICE_FLAGSETS,
                         ids=lambda f: "+".join(f) or "dflt")
def test_fuzz_device_pallas_matches_host(monkeypatch, flags):
    """Randomized batches through the FORCED device path (the scores
    kernel in the Pallas interpreter where eligible, the XLA fill
    elsewhere) across the full mode space — equality, wildcard and swap
    scoring composed with the constrained/free-gap flags — must reproduce
    the host reference exactly (scores, alignments and SW hit streams)."""
    from seqalign_tpu.ops import host_dp

    import os

    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setenv("SEQALIGN_PALLAS", "interpret")
    rng = np.random.default_rng(7 + hash(tuple(sorted(flags))) % 2**31)
    # soak runs dial this up (SEQALIGN_FUZZ_TRIALS=20 ...); CI stays fast
    for trial in range(int(os.environ.get("SEQALIGN_FUZZ_TRIALS", "2"))):
        m = int(rng.integers(0, 4))
        mm = int(rng.integers(-6, min(1, m + 1)))
        go = int(rng.integers(-8, 1))
        ge = int(rng.integers(-3, 0))
        sc = ScoringConfig(m, mm, go, ge, **flags)
        alpha = "acgt"
        if not flags.get("no_mismatches") and rng.random() < 0.5:
            # matrix scoring -> LUT mode (no_mismatches needs equality)
            if rng.random() < 0.5:
                sc.add_wildcard("n", int(rng.integers(-2, 3)))
                alpha = "acgtn"
            else:
                sc.add_mutation("a", "g", int(rng.integers(-2, 3)))
        sa = ["".join(rng.choice(list(alpha), rng.integers(1, 24)))
              for _ in range(3)]
        sb = ["".join(rng.choice(list(alpha), rng.integers(1, 24)))
              for _ in range(3)]
        nw_ok = not (sc.no_mismatches and (sc.no_gaps_in_a or
                                           sc.no_gaps_in_b))
        if nw_ok:
            got = NeedlemanWunsch(sc).align_batch(sa, sb)
            want = [host_dp.nw_align(sc, x, y) for x, y in zip(sa, sb)]
            assert got == want, (flags, trial, sa, sb)
            assert list(NeedlemanWunsch(sc).score_batch(sa, sb)) == \
                [w.score for w in want], (flags, trial, sa, sb)
        for it, x, y in zip(SmithWaterman(sc).align_batch(sa, sb), sa, sb):
            hit_got = [(h.score, h.pos_a, h.pos_b, h.result_a, h.result_b)
                       for h in it]
            hit_want = [(h.score, h.pos_a, h.pos_b, h.result_a,
                         h.result_b) for h in host_dp.HostSwHits(sc, x, y)]
            assert hit_got == hit_want, (flags, trial, x, y)


def test_sharded_reader_partitions_pairs(tmp_path):
    p = tmp_path / "x.fa"
    recs = [f">{i}\nacg{'t' * (i % 3 + 1)}\n" for i in range(10)]
    p.write_text("".join(recs))
    shards = [list(read_seqs_sharded(str(p), s, 3)) for s in range(3)]
    # whole pairs per shard, all pairs covered exactly once
    assert all(len(s) % 2 == 0 for s in shards)
    merged = sorted(sum(shards, []))
    full = sorted(
        __import__("seqalign_tpu.io.seqio", fromlist=["read_seqs"])
        .read_seqs(str(p))
    )
    assert merged == full


def test_score_batch_bucketed_and_swapped_matches_oracle():
    """Mixed-length batches ride the bucketed (and, for symmetric
    configs, side-swapped) scores path — results must equal the per-pair
    oracle for symmetric AND asymmetric substitution configs."""
    import numpy as np

    from seqalign_tpu.aligners import (
        NeedlemanWunsch, SmithWaterman, _swap_symmetric,
    )
    from seqalign_tpu.ops import oracle
    from seqalign_tpu.scoring.config import ScoringConfig

    rng = np.random.default_rng(41)
    seqs_a, seqs_b = [], []
    for _ in range(17):  # wild length mix so buckets differ
        la, lb = rng.integers(1, 300, 2)
        seqs_a.append("".join(rng.choice(list("acgt"), la)))
        seqs_b.append("".join(rng.choice(list("acgt"), lb)))

    sym = ScoringConfig(2, -3, -4, -1)
    assert _swap_symmetric(sym)
    got = NeedlemanWunsch(sym).score_batch(seqs_a, seqs_b)
    for a, b, s in zip(seqs_a, seqs_b, got):
        assert oracle.nw_align(sym, a, b)[2] == s
    got_sw = SmithWaterman(sym).best_score_batch(seqs_a, seqs_b)
    for a, b, s in zip(seqs_a, seqs_b, got_sw):
        M, _, _ = oracle.fill_matrices(sym, a, b, True)
        assert M.max(initial=0) == s

    # asymmetric substitution (add_mutation one way): swap must be OFF
    asym = ScoringConfig(1, -2, -4, -1)
    asym.add_mutation("a", "g", 1)
    assert not _swap_symmetric(asym)
    got = NeedlemanWunsch(asym).score_batch(seqs_a, seqs_b)
    for a, b, s in zip(seqs_a, seqs_b, got):
        assert oracle.nw_align(asym, a, b)[2] == s

    # no-gaps flags distinguish the sides: swap must be OFF
    import dataclasses

    nga = dataclasses.replace(sym, no_gaps_in_a=True)
    assert not _swap_symmetric(nga)
