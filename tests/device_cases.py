"""Shared cases for the device-path parity tests (test_device_parity_*):
scoring tables, flag sets and random batches, plus the host reference
results the XLA device path must reproduce exactly."""

import numpy as np

from seqalign_tpu.ops import host_dp
from seqalign_tpu.scoring.config import ScoringConfig

# scoring kind -> (factory taking flag kwargs, alphabet)
SCORING = {
    "equality": (lambda **kw: ScoringConfig(1, -2, -4, -1, **kw), "acgtACGT"),
    "wild": (lambda **kw: ScoringConfig(2, -3, -5, -2, **kw)
             .add_wildcard("n", 1), "acgtn"),
    "swap": (lambda **kw: ScoringConfig(1, -2, -4, -1, **kw)
             .add_mutation("a", "g", 0).add_mutation("g", "a", 0), "acgt"),
    "matrix": (lambda **kw: ScoringConfig(0, 0, -4, -1, **kw).add_mutations(
        "acgt", [[2, -1, -1, -1], [-1, 3, -1, -1], [-1, -1, 3, -1],
                 [-1, -1, -1, 2]], use_match_mismatch=False), "acgt"),
}

FREE_GAPS = [dict(no_start_gap_penalty=True),
             dict(no_end_gap_penalty=True),
             dict(no_start_gap_penalty=True, no_end_gap_penalty=True)]

CONSTRAINED = [
    dict(no_gaps_in_a=True),
    dict(no_gaps_in_b=True),
    dict(no_gaps_in_a=True, no_gaps_in_b=True),
    dict(no_mismatches=True),
]
# the LCS recipe (lcs_cmdline.c:39-49) on top, for SW
CONSTRAINED_SW = CONSTRAINED + [dict(no_gaps_in_a=True, no_gaps_in_b=True,
                                     no_mismatches=True,
                                     case_sensitive=True)]


def flag_id(kw):
    return "+".join(k.replace("no_", "").replace("_penalty", "")
                    for k in kw) or "dflt"


def batch(seed, alpha, n=5, lo=2, hi=20):
    rng = np.random.default_rng(seed)
    sa = ["".join(rng.choice(list(alpha), rng.integers(lo, hi)))
          for _ in range(n)]
    sb = ["".join(rng.choice(list(alpha), rng.integers(lo, hi)))
          for _ in range(n)]
    return sa, sb


def hit_key(h):
    return (h.score, h.pos_a, h.pos_b, h.result_a, h.result_b)


def host_hits(sc, a, b, min_score=None):
    """The host hit stream, cut where a ``min_score`` consumer stops."""
    out = []
    for h in host_dp.HostSwHits(sc, a, b):
        if min_score is not None and h.score < min_score:
            break
        out.append(hit_key(h))
    return out


def assert_pruned_stream(got, want, min_score):
    """A pruned stream equals the host stream up to the threshold and
    holds nothing below it."""
    if min_score is None:
        assert got == want
    else:
        assert got[: len(want)] == want
        assert all(g[0] >= min_score for g in got)
