"""Vectorized numpy host DP — the framework's low-latency host path.

The device fills (``ops/dp.py``, ``ops/scores_gpu.py``) win on batched
throughput, but a single small CLI pair pays JAX import + backend
init + XLA compile (seconds) for microseconds of arithmetic — and the
reference binary answers in ~1ms.  A production framework needs both: this
module fills the same reference-exact matrices (alignment.c:28-168) with
vectorized numpy row sweeps, so the CLIs and tiny API calls never touch the
accelerator stack at all.

Vectorization: within row ``y``, ``M[y, x]`` and ``Ga[y, x]`` read only row
``y-1`` (alignment.c:89-137) — plain vector ops.  ``Gb[y, x]`` reads
``[y, x-1]`` in the *same* row (alignment.c:139-155), a horizontal
recurrence ``Gb[x] = max(V[x-1], Gb[x-1] + ge, mn)``; substituting
``T[x] = Gb[x] - x*ge`` turns it into a running max
``T[x] = max(T[x-1], max(V[x-1], mn) - x*ge)`` — one
``np.maximum.accumulate`` per row (exact in int64).

This module is deliberately JAX-free (it must import in milliseconds).
Traceback reuses the same reverse-move walkers as the numpy oracle
(``ops/oracle.py``) — those are pinned to the reference by the golden
corpus, and the device direction-code path is validated independently.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..scoring.config import (GAP_A, GAP_B, MATCH, ScoringConfig,
                              UnknownCharPair, encode)


@dataclasses.dataclass
class Alignment:
    """Result record mirroring ``alignment_t`` (alignment.h:33-40)."""

    result_a: str
    result_b: str
    score: int
    pos_a: int = 0
    pos_b: int = 0
    len_a: int = 0
    len_b: int = 0


def fill_matrices(sc: ScoringConfig, seq_a, seq_b, is_sw: bool):
    """Vectorized equivalent of ``oracle.fill_matrices`` (the per-cell spec
    of alignment.c:28-168): returns (M, Ga, Gb) int32 arrays of shape
    (len_b+1, len_a+1), row-major [y][x], bit-identical values."""
    a = encode(seq_a)
    b = encode(seq_b)
    n, m = len(a), len(b)
    w, h = n + 1, m + 1
    _, sub_lut, is_match_lut, valid_lut = sc.luts()

    # invalid-pair abort, at the reference's row-major-first cell; message
    # and case folding match scoring_lookup (alignment_scoring.c:135-181)
    if n and m:
        badT = ~valid_lut[np.ix_(a, b)].T  # [y-1, x-1]
        if badT.any():
            fold = sc.luts()[0]
            y0, x0 = np.argwhere(badT)[0]
            raise UnknownCharPair(
                "Unknown character pair (%c,%c) and match/mismatch have not "
                "been set" % (chr(fold[a[x0]]), chr(fold[b[y0]]))
            )

    gop = sc.gap_extend + sc.gap_open  # gap_open_penalty (alignment.c:38)
    ge = sc.gap_extend
    mn = int(sc.dp_floor(is_sw))
    neg = sc.no_end_gap_penalty
    nga = sc.no_gaps_in_a
    ngb = sc.no_gaps_in_b
    nmm = sc.no_mismatches

    M = np.zeros((h, w), dtype=np.int64)
    Ga = np.zeros((h, w), dtype=np.int64)
    Gb = np.zeros((h, w), dtype=np.int64)

    if is_sw:
        M[1:, 0] = Ga[1:, 0] = Gb[1:, 0] = mn  # == 0 (alignment.c:51-57)
    else:
        xs = np.arange(1, w, dtype=np.int64)
        ys = np.arange(1, h, dtype=np.int64)
        M[0, 1:] = Ga[0, 1:] = mn
        Gb[0, 1:] = 0 if sc.no_start_gap_penalty else sc.gap_open + xs * ge
        M[1:, 0] = Gb[1:, 0] = mn
        Ga[1:, 0] = 0 if sc.no_start_gap_penalty else sc.gap_open + ys * ge

    if n == 0 or m == 0:
        return M.astype(np.int32), Ga.astype(np.int32), Gb.astype(np.int32)

    prof = sub_lut[np.ix_(a, b)].astype(np.int64)  # [x-1, y-1]
    imat = is_match_lut[np.ix_(a, b)] != 0 if nmm else None
    karr = np.arange(1, w, dtype=np.int64)

    for y in range(1, h):
        sub = prof[:, y - 1]
        pM, pGa, pGb = M[y - 1], Ga[y - 1], Gb[y - 1]

        # MATCH (alignment.c:89-119)
        mrow = np.maximum(
            np.maximum(np.maximum(pM[:-1], pGa[:-1]), pGb[:-1]) + sub, mn
        )
        if nmm:
            mrow = np.where(imat[:, y - 1], mrow, mn)  # alignment.c:101-104
        M[y, 1:] = mrow

        # GAP_A (vertical, reads row y-1 at x) (alignment.c:121-137)
        garow = np.maximum(
            np.maximum(np.maximum(pM[1:], pGb[1:]) + gop, pGa[1:] + ge), mn
        )
        if nga:
            garow[: n - 1] = mn  # gaps in a only at x == n
        if neg:
            garow[n - 1] = max(int(pM[n]), int(pGa[n]), int(pGb[n]))
        Ga[y, 1:] = garow

        # GAP_B (horizontal max-plus scan) (alignment.c:139-155)
        if neg and y == m:
            pref = np.maximum.accumulate(np.maximum(M[y, :-1], Ga[y, :-1]))
            Gb[y, 1:] = np.maximum(Gb[y, 0], pref)
        elif ngb and y != m:
            Gb[y, 1:] = mn
        else:
            V = np.maximum(M[y, :-1], Ga[y, :-1]) + gop  # pred at x-1
            U = np.maximum(V, mn) - karr * ge
            Gb[y, 1:] = np.maximum(np.maximum.accumulate(U),
                                   Gb[y, 0]) + karr * ge

    for arr in (M, Ga, Gb):
        assert (arr.min() >= np.iinfo(np.int32).min
                and arr.max() <= np.iinfo(np.int32).max)
    return M.astype(np.int32), Ga.astype(np.int32), Gb.astype(np.int32)


def nw_align(sc: ScoringConfig, seq_a: str, seq_b: str) -> Alignment:
    """Host-path global alignment (needleman_wunsch.c:34-146)."""
    from . import oracle

    mats = fill_matrices(sc, seq_a, seq_b, is_sw=False)
    ra, rb, score = oracle.nw_align(sc, seq_a, seq_b, matrices=mats)
    return Alignment(ra, rb, score, 0, 0, len(seq_a), len(seq_b))


def nw_align_ref_wrap(sc: ScoringConfig, seq_a: str, seq_b: str):
    """Opt-in SEQALIGN_REF_WRAP=1 bug-compat NW: the reference's exact
    int32 two's-complement wrap semantics (its UB in the sentinel-overflow
    regime), including the traceback-fail abort — raises
    :class:`oracle.TracebackFail` carrying the reference's dump values.
    Returns (Alignment, (M, Ga, Gb)); identical to the normal path
    whenever nothing wraps."""
    from . import oracle

    if not sc.sentinel_wrap_risk():
        # nothing can wrap: the vectorized fill is bit-identical and far
        # faster than the per-cell wrap-emulation loop
        return nw_align_with_matrices(sc, seq_a, seq_b)
    mats = oracle.fill_matrices(sc, seq_a, seq_b, is_sw=False, wrap32=True)
    try:
        ra, rb, score = oracle.nw_align(sc, seq_a, seq_b, matrices=mats,
                                        wrap32=True)
    except oracle.TracebackFail as tf:
        # the CLI abort dump needs the matrices + raw sequences
        tf.matrices = mats
        tf.seq_a, tf.seq_b = seq_a, seq_b
        raise
    return (Alignment(ra, rb, score, 0, 0, len(seq_a), len(seq_b)), mats)


def nw_align_with_matrices(sc: ScoringConfig, seq_a: str, seq_b: str):
    """One fill shared by traceback + --printmatrices (the reference fills
    once and prints from live state, tools/nw_cmdline.c:107-110)."""
    from . import oracle

    mats = fill_matrices(sc, seq_a, seq_b, is_sw=False)
    ra, rb, score = oracle.nw_align(sc, seq_a, seq_b, matrices=mats)
    return Alignment(ra, rb, score, 0, 0, len(seq_a), len(seq_b)), mats


class HostSwHits:
    """Best-first local-hit iterator on the host path — same contract as
    ``ops.traceback.SwHitIterator`` (smith_waterman.c:131-277), built on the
    shared reverse-move walker over the fast-filled matrices."""

    def __init__(self, sc: ScoringConfig, seq_a: str, seq_b: str,
                 matrices=None, history=None):
        from . import oracle

        if matrices is None:
            matrices = fill_matrices(sc, seq_a, seq_b, is_sw=True)
        self.matrices = matrices
        self._o = oracle.SwOracle(sc, seq_a, seq_b, matrices=matrices,
                                  history=history)

    def fetch(self) -> Optional[Alignment]:
        h = self._o.fetch()
        if h is None:
            return None
        return Alignment(**h)

    def __iter__(self) -> Iterator[Alignment]:
        while True:
            h = self.fetch()
            if h is None:
                return
            yield h
