"""Scoring model: this package's equivalent of the reference's ``scoring_t``.

The reference (``/root/reference/src/alignment_scoring.{h,c}``) resolves a
character pair's substitution score *per DP cell* with a chain of branchy
lookups (``scoring_lookup``, alignment_scoring.c:133-182):

    case-fold -> no_mismatches short-circuit -> swap table -> wildcards
    (min rule) -> match/mismatch -> hard error

That is hostile to a data-parallel kernel, so :class:`ScoringConfig` compiles the whole
chain once into dense 256x256 lookup tables (substitution score, is-match,
validity).  Encoded sequences index these tables; the hot DP kernel sees only
int32 gathers/selects and never branches.

Semantics reproduced exactly (reference file:line cited inline):
  * gap model: a length-N gap costs ``gap_open + N * gap_extend``
    (alignment_scoring.c:28-29)
  * min/max_penalty tracking incl. gap terms (alignment_scoring.c:49-54) which
    defines the NW NEG_INF sentinel ``INT_MIN + |min_penalty|``
    (alignment.c:41)
  * wildcard min rule + wildcard-implies-match (alignment_scoring.c:114-129)
  * swap table does NOT alter is_match (alignment_scoring.c:156-159)
  * no_mismatches consults wildcards only (alignment_scoring.c:148-152)
  * case-insensitive folds both sides everywhere (alignment_scoring.c:135-140)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

INT_MIN = np.int32(np.iinfo(np.int32).min)
INT_MAX = int(np.iinfo(np.int32).max)

# Direction / matrix codes, shared across the whole framework.
MATCH, GAP_A, GAP_B = 0, 1, 2  # enum Matrix (alignment.h:43)


def _tolower_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint8)
    t[ord("A") : ord("Z") + 1] += 32
    return t


_TOLOWER = _tolower_table()


class UnknownCharPair(ValueError):
    """scoring_lookup's fatal unknown-pair error (alignment_scoring.c:
    177-182): the reference prints 'Error: <msg>' to stderr and exits 1;
    the CLIs catch this type to reproduce that byte-for-byte."""


@dataclasses.dataclass
class ScoringConfig:
    """Mirror of ``scoring_t`` (alignment_scoring.h:19-40) plus compiled LUTs."""

    match: int = 1
    mismatch: int = -2
    gap_open: int = -4
    gap_extend: int = -1
    no_start_gap_penalty: bool = False
    no_end_gap_penalty: bool = False
    no_gaps_in_a: bool = False
    no_gaps_in_b: bool = False
    no_mismatches: bool = False
    case_sensitive: bool = False
    use_match_mismatch: bool = True

    def __post_init__(self):
        # swap table state (256x256), wildcard state (256)
        self._swap_set = np.zeros((256, 256), dtype=bool)
        self._swap_scores = np.zeros((256, 256), dtype=np.int32)
        self._wild_set = np.zeros(256, dtype=bool)
        self._wild_scores = np.zeros(256, dtype=np.int32)
        # min/max penalty tracking (alignment_scoring.c:49-54)
        self.min_penalty = min(self.match, self.mismatch)
        self.max_penalty = max(self.match, self.mismatch)
        if not (self.no_gaps_in_a and self.no_gaps_in_b):
            self.min_penalty = min(
                self.min_penalty, self.gap_open + self.gap_extend, self.gap_extend
            )
            self.max_penalty = max(
                self.max_penalty, self.gap_open + self.gap_extend, self.gap_extend
            )
        self._luts = None  # lazily compiled

    # -- construction API mirroring scoring_init/add_wildcard/add_mutation ----

    def fold(self, c: int) -> int:
        """Case-fold one byte per the config (tolower when case-insensitive)."""
        return int(c) if self.case_sensitive else int(_TOLOWER[int(c)])

    def add_wildcard(self, char: str | int, score: int) -> "ScoringConfig":
        """scoring_add_wildcard (alignment_scoring.c:57-64)."""
        c = self.fold(_as_byte(char))
        self._wild_set[c] = True
        self._wild_scores[c] = score
        self.min_penalty = min(self.min_penalty, score)
        self.max_penalty = max(self.max_penalty, score)
        self._luts = None
        return self

    def add_mutation(self, a: str | int, b: str | int, score: int) -> "ScoringConfig":
        """scoring_add_mutation (alignment_scoring.c:66-72).

        NOTE: the reference does NOT case-fold here; callers fold before
        calling (scoring_add_mutations / the file loaders do their own fold).
        """
        ai, bi = _as_byte(a), _as_byte(b)
        self._swap_set[ai, bi] = True
        self._swap_scores[ai, bi] = score
        self.min_penalty = min(self.min_penalty, score)
        self.max_penalty = max(self.max_penalty, score)
        self._luts = None
        return self

    def add_mutations(
        self, alphabet: str, scores, use_match_mismatch: bool
    ) -> "ScoringConfig":
        """scoring_add_mutations bulk load (alignment_scoring.c:74-95)."""
        scores = np.asarray(scores, dtype=np.int64).reshape(len(alphabet), len(alphabet))
        for i, ca in enumerate(alphabet):
            a = self.fold(ord(ca))
            for j, cb in enumerate(alphabet):
                b = self.fold(ord(cb))
                self.add_mutation(a, b, int(scores[i, j]))
        self.use_match_mismatch = use_match_mismatch
        return self

    # -- derived quantities ----------------------------------------------------

    @property
    def neg_inf(self) -> int:
        """The NW sentinel: SCORE_MIN + abs(min_penalty) (alignment.c:41)."""
        return int(INT_MIN) + abs(self.min_penalty)

    def dp_floor(self, is_sw: bool) -> int:
        return 0 if is_sw else self.neg_inf

    def sentinel_wrap_risk(self) -> bool:
        """True in the int32 sentinel-overflow regime: a constrained mode
        (no-gaps/no-mismatch masking fills whole regions with NEG_INF)
        combined with any per-step penalty larger than the frozen
        |min_penalty| headroom.  One step off a masked cell then computes
        NEG_INF - step < INT_MIN — C UB in the reference (it aborts with
        'Program error: traceback fail', garbage matrices); our int32
        device fills would wrap identically.  Callers route this regime to
        the int64 host path instead (aligners._route)."""
        if not (self.no_gaps_in_a or self.no_gaps_in_b
                or self.no_mismatches):
            return False
        tmn, tmx = self.true_penalty_bounds()
        step = max(abs(tmn), abs(tmx),
                   abs(self.gap_open) + abs(self.gap_extend))
        return step > abs(self.min_penalty)

    def true_penalty_bounds(self) -> tuple:
        """(min, max) over the CURRENT per-step scores: match/mismatch, gap
        steps, swap and wildcard scores.  Unlike ``min_penalty`` /
        ``max_penalty`` — which replicate the reference's frozen
        scoring_init accumulation for NEG_INF byte parity (alignment.c:41;
        CLI flag mutations never recompute them) — these are real bounds,
        for the int32 exactness gates (:meth:`sentinel_wrap_risk`,
        ``ops.scores_gpu.eligible``)."""
        mn = min(self.match, self.mismatch,
                 self.gap_open + self.gap_extend, self.gap_extend)
        mx = max(self.match, self.mismatch,
                 self.gap_open + self.gap_extend, self.gap_extend)
        if self._swap_set.any():
            mn = min(mn, int(self._swap_scores[self._swap_set].min()))
            mx = max(mx, int(self._swap_scores[self._swap_set].max()))
        if self._wild_set.any():
            mn = min(mn, int(self._wild_scores[self._wild_set].min()))
            mx = max(mx, int(self._wild_scores[self._wild_set].max()))
        return mn, mx

    # -- LUT compilation ---------------------------------------------------------

    def luts(self):
        """Compile (fold[256]u8, sub[256,256]i32, is_match[256,256]b, valid[256,256]b).

        Tables are indexed by RAW bytes (folding is baked in), so encoders can
        skip an explicit fold pass.
        """
        if self._luts is None:
            fold = (
                np.arange(256, dtype=np.uint8) if self.case_sensitive else _TOLOWER.copy()
            )
            f = fold.astype(np.int32)
            a = f[:, None] * np.ones((1, 256), np.int32)  # folded a for each (a,b)
            b = np.ones((256, 1), np.int32) * f[None, :]

            eq = a == b
            wild_a = self._wild_set[a]
            wild_b = self._wild_set[b]
            any_wild = wild_a | wild_b
            # wildcard min rule (alignment_scoring.c:115-129)
            wa = np.where(wild_a, self._wild_scores[a], INT_MAX)
            wb = np.where(wild_b, self._wild_scores[b], INT_MAX)
            wild_score = np.minimum(wa, wb).astype(np.int32)

            swap_hit = self._swap_set[a, b]
            swap_score = self._swap_scores[a, b]

            if self.no_mismatches:
                # scoring_lookup fast path (alignment_scoring.c:148-152):
                # mismatching pair -> wildcards only; score 0 when no wildcard.
                mm_path = ~eq
            else:
                mm_path = np.zeros_like(eq)

            # Resolution order: swap -> wildcard -> match/mismatch -> invalid
            mm_score = np.where(eq, np.int32(self.match), np.int32(self.mismatch))
            sub = np.where(
                mm_path,
                np.where(any_wild, wild_score, np.int32(0)),
                np.where(
                    swap_hit,
                    swap_score,
                    np.where(
                        any_wild,
                        wild_score,
                        mm_score if self.use_match_mismatch else np.int32(0),
                    ),
                ),
            ).astype(np.int32)

            is_match = np.where(
                mm_path,
                any_wild,
                np.where(swap_hit, eq, np.where(any_wild, True, eq)),
            )

            valid = mm_path | swap_hit | any_wild | self.use_match_mismatch

            self._luts = (fold, sub, is_match, valid)
        return self._luts

    def lookup(self, a: str | int, b: str | int):
        """scoring_lookup for one pair -> (score, is_match). Raises on invalid
        pair like the reference's exit(EXIT_FAILURE) (alignment_scoring.c:179)."""
        fold, sub, is_match, valid = self.luts()
        ai, bi = _as_byte(a), _as_byte(b)
        if not valid[ai, bi]:
            raise UnknownCharPair(
                f"Unknown character pair ({chr(fold[ai])},{chr(fold[bi])}) and "
                "match/mismatch have not been set"
            )
        return int(sub[ai, bi]), bool(is_match[ai, bi])

    def copy(self) -> "ScoringConfig":
        new = ScoringConfig(
            self.match,
            self.mismatch,
            self.gap_open,
            self.gap_extend,
            self.no_start_gap_penalty,
            self.no_end_gap_penalty,
            self.no_gaps_in_a,
            self.no_gaps_in_b,
            self.no_mismatches,
            self.case_sensitive,
            self.use_match_mismatch,
        )
        new._swap_set = self._swap_set.copy()
        new._swap_scores = self._swap_scores.copy()
        new._wild_set = self._wild_set.copy()
        new._wild_scores = self._wild_scores.copy()
        new.min_penalty = self.min_penalty
        new.max_penalty = self.max_penalty
        return new


def _as_byte(c: str | int) -> int:
    if isinstance(c, str):
        return ord(c)
    return int(c) & 0xFF


def encode(seq: str | bytes) -> np.ndarray:
    """Encode a sequence to raw uint8 codes (LUTs bake in case folding)."""
    if isinstance(seq, str):
        seq = seq.encode("latin-1")
    return np.frombuffer(bytes(seq), dtype=np.uint8).copy()
