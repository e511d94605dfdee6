"""Host-side traceback from device-emitted direction codes.

The reference walks its three full int32 matrices re-verifying score
equalities at every step (alignment.c:244-350).  Our fill kernel already
resolved every tie with the reference's exact guard/equality/priority
procedure and packed the chosen predecessor into 2 bits per matrix
(see ``ops.dp``), so traceback here is a pure O(path-length) pointer chase —
no scoring lookups, no equality checks, bit-identical paths.

Skewed addressing: cell (y, x) (x along seq_a, y along seq_b, both 1-based
interior) lives at ``arr[x + y - 2, y]`` of a (D, LB+1) per-pair slice.

SW multi-hit enumeration mirrors smith_waterman.c:131-277: candidates are
all cells with M > 0 sorted by (score desc, x asc, flat-index asc); each
emitted path marks every visited cell in a mask, and a walk that touches an
already-visited cell aborts *leaving its partial marks in place*
(smith_waterman.c:187-190).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ..scoring.config import ScoringConfig, encode
from .dp import DIR_FAIL, GAP_A, GAP_B, MATCH
from .host_dp import Alignment  # canonical result record (jax-free module)


class ChunkedDirs:
    """Direction-code accessor over per-chunk local-diagonal arrays from
    ``dp.fill_chunked`` (one pair's slices): cell (y, x) lives in chunk
    (x-1)//CA at row (x - c*CA) + y - 2, lane y."""

    def __init__(self, chunks, CA: int):
        self.chunks = chunks  # list of (D_c, LB+1) arrays
        self.CA = CA

    def code(self, y: int, x: int) -> int:
        c, xl = divmod(x - 1, self.CA)
        return int(self.chunks[c][xl + 1 + y - 2, y])


class ChunkedM:
    """SW MATCH-matrix accessor over per-chunk arrays (one pair)."""

    def __init__(self, chunks, CA: int):
        self.chunks = chunks
        self.CA = CA

    def at(self, y: int, x: int) -> int:
        c, xl = divmod(x - 1, self.CA)
        return int(self.chunks[c][xl + 1 + y - 2, y])


def _dir_at(dirs, y: int, x: int, matrix: int) -> int:
    if isinstance(dirs, np.ndarray):
        code = int(dirs[x + y - 2, y])
    else:
        code = dirs.code(y, x)
    return (code >> (2 * matrix)) & 3


def nw_start(corner) -> tuple[int, int]:
    """Start matrix preference GAP_A >= GAP_B >= MATCH over the corner cell
    (needleman_wunsch.c:53-66). corner = (M, Ga, Gb) at (nb, na)."""
    m, ga, gb = int(corner[0]), int(corner[1]), int(corner[2])
    curr, score = MATCH, m
    if gb >= score:
        curr, score = GAP_B, gb
    if ga >= score:
        curr, score = GAP_A, ga
    return curr, score


def nw_traceback(
    seq_a, seq_b, na: int, nb: int, dirs: np.ndarray, corner
) -> Alignment:
    """Rebuild the global alignment strings (needleman_wunsch.c:34-146)."""
    a, b = encode(seq_a), encode(seq_b)
    curr, score = nw_start(corner)
    out_a, out_b = [], []
    x, y = int(na), int(nb)
    while x > 0 and y > 0:
        if curr == MATCH:
            out_a.append(chr(a[x - 1]))
            out_b.append(chr(b[y - 1]))
            nxt = _dir_at(dirs, y, x, MATCH)
            x, y = x - 1, y - 1
        elif curr == GAP_A:
            out_a.append("-")
            out_b.append(chr(b[y - 1]))
            nxt = _dir_at(dirs, y, x, GAP_A)
            y = y - 1
        else:
            out_a.append(chr(a[x - 1]))
            out_b.append("-")
            nxt = _dir_at(dirs, y, x, GAP_B)
            x = x - 1
        if nxt == DIR_FAIL:
            raise RuntimeError(
                "traceback fail: no predecessor matches (alignment.c:329-349)"
            )
        curr = nxt
    # leading unaligned prefix as gap runs (needleman_wunsch.c:117-132)
    while y > 0:
        out_a.append("-")
        out_b.append(chr(b[y - 1]))
        y -= 1
    while x > 0:
        out_a.append(chr(a[x - 1]))
        out_b.append("-")
        x -= 1
    ra = "".join(reversed(out_a))
    rb = "".join(reversed(out_b))
    return Alignment(ra, rb, score, 0, 0, len(a), len(b))


def _roundup2pow(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class SwRefMaskHistory:
    """Opt-in bug-compatible emulation of the reference's shared
    ``sw_history_t`` overlap mask (smith_waterman.c:20-59,95-108,149).

    The reference allocates ONE bitset per sw aligner, reused across every
    pair the process aligns: it grows to ``roundup2pow(arr_size)`` bits
    (realloc zeroes only the new words, smith_waterman.c:37-45), and between
    pairs ``memset(b, 0, (l+31)/32)`` clears (l+31)/32 *bytes* of the
    uint32-word buffer — one quarter of the mask — so stale marks from
    earlier pairs can suppress hits whose traceback walk touches a stale
    flat index.  Our default semantics reset the mask fully per pair
    (documented deviation, README); enabling this class (env
    ``SEQALIGN_SW_REF_MASK=1`` or ``SmithWaterman(ref_mask_compat=True)``)
    reproduces the reference bit-for-bit on multi-pair runs.

    Iterators sharing one history must be consumed in pair order (the CLI
    file loop does) — the reference interleaves align/fetch the same way.
    """

    def __init__(self):
        self.capacity = 256  # _init_history, smith_waterman.c:88-94
        self.bits = np.zeros(256, dtype=bool)

    def begin_pair(self, arr_size: int) -> np.ndarray:
        """smith_waterman_align2's mask lifecycle for one pair
        (smith_waterman.c:95-108,149); returns the shared mask array."""
        if arr_size > self.capacity:
            cap = _roundup2pow(arr_size)
            grown = np.zeros(cap, dtype=bool)
            grown[: self.capacity] = self.bits  # realloc keeps old bits
            self.bits, self.capacity = grown, cap
        # memset((l+31)/32 bytes) clears bits [0, 8*((l+31)/32)) only
        cleared = min(8 * ((self.capacity + 31) // 32), self.capacity)
        self.bits[:cleared] = False
        return self.bits


class SwHitIterator:
    """Stateful best-first local-hit enumerator (smith_waterman.c:131-277).

    Built from one pair's device outputs: skewed M matrix + direction codes.
    ``fetch()`` mirrors smith_waterman_fetch, including overlap masking and
    partial-walk abort semantics.  With ``history`` (a shared
    :class:`SwRefMaskHistory`), the overlap mask is the reference's shared
    buggy-reset bitset, bound lazily at the first fetch so sequential
    consumption reproduces the reference's align/fetch interleaving.
    """

    def __init__(
        self,
        sc: ScoringConfig,
        seq_a,
        seq_b,
        na: int,
        nb: int,
        dirs: np.ndarray,
        mmat: Optional[np.ndarray] = None,
        history: Optional[SwRefMaskHistory] = None,
        candidates: Optional[tuple] = None,
        min_score: Optional[int] = None,
        pre_paths: Optional[dict] = None,
        walker=None,
    ):
        self.sc = sc
        self.a, self.b = encode(seq_a), encode(seq_b)
        self.na, self.nb = int(na), int(nb)
        self.dirs = dirs
        self.mmat = mmat
        _, self.sub_lut, _, _ = sc.luts()
        w = self.na + 1
        self.w = w
        # pruning threshold: candidates below it can never be emitted before
        # the CLI's min-score break, so skipping them is output-invariant for
        # best-first consumers (an optimization hint, not a semantic change
        # for full-stream iteration — callers opting in know hits < min_score
        # are dropped)
        thr = 1 if min_score is None else max(1, int(min_score))

        # Candidates: interior cells with M >= thr, best-first.  The
        # reference sorts flat indices with a stable qsort on (score desc,
        # x asc) (smith_waterman.c:71-86,153-161); full ties keep flat-index
        # order.  ``candidates`` (device-extracted (flats, scores) from
        # ``dp.sw_extract_candidates``) skips host enumeration — and then
        # the M matrix itself is never needed on host: each walk's start
        # score rides with its candidate.
        ys, xs, scores = [], [], []
        if candidates is not None:
            flat = candidates[0].astype(np.int64)
            sc_ = candidates[1].astype(np.int64)
            xc = flat % w
        elif isinstance(mmat, np.ndarray):
            for y in range(1, self.nb + 1):
                row = mmat[y - 1 : y - 1 + self.na, y]  # x = 1..na
                pos = np.nonzero(row >= thr)[0]
                ys.append(np.full(len(pos), y, dtype=np.int64))
                xs.append(pos + 1)
                scores.append(row[pos].astype(np.int64))
        else:  # ChunkedM: per-chunk slabs of the x axis
            for ci, arr in enumerate(mmat.chunks):
                x_base = ci * mmat.CA
                max_xl = min(mmat.CA, self.na - x_base)
                if max_xl < 1:
                    break
                for y in range(1, self.nb + 1):
                    row = arr[y - 1 : y - 1 + max_xl, y]  # local x = 1..
                    pos = np.nonzero(row >= thr)[0]
                    ys.append(np.full(len(pos), y, dtype=np.int64))
                    xs.append(x_base + pos + 1)
                    scores.append(row[pos].astype(np.int64))
        if candidates is None:
            if ys:
                yc = np.concatenate(ys)
                xc = np.concatenate(xs)
                sc_ = np.concatenate(scores)
                flat = yc * w + xc
            else:
                flat = xc = sc_ = np.zeros(0, dtype=np.int64)
        if len(flat):
            order = np.lexsort((flat, xc, -sc_))
            self.cand = flat[order]
            self.cand_scores = sc_[order]
        else:
            self.cand = np.zeros(0, dtype=np.int64)
            self.cand_scores = np.zeros(0, dtype=np.int64)
        # device-walked op traces: pre_paths maps candidate flat index ->
        # int8 op row; walker(flats, scores) -> dict walks further
        # candidates in batched device rounds (paths are mask-independent,
        # so they can be precomputed; fetch() replays the masking here)
        self.pre_paths = pre_paths
        self.walker = walker
        self._history = history
        if history is None:
            self.mask: Optional[np.ndarray] = np.zeros(
                (self.nb + 1) * w, dtype=bool
            )
        else:
            self.mask = None  # bound at first fetch via begin_pair
        self.next_hit = 0

    def _penalty(self, curr: int, nxt: int, y: int, x: int) -> int:
        """Score drop for one reverse move (alignment.c:264-307)."""
        sc = self.sc
        if curr == MATCH:
            return int(self.sub_lut[self.a[x - 1], self.b[y - 1]])
        gop = sc.gap_open + sc.gap_extend
        ge = sc.gap_extend
        if curr == GAP_A:
            if sc.no_end_gap_penalty and x == self.na:
                return 0
            return ge if nxt == GAP_A else gop
        if sc.no_end_gap_penalty and y == self.nb:
            return 0
        return ge if nxt == GAP_B else gop

    def _follow_hit(self, flat: int, end_score: int) -> Optional[Alignment]:
        w = self.w
        x, y = int(flat % w), int(flat // w)
        end_x, end_y = x, y
        curr, cs = MATCH, end_score
        path = []
        while True:
            if self.mask[y * w + x]:
                return None  # overlap abort; prior marks stay (sw.c:187-190)
            self.mask[y * w + x] = True
            if cs == 0:
                break
            path.append((curr, x, y))
            nxt = _dir_at(self.dirs, y, x, curr)
            if nxt == DIR_FAIL:
                raise RuntimeError("sw traceback fail")
            cs -= self._penalty(curr, nxt, y, x)
            if curr == MATCH:
                x, y = x - 1, y - 1
            elif curr == GAP_A:
                y -= 1
            else:
                x -= 1
            curr = nxt
        out_a, out_b = [], []
        for q, px, py in path:
            if q == MATCH:
                out_a.append(chr(self.a[px - 1]))
                out_b.append(chr(self.b[py - 1]))
            elif q == GAP_A:
                out_a.append("-")
                out_b.append(chr(self.b[py - 1]))
            else:
                out_a.append(chr(self.a[px - 1]))
                out_b.append("-")
        return Alignment(
            "".join(reversed(out_a)),
            "".join(reversed(out_b)),
            end_score,
            pos_a=x,
            pos_b=y,
            len_a=end_x - x,
            len_b=end_y - y,
        )

    def _follow_hit_path(self, flat: int, end_score: int,
                         ops: np.ndarray) -> Optional[Alignment]:
        """Replay of :meth:`_follow_hit` over a device-walked op trace:
        identical marking/abort semantics (smith_waterman.c:165-258), no
        direction-code access."""
        w = self.w
        x0, y0 = int(flat % w), int(flat // w)
        n = int(np.count_nonzero(ops >= 0))
        op = ops[:n].astype(np.int64)
        if (op == DIR_FAIL).any():
            raise RuntimeError("sw traceback fail")
        dx = (op != GAP_A).astype(np.int64)
        dy = (op != GAP_B).astype(np.int64)
        xs = x0 - np.concatenate([[0], np.cumsum(dx)])  # n+1 incl. terminal
        ys = y0 - np.concatenate([[0], np.cumsum(dy)])
        flats = ys * w + xs
        vm = self.mask[flats]
        if vm.any():
            k = int(np.argmax(vm))
            # marks before the abort stay (smith_waterman.c:187-190)
            self.mask[flats[:k]] = True
            return None
        self.mask[flats] = True
        ca = np.where(op == GAP_A, ord("-"),
                      self.a[np.maximum(xs[:n] - 1, 0)] if len(self.a)
                      else ord("-"))
        cb = np.where(op == GAP_B, ord("-"),
                      self.b[np.maximum(ys[:n] - 1, 0)] if len(self.b)
                      else ord("-"))
        ra = ca[::-1].astype(np.uint8).tobytes().decode()
        rb = cb[::-1].astype(np.uint8).tobytes().decode()
        tx, ty = int(xs[-1]), int(ys[-1])
        return Alignment(ra, rb, end_score, pos_a=tx, pos_b=ty,
                         len_a=x0 - tx, len_b=y0 - ty)

    def _path_for(self, pos: int):
        if self.pre_paths is None:
            return None
        flat = int(self.cand[pos])
        ops = self.pre_paths.get(flat)
        if ops is None and self.walker is not None:
            hi = min(pos + 64, len(self.cand))
            need = [k for k in range(pos, hi)
                    if int(self.cand[k]) not in self.pre_paths]
            if need:
                self.pre_paths.update(self.walker(
                    self.cand[need], self.cand_scores[need]))
            ops = self.pre_paths.get(flat)
        return ops

    def fetch(self) -> Optional[Alignment]:
        if self.mask is None:
            self.mask = self._history.begin_pair((self.nb + 1) * self.w)
        while self.next_hit < len(self.cand):
            pos = self.next_hit
            flat = int(self.cand[pos])
            score = int(self.cand_scores[pos])
            self.next_hit += 1
            if not self.mask[flat]:
                ops = self._path_for(pos)
                if ops is not None:
                    hit = self._follow_hit_path(flat, score, ops)
                else:
                    hit = self._follow_hit(flat, score)
                if hit is not None:
                    return hit
        return None

    def __iter__(self) -> Iterator[Alignment]:
        while True:
            h = self.fetch()
            if h is None:
                return
            yield h


def nw_start_batch(corners: np.ndarray):
    """Vectorized :func:`nw_start` over (B, 3) corners: start matrix with
    the GAP_A >= GAP_B >= MATCH preference (needleman_wunsch.c:53-66)."""
    m, ga, gb = (corners[:, 0].astype(np.int64),
                 corners[:, 1].astype(np.int64),
                 corners[:, 2].astype(np.int64))
    curr = np.full(len(corners), MATCH, np.int64)
    score = m.copy()
    upd = gb >= score
    curr[upd] = GAP_B
    score[upd] = gb[upd]
    upd = ga >= score
    curr[upd] = GAP_A
    score[upd] = ga[upd]
    return curr, score


def nw_traceback_batch(seqs_a, seqs_b, na, nb, code_at, corners):
    """Vectorized global traceback over a whole bucket: walks every
    pair's direction codes simultaneously with numpy steps instead of a
    per-pair Python pointer chase (which dominated end-to-end CLI time at
    3-5 ms/pair vs the kernel fill's ~3 us/pair).

    ``code_at(idx, y, x)`` gathers packed direction bytes for vectors of
    (pair index, y, x) — the caller binds it to whichever fill layout
    produced the codes.  Bit-identical to per-pair :func:`nw_traceback`
    (same step rule, needleman_wunsch.c:34-146 + alignment.c:244-350);
    raises on DIR_FAIL like the reference's abort."""
    B = len(seqs_a)
    na = np.asarray(na, np.int64)
    nb = np.asarray(nb, np.int64)
    curr, score = nw_start_batch(np.asarray(corners))
    X = na.copy()
    Y = nb.copy()
    # ops/x/y traces, one row per step (walk length <= na + nb)
    cap = int((na + nb).max(initial=0))
    ops = np.full((B, cap), -1, np.int8)
    xs_t = np.zeros((B, cap), np.int32)
    ys_t = np.zeros((B, cap), np.int32)
    step = 0
    idx_all = np.arange(B, dtype=np.int64)
    while True:
        active = (X > 0) & (Y > 0)
        if not active.any():
            break
        ai = idx_all[active]
        code = code_at(ai, Y[active], X[active]).astype(np.int64)
        nxt = (code >> (2 * curr[active])) & 3
        if (nxt == DIR_FAIL).any():
            raise RuntimeError(
                "traceback fail: no predecessor matches "
                "(alignment.c:329-349)")
        ops[ai, step] = curr[active]
        xs_t[ai, step] = X[active]
        ys_t[ai, step] = Y[active]
        mv = curr[active]
        X[active] -= (mv != GAP_A)
        Y[active] -= (mv != GAP_B)
        curr[active] = nxt
        step += 1
    # leading unaligned prefixes as gap runs (needleman_wunsch.c:117-132)
    out = []
    for j in range(B):
        a = encode(seqs_a[j])
        b = encode(seqs_b[j])
        n = int(np.count_nonzero(ops[j] >= 0))
        op = ops[j, :n][::-1].astype(np.int64)
        xv = xs_t[j, :n][::-1].astype(np.int64)
        yv = ys_t[j, :n][::-1].astype(np.int64)
        ca = np.where(op == GAP_A, ord("-"),
                      a[np.maximum(xv - 1, 0)] if len(a) else ord("-"))
        cb = np.where(op == GAP_B, ord("-"),
                      b[np.maximum(yv - 1, 0)] if len(b) else ord("-"))
        # prefix: remaining y then x consumed as gap runs, reversed
        py = int(Y[j])
        px = int(X[j])
        pre_a = np.concatenate([
            a[:px], np.full(py, ord("-"), np.uint8)])
        pre_b = np.concatenate([
            np.full(px, ord("-"), np.uint8), b[:py]])
        ra = pre_a.tobytes().decode() + ca.astype(np.uint8).tobytes().decode()
        rb = pre_b.tobytes().decode() + cb.astype(np.uint8).tobytes().decode()
        out.append(Alignment(ra, rb, int(score[j]), 0, 0, len(a), len(b)))
    return out


def nw_walk_device(dirs_dev, gather_fn, corners, na, nb, cap: int):
    """Walk every pair's traceback ON DEVICE and fetch only the (B, cap)
    int8 op trace (~1 byte/step) instead of the full direction-code
    tensor (~2 bytes per cell in the skewed layout).

    ``gather_fn(dirs_dev, X, Y)`` returns each pair's packed code byte at
    cell (Y, X) as a jnp vector — bound per fill layout.  ``corners`` may
    be a DEVICE (B, 3) array: the start-matrix pick runs on device so the
    whole walk costs ONE host round trip.  Returns the op trace (B, cap)
    int8 (op = matrix walked at each step, -1 once done; DIR_FAIL
    surfaces as a 3 in the NEXT step) plus the start scores.  ``cap`` is
    rounded up to a multiple of 256 to bound compile-shape count on
    ragged batches."""
    import jax.numpy as jnp

    cap = -(-cap // 256) * 256
    walk = _walk_jit(gather_fn, cap)
    ops, score = walk(
        dirs_dev, jnp.asarray(na, jnp.int32), jnp.asarray(nb, jnp.int32),
        jnp.asarray(corners))
    return np.asarray(ops), np.asarray(score)


_WALK_CACHE: dict = {}


def _walk_jit(gather_fn, cap: int):
    """One jitted walk per (gather closure, step bound): callers must
    hand in a stable gather_fn (see aligners._xla_gather) or every batch
    pays a ~0.7s recompile."""
    key = (id(gather_fn), cap)
    fn = _WALK_CACHE.get(key)
    if fn is not None:
        return fn
    import jax
    import jax.numpy as jnp

    @jax.jit
    def walk(dirs, X, Y, corners):
        # start-matrix preference GAP_A >= GAP_B >= MATCH on device
        # (needleman_wunsch.c:53-66)
        m, ga, gb = (corners[:, 0].astype(jnp.int32),
                     corners[:, 1].astype(jnp.int32),
                     corners[:, 2].astype(jnp.int32))
        curr = jnp.full(corners.shape[0], MATCH, jnp.int32)
        score = m
        curr = jnp.where(gb >= score, GAP_B, curr)
        score = jnp.maximum(score, gb)
        curr = jnp.where(ga >= score, GAP_A, curr)
        score = jnp.maximum(score, ga)

        def step(carry, _):
            X, Y, curr = carry
            active = (X > 0) & (Y > 0)
            code = gather_fn(dirs, X, Y).astype(jnp.int32)
            nxt = (code >> (2 * curr)) & 3
            op = jnp.where(active, curr, -1).astype(jnp.int8)
            X = jnp.where(active & (curr != GAP_A), X - 1, X)
            Y = jnp.where(active & (curr != GAP_B), Y - 1, Y)
            curr = jnp.where(active, nxt, curr)
            return (X, Y, curr), op

        (_, _, _), ops = jax.lax.scan(step, (X, Y, curr), None,
                                      length=cap)
        return ops.T, score  # (B, cap), (B,)

    # keep the gather closure alive so its id stays unique
    _WALK_CACHE[key] = walk
    walk._gather_ref = gather_fn
    return walk


def nw_strings_from_ops(seqs_a, seqs_b, na, nb, ops, score):
    """Rebuild alignment strings from a device-walked op trace: the
    (X, Y) coordinates at every step are recovered with cumsums, then
    the characters come from vectorized gathers — no per-step Python."""
    na = np.asarray(na, np.int64)
    nb = np.asarray(nb, np.int64)
    B = len(seqs_a)
    out = []
    for j in range(B):
        a = encode(seqs_a[j])
        b = encode(seqs_b[j])
        oj = ops[j]
        n = int(np.count_nonzero(oj >= 0))
        op = oj[:n].astype(np.int64)
        if (op == DIR_FAIL).any():
            raise RuntimeError(
                "traceback fail: no predecessor matches "
                "(alignment.c:329-349)")
        # X/Y before each step: X decreases on MATCH/GAP_B, Y on
        # MATCH/GAP_A
        dx = (op != GAP_A).astype(np.int64)
        dy = (op != GAP_B).astype(np.int64)
        xv = na[j] - np.concatenate([[0], np.cumsum(dx)[:-1]])
        yv = nb[j] - np.concatenate([[0], np.cumsum(dy)[:-1]])
        px = int(na[j] - dx.sum())
        py = int(nb[j] - dy.sum())
        op = op[::-1]
        xv = xv[::-1]
        yv = yv[::-1]
        ca = np.where(op == GAP_A, ord("-"),
                      a[np.maximum(xv - 1, 0)] if len(a) else ord("-"))
        cb = np.where(op == GAP_B, ord("-"),
                      b[np.maximum(yv - 1, 0)] if len(b) else ord("-"))
        pre_a = np.concatenate([a[:px], np.full(py, ord("-"), np.uint8)])
        pre_b = np.concatenate([np.full(px, ord("-"), np.uint8), b[:py]])
        ra = pre_a.tobytes().decode() + \
            ca.astype(np.uint8).tobytes().decode()
        rb = pre_b.tobytes().decode() + \
            cb.astype(np.uint8).tobytes().decode()
        out.append(Alignment(ra, rb, int(score[j]), 0, 0, len(a), len(b)))
    return out


_SW_WALK_CACHE: dict = {}


def sw_walk_jit(gather_w, cap: int, lut_mode: bool):
    """One jitted SW candidate walk per (pair-meta closure, step bound,
    scoring mode).  ``gather_w(dirs, jw, X, Y)`` gathers packed code
    bytes for per-walk pair indices ``jw`` (bound per fill layout with
    numpy metadata constants — see aligners).  The walk replays
    smith_waterman.c:165-258's reverse stepping WITHOUT the overlap
    mask: paths depend only on the direction codes and per-step
    penalties, so the host can replay the masking/abort semantics over
    the fetched op traces afterwards."""
    key = (id(gather_w), cap, lut_mode)
    fn = _SW_WALK_CACHE.get(key)
    if fn is not None:
        return fn
    import jax
    import jax.numpy as jnp

    @jax.jit
    def walk(dirs, acd, bcd, subK, jw, X, Y, cs, mt, mm, gop, ge):
        def step(carry, _):
            X, Y, curr, cs = carry
            active = cs > 0
            Xc = jnp.maximum(X, 1)
            Yc = jnp.maximum(Y, 1)
            code = gather_w(dirs, jw, Xc, Yc).astype(jnp.int32)
            nxt = (code >> (2 * curr)) & 3
            ai = acd[jw, Xc - 1]
            bi = bcd[jw, Yc - 1]
            if lut_mode:
                sub = subK[ai, bi]
            else:
                sub = jnp.where(ai == bi, mt, mm)
            pen = jnp.where(curr == MATCH, sub,
                            jnp.where(nxt == curr, ge, gop))
            op = jnp.where(active, curr, -1).astype(jnp.int8)
            cs = jnp.where(active, cs - pen, cs)
            X = jnp.where(active & (curr != GAP_A), X - 1, X)
            Y = jnp.where(active & (curr != GAP_B), Y - 1, Y)
            curr = jnp.where(active, nxt, curr)
            return (X, Y, curr, cs), op

        curr0 = jnp.zeros_like(X) + MATCH
        (_, _, _, _), ops = jax.lax.scan(
            step, (X, Y, curr0, cs), None, length=cap)
        return ops.T  # (W, cap)

    _SW_WALK_CACHE[key] = walk
    walk._gather_ref = gather_w
    return walk


class SwDeviceWalker:
    """Batched on-device SW candidate walker: walks candidate paths for
    many (pair, cell, score) starts in one device call and returns int8
    op traces — the direction-code tensor never transfers to host."""

    def __init__(self, dirs_dev, gather_w, acd, bcd, subK, *, lut_mode,
                 mt, mm, gop, ge):
        self.dirs = dirs_dev
        self.gather_w = gather_w
        self.acd = acd
        self.bcd = bcd
        self.subK = subK
        self.lut_mode = lut_mode
        self.scal = (np.int32(mt), np.int32(mm), np.int32(gop),
                     np.int32(ge))

    def walk(self, jw, x0, y0, s0):
        import jax.numpy as jnp

        cap = int(-(-max(int((np.asarray(x0) + np.asarray(y0)).max(
            initial=1)), 1) // 256) * 256)
        fn = sw_walk_jit(self.gather_w, cap, self.lut_mode)
        mt, mm, gop, ge = self.scal
        ops = np.asarray(fn(
            self.dirs, self.acd, self.bcd, self.subK,
            jnp.asarray(jw, jnp.int32), jnp.asarray(x0, jnp.int32),
            jnp.asarray(y0, jnp.int32), jnp.asarray(s0, jnp.int32),
            mt, mm, gop, ge))
        return ops
