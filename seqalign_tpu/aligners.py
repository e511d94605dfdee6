"""High-level aligner API: the JAX equivalent of the reference's
``needleman_wunsch_{new,align}`` / ``smith_waterman_{new,align,fetch}``
surface (needleman_wunsch.h:22-32, smith_waterman.h:21-39).

Two execution paths, routed per call by workload size:

* **host** (``ops/host_dp.py``): vectorized numpy fill + reverse-move
  traceback.  No JAX import, no backend init, no compile — a single small
  pair answers in milliseconds, like the reference binary.  This is the
  latency path the CLIs ride.
* **device**: batched fills, length-bucketed, padded so repeated batches
  reuse compiled programs.  This is the throughput path (the reference
  aligns pairs serially in a callback loop, alignment_cmdline.c:611-622).
  Every device fill is the XLA wavefront (``ops/dp.py``) except eligible
  scores-only batches on a GPU, which take the Pallas/Triton kernel
  (``ops/scores_gpu.py``).  :func:`_scores_route` is the one place that
  choice is made.

Routing: batches whose total cell count exceeds ``HOST_MAX_CELLS`` (or with
enough pairs to amortize a device dispatch) go to the device; everything
else stays on host.  ``SEQALIGN_FORCE=host|device`` pins the path (tests
use it to cover both).  Results are bit-identical either way — both paths
are pinned to the reference by the golden corpus.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from .ops import host_dp
from .ops.host_dp import Alignment
from .scoring.config import ScoringConfig
from .scoring.presets import scoring_system_default, scoring_system_sw_default

# Route to the device above this much total DP work (cells) or this many
# pairs per batch; below it, vectorized numpy fills answer faster than a
# device dispatch (and infinitely faster than a cold backend+compile).
HOST_MAX_CELLS = int(os.environ.get("SEQALIGN_HOST_MAX_CELLS", 4_000_000))
HOST_MAX_PAIRS = 32

# Beyond this many cells per pair, a traceback fill routes to the chunked
# boundary-carry path (dp.fill_chunked) to bound device memory.
LONG_PAIR_CELLS = 112_000_000  # > 10240^2: 1-10kb reads never go per-pair

# Peak device bytes per padded cell of one XLA wavefront fill (``dp_fill``:
# the skewed int32 substitution profile and its shear copies, plus the
# skewed outputs), read from ``compiled.memory_analysis()`` on an H100 at
# B=16, LA=LB=2048 and 4096.  The Triton scores kernel needs O(B*(LA+LB)).
XLA_BYTES_PER_CELL = {"scores": 12, "dirs": 14, "dirs_m": 20}
# The SW candidate harvest's top_k, per skewed M cell (see _harvest).
HARVEST_BYTES_PER_CELL = 32
# Pairs per kernel-route scores launch: the kernel runs one pair per
# thread, so a launch needs thousands of pairs to put a warp on each SM.
KERNEL_FLUSH_PAIRS = 4096
# Share of the device allocator's limit that the fills in flight may take.
DEVICE_MEMORY_SHARE = 0.5
_HOST_BUDGET = 4 << 30  # backends that report no limit (the CPU)

# Device dispatches by route, for tests and the smoke run to prove which
# path served a call ("scores_kernel", "scores_xla", "dirs_xla", ...).
_DISPATCHES: dict = {}


def _note_dispatch(what: str) -> None:
    _DISPATCHES[what] = _DISPATCHES.get(what, 0) + 1


def dispatch_counts() -> dict:
    """Snapshot of device dispatches by route."""
    return dict(_DISPATCHES)


def _route(total_cells: int, n_pairs: int,
           sc: Optional[ScoringConfig] = None) -> str:
    # Sentinel-wrap regime (NW only — SW clamps at 0 and has no sentinel,
    # so SW call sites pass sc=None): constrained modes whose per-step
    # penalties exceed the frozen |min_penalty| headroom.  There the
    # REFERENCE overflows int32 (C UB) and aborts with 'Program error:
    # traceback fail'; our int32 device fills would wrap the same way, so
    # this regime always takes the int64 host path and returns the
    # mathematically optimal alignment instead (documented deviation,
    # README).  Checked before SEQALIGN_FORCE: semantics beat test pins.
    if sc is not None and sc.sentinel_wrap_risk():
        return "host"
    force = os.environ.get("SEQALIGN_FORCE", "")
    if force in ("host", "device"):
        return force
    if total_cells <= HOST_MAX_CELLS and n_pairs <= HOST_MAX_PAIRS:
        return "host"
    return "device"


def _scores_route(sc: ScoringConfig, is_sw: bool, la: int, lb: int) -> str:
    """The device tier's one routing decision for a scores batch padded to
    (la, lb): ``"kernel"`` (the Triton fill, compiled for the GPU),
    ``"interpret"`` (the same kernel in the Pallas interpreter — only when
    ``SEQALIGN_PALLAS=interpret``, for tests) or ``"xla"``.

    ``SEQALIGN_PALLAS=off`` pins XLA (the A/B baseline).  A kernel failure
    is never caught: it propagates to the caller."""
    mode = os.environ.get("SEQALIGN_PALLAS", "")
    if mode not in ("", "off", "interpret"):
        raise ValueError("SEQALIGN_PALLAS must be unset, 'off' or "
                         "'interpret', not %r" % mode)
    from .ops import scores_gpu

    if mode == "off" or not scores_gpu.eligible(sc, is_sw, la, lb):
        return "xla"
    if mode == "interpret":
        return "interpret"
    import jax

    return "kernel" if jax.default_backend() == "gpu" else "xla"


def _device_budget() -> int:
    """Device bytes the fills in flight may take: a share of the first
    device's allocator limit (``memory_stats()["bytes_limit"]``)."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit") or _HOST_BUDGET
    return int(limit * DEVICE_MEMORY_SHARE)


def _xla_pairs_cap(la: int, lb: int, path: str) -> int:
    """Pairs per XLA fill of padded shape (la, lb) that fit the device
    budget.  Fills run one after another on the device's stream, and
    their planes are temporaries, so one fill's planes are counted; the
    fills queued behind it hold only their small inputs."""
    # the skewed planes span (la + lb) diagonals of lb lanes, so a
    # lopsided bucket costs up to its longer side squared
    per_pair = XLA_BYTES_PER_CELL[path] * max(la, lb) ** 2
    return max(1, _device_budget() // per_pair)


def _scores_auto(sc: ScoringConfig, seqs_a, seqs_b, *, is_sw: bool,
                 defer: bool = False):
    """Scores-only batch dispatch: host numpy for small workloads, the
    Triton kernel or the XLA scan per :func:`_scores_route`.  Bit-identical
    results every way (tests/test_scores_gpu.py, tests/test_host_path.py).

    ``defer=True`` skips the result fetch on device paths (returns the
    in-flight jax array): callers streaming many batches overlap the next
    batch's host IO/pack with this batch's device fill and fetch at the
    end (parallel/distributed.distributed_score_file)."""
    cells = sum(len(a) * len(b) for a, b in zip(seqs_a, seqs_b))
    if _route(cells, len(seqs_a), None if is_sw else sc) == "host":
        out = np.zeros(len(seqs_a), np.int32)
        for i, (a, b) in enumerate(zip(seqs_a, seqs_b)):
            M, Ga, Gb = host_dp.fill_matrices(sc, a, b, is_sw)
            if is_sw:
                out[i] = M.max(initial=0)
            else:
                out[i] = max(M[-1, -1], Ga[-1, -1], Gb[-1, -1])
        return out

    import jax.numpy as jnp

    from .ops import dp

    for sa, sb in zip(seqs_a, seqs_b):
        dp.check_valid_pairs(sc, sa, sb)
    # pow2 batch-count padding: a distinct B is a distinct jit shape, and
    # streaming buckets flush at ragged sizes.  Fillers record length 1;
    # every return slices back to n.
    n = len(seqs_a)
    npad = dp._next_pow2(max(8, n))
    if npad != n:
        seqs_a = list(seqs_a) + [""] * (npad - n)
        seqs_b = list(seqs_b) + [""] * (npad - n)
    na = dp.seq_lens(seqs_a)
    nb = dp.seq_lens(seqs_b)
    na[n:] = 1
    nb[n:] = 1
    route = "xla"
    if min(na.min(initial=1), nb.min(initial=1)) >= 1:
        la = dp.pad_width(int(na.max(initial=1)))
        lb = dp.pad_width(int(nb.max(initial=1)))
        route = _scores_route(sc, is_sw, la, lb)
    if route != "xla":
        from .ops.scores_gpu import scores_gpu

        # longest pairs first, so each kernel block is homogeneous
        order = np.lexsort((-nb, -na))
        ac, bc, _, _ = dp.pack_inputs_mm(
            sc, [seqs_a[i] for i in order], [seqs_b[i] for i in order],
            la, lb)
        out = scores_gpu(
            jnp.asarray(ac), jnp.asarray(bc), jnp.asarray(na[order]),
            jnp.asarray(nb[order]), is_sw=is_sw,
            nsg=sc.no_start_gap_penalty, neg=sc.no_end_gap_penalty,
            match=sc.match, mismatch=sc.mismatch, go=sc.gap_open,
            ge=sc.gap_extend, mn=sc.dp_floor(is_sw),
            interpret=route == "interpret")
        out = out[jnp.asarray(np.argsort(order)[:n])]
        _note_dispatch("scores_kernel")
        return out if defer else np.asarray(out)
    out, _, _ = dp.fill_batch(
        sc, seqs_a, seqs_b, is_sw=is_sw, emit_dirs=False, pow2_pad=True,
        validate=False,
    )
    _note_dispatch("scores_xla")
    res = out.best[:n] if is_sw else out.corner.max(axis=1)[:n]
    return res if defer else np.asarray(res)


def _swap_symmetric(sc: ScoringConfig) -> bool:
    """True when score(a, b) == score(b, a) exactly, so a pair may be
    side-swapped for a better device layout: the substitution relation
    must be symmetric (equality scoring always is; matrix/wildcard
    configs iff the baked 256x256 LUT is) and the no-gaps flags must not
    distinguish the sides (gap penalties are side-symmetric in the
    recurrence, alignment.c:89-167; free start/end gaps apply to row 0
    and column 0 alike, alignment.c:59-81,122-145)."""
    if sc.no_gaps_in_a or sc.no_gaps_in_b:
        return False
    from .ops import dp

    if dp.mm_eligible(sc):
        return True
    sub = sc.luts()[1]
    return bool(np.array_equal(sub, sub.T))


def _scores_batch_cap(sc: ScoringConfig, is_sw: bool, la: int,
                      lb: int) -> Optional[int]:
    """Most pairs one scores dispatch of bucket (la, lb) may carry: None
    on the kernel route (its memory is O(B * (la + lb))), else the XLA
    fill's device budget.  Batches pad to a power of two, so the XLA cap
    is halved."""
    if _scores_route(sc, is_sw, la, lb) != "xla":
        return None
    from .ops import dp

    cap = _xla_pairs_cap(dp._next_pow2(la), dp._next_pow2(lb), "scores")
    return max(1, cap // 2)


def _scores_bucketed(sc: ScoringConfig, seqs_a, seqs_b, *,
                     is_sw: bool) -> np.ndarray:
    """Scores with length bucketing (mixed-length batches don't pad
    every pair to the global max — SURVEY §7 hard part 4) and, for
    symmetric configs, per-pair side canonicalization so the b side is
    the shorter one (the 1-10kb regime, BASELINE.json configs[4]).
    XLA buckets larger than the fill's memory budget are split; buckets
    on the kernel route merge into mixed-width batches of up to
    ``KERNEL_FLUSH_PAIRS`` (the kernel sorts them by length, and more
    pairs per launch keep more of the GPU busy)."""
    n = len(seqs_a)
    if n <= 1:
        return _scores_auto(sc, seqs_a, seqs_b, is_sw=is_sw)
    swap_ok = _swap_symmetric(sc)
    if swap_ok:
        sa = [a if len(a) >= len(b) else b
              for a, b in zip(seqs_a, seqs_b)]
        sb = [b if len(a) >= len(b) else a
              for a, b in zip(seqs_a, seqs_b)]
    else:
        sa, sb = list(seqs_a), list(seqs_b)
    out = np.zeros(n, np.int32)
    batches, mixed = [], []
    for key, idx in _buckets(sa, sb, long_key=False):
        cells = sum(len(sa[i]) * len(sb[i]) for i in idx)
        cap = len(idx)
        if _route(cells, len(idx), None if is_sw else sc) == "device":
            cap = _scores_batch_cap(sc, is_sw, *key)
            if cap is None:
                mixed.extend(idx)
                continue
        batches += [idx[s:s + cap] for s in range(0, len(idx), cap)]
    batches += [mixed[s:s + KERNEL_FLUSH_PAIRS]
                for s in range(0, len(mixed), KERNEL_FLUSH_PAIRS)]
    for sub in batches:
        out[sub] = _scores_auto(sc, [sa[i] for i in sub],
                                [sb[i] for i in sub], is_sw=is_sw)
    return out


def score_pairs_stream(sc: ScoringConfig, pairs, *, is_sw: bool,
                       flush_cells: Optional[int] = None,
                       flush_pairs: Optional[int] = None,
                       max_inflight: int = 4):
    """Streaming scores over an iterator of ``(idx, seq_a, seq_b)``:
    pairs accumulate into length buckets (side-canonicalized for
    symmetric configs), each bucket dispatches deferred once it holds
    ``flush_pairs`` pairs or ``flush_cells`` padded cells, and host IO /
    packing of later pairs overlaps the in-flight device fills (JAX
    dispatch is asynchronous; at most ``max_inflight`` batches stay
    un-fetched).  Yields ``(indices, scores)`` chunks.

    By default each bucket's flush is sized by the route it takes: on
    the kernel route all widths share one bucket of up to
    ``KERNEL_FLUSH_PAIRS`` pairs; on the XLA route a bucket flushes at
    1024 pairs or the device memory budget of one fill, whichever is
    smaller.

    This is the production path for large mixed-length workloads
    (BASELINE.json configs[4]; the reference streams pairs strictly
    serially, alignment_cmdline.c:611-622)."""
    from .ops import dp

    swap_ok = _swap_symmetric(sc)
    buckets: dict = {}
    inflight: list = []
    caps: dict = {}

    def bucket(key):
        """(bucket key, pair cap) for a padded-width key."""
        if key not in caps:
            cap = _scores_batch_cap(sc, is_sw, *key)
            if cap is None:
                caps[key] = ("kernel", flush_pairs or KERNEL_FLUSH_PAIRS)
            else:
                if flush_cells is not None:
                    cap = max(1, flush_cells // (key[0] * key[1]))
                caps[key] = (key, min(cap, flush_pairs or 1024))
        return caps[key]

    def dispatch(key):
        idxs, sa, sb = buckets.pop(key)
        out = _scores_auto(sc, sa, sb, is_sw=is_sw, defer=True)
        inflight.append((idxs, out))

    def drain(limit):
        while len(inflight) > limit:
            idxs, out = inflight.pop(0)
            yield np.asarray(idxs, np.int64), np.asarray(out)[:len(idxs)]

    for idx, a, b in pairs:
        if swap_ok and len(a) < len(b):
            a, b = b, a
        # padded-width buckets (pow2 then 1024-granular, dp.pad_width)
        key, cap = bucket((max(64, dp.pad_width(len(a))),
                           max(64, dp.pad_width(len(b)))))
        entry = buckets.setdefault(key, ([], [], []))
        entry[0].append(idx)
        entry[1].append(a)
        entry[2].append(b)
        if len(entry[0]) >= cap:
            dispatch(key)
            yield from drain(max_inflight)
    for key in list(buckets):
        dispatch(key)
    yield from drain(0)


_SW_PREWALK = 16  # candidates pre-walked per pair in the batched round
# device-walker cutover: above this many harvested candidates per pair,
# per-hit device walks lose to fetching the dirs once and walking on host
_SW_DEVWALK_CANDS = int(os.environ.get("SEQALIGN_SW_DEVWALK_CANDS",
                                       "4096"))


def _sw_prewalk(walker, cands_list, na):
    """One batched device round walking the top candidates of every
    pair (sorted with the iterator's exact tie order), plus per-pair
    walk-ahead closures for deeper consumers.  Returns (pre_paths list,
    walker-closure list)."""
    jws, x0s, y0s, s0s, owners = [], [], [], [], []
    tops = []
    for j, (flat, scv) in enumerate(cands_list):
        w = int(na[j]) + 1
        if len(flat):
            xc = flat % w
            order = np.lexsort((flat, xc, -scv))
            top = order[:_SW_PREWALK]
        else:
            top = np.zeros(0, np.int64)
        tops.append((flat, scv))
        jws.append(np.full(len(top), j, np.int64))
        x0s.append((flat[top] % w).astype(np.int64))
        y0s.append((flat[top] // w).astype(np.int64))
        s0s.append(scv[top].astype(np.int64))
        owners.append(flat[top])
    jw = np.concatenate(jws) if jws else np.zeros(0, np.int64)
    pre = [dict() for _ in cands_list]
    if len(jw):
        ops = walker.walk(jw, np.concatenate(x0s), np.concatenate(y0s),
                          np.concatenate(s0s))
        k = 0
        for j, fl in enumerate(owners):
            for f in fl:
                pre[j][int(f)] = ops[k]
                k += 1

    def mk(j):
        w = int(na[j]) + 1

        def walk_many(flats, scores):
            flats = np.asarray(flats, np.int64)
            ops = walker.walk(np.full(len(flats), j, np.int64),
                              flats % w, flats // w,
                              np.asarray(scores, np.int64))
            return {int(f): ops[i] for i, f in enumerate(flats)}

        return walk_many

    return pre, [mk(j) for j in range(len(cands_list))]


def _xla_gather(dirs, X, Y):
    """Device gather of each pair's code byte at cell (Y, X) from the XLA
    dp_fill dirs layout (B, D, LB+1)."""
    import jax.numpy as jnp

    return dirs[jnp.arange(dirs.shape[0]), X + Y - 2, Y]


def _xla_gather_walk(dirs, jw, X, Y):
    """Per-walk variant of :func:`_xla_gather`: ``jw`` are the pair
    indices of the walks (traceback.SwDeviceWalker)."""
    return dirs[jw, X + Y - 2, Y]


def _harvest(mmat, na, nb, mins):
    """``dp.sw_extract_candidates`` in pair groups that fit the device
    budget: its top_k sorts every skewed cell of a pair, which took
    ~24 bytes per cell on an H100 (47 GiB for 256 pairs of 2048^2)."""
    from .ops import dp

    per_pair = HARVEST_BYTES_PER_CELL * mmat.shape[1] * mmat.shape[2]
    step = max(1, _device_budget() // per_pair)
    mins = np.asarray(mins, np.int32)
    out = []
    for s in range(0, mmat.shape[0], step):
        out += dp.sw_extract_candidates(mmat[s:s + step], na[s:s + step],
                                        nb[s:s + step], mins[s:s + step])
    return out


def _xla_sw_walker(sc: ScoringConfig, dirs_dev, seqs_a, seqs_b):
    """Device SW candidate walker bound to an XLA dirs batch: the
    SwHitIterator replays masking over these op traces; the direction
    codes never leave the device (traceback.SwDeviceWalker).  Its per-step
    penalties have no free-end-gap rule, so callers keep
    ``no_end_gap_penalty`` configs on the host walk."""
    import jax.numpy as jnp

    from .ops import dp
    from .ops.traceback import SwDeviceWalker

    a, _ = dp.pad_batch(seqs_a)
    b, _ = dp.pad_batch(seqs_b)
    ac, bc, subK, _ = dp.compact_inputs(sc, a, b)
    return SwDeviceWalker(
        dirs_dev, _xla_gather_walk, jnp.asarray(ac), jnp.asarray(bc),
        jnp.asarray(subK), lut_mode=True, mt=sc.match, mm=sc.mismatch,
        gop=sc.gap_open + sc.gap_extend, ge=sc.gap_extend)


def _host_planes(dirs_dev):
    """Per-pair accessor to a device dirs batch that fetches the whole
    batch to host once, at the first read."""
    cache = []

    def planes(j):
        if not cache:
            cache.append(np.asarray(dirs_dev))
        return cache[0][j]

    return planes


class _LazyPlanes:
    """Deferred per-pair dirs plane: only materialized (device fetch) if
    a consumer actually reads a code — the device-walked SW path never
    does.  Implements the ``ops.traceback`` dirs-accessor protocol."""

    def __init__(self, planes_fn, j):
        self._fn = planes_fn
        self._j = j
        self._arr = None

    def code(self, y: int, x: int) -> int:
        if self._arr is None:
            self._arr = self._fn(self._j)
        return int(self._arr[x + y - 2, y])


def _buckets(seqs_a, seqs_b, long_key: bool = True):
    """Group pair indices by padded side widths (pow2 up to 4096, then
    1024-granular — dp.pad_width) so ragged batches don't pay max-length
    padding for every pair (SURVEY §7 hard part 4).  Buckets are floored
    at 64 to bound the number of distinct compiled shapes.  With
    ``long_key`` (the alignment paths, where dirs memory is O(n*m)),
    pairs over LONG_PAIR_CELLS go to the dedicated "long" bucket key
    None; scores-only callers pass False (their sub-batches are sized by
    :func:`_scores_batch_cap`)."""
    from .ops import dp

    groups = {}
    for i, (sa, sb) in enumerate(zip(seqs_a, seqs_b)):
        if long_key and len(sa) * len(sb) > LONG_PAIR_CELLS:
            key = None
        else:
            key = (max(64, dp.pad_width(len(sa))),
                   max(64, dp.pad_width(len(sb))))
        groups.setdefault(key, []).append(i)
    return groups.items()


def _align_steps(key, path: str) -> int:
    """Pairs per traceback fill of bucket ``key``: fill_batch pads both
    sides to powers of two."""
    from .ops import dp

    return _xla_pairs_cap(dp._next_pow2(key[0]), dp._next_pow2(key[1]),
                          path)


class NeedlemanWunsch:
    """Global affine-gap aligner (Gotoh), reference parity incl. traceback."""

    def __init__(self, scoring: Optional[ScoringConfig] = None):
        self.scoring = scoring if scoring is not None else scoring_system_default()

    def align(self, seq_a: str, seq_b: str) -> Alignment:
        return self.align_batch([seq_a], [seq_b])[0]

    def align_batch(
        self, seqs_a: Sequence[str], seqs_b: Sequence[str]
    ) -> List[Alignment]:
        if os.environ.get("SEQALIGN_REF_WRAP") == "1":
            # bug-compat: the reference's exact int32-wrap semantics incl.
            # the traceback-fail abort (README known deviations)
            return [host_dp.nw_align_ref_wrap(self.scoring, a, b)[0]
                    for a, b in zip(seqs_a, seqs_b)]
        cells = sum(len(a) * len(b) for a, b in zip(seqs_a, seqs_b))
        if _route(cells, len(seqs_a), self.scoring) == "host":
            return [host_dp.nw_align(self.scoring, a, b)
                    for a, b in zip(seqs_a, seqs_b)]
        return self._align_batch_device(seqs_a, seqs_b)

    def _align_batch_device(self, seqs_a, seqs_b) -> List[Alignment]:
        from .ops import dp
        from .ops.traceback import nw_strings_from_ops, nw_walk_device

        results: List[Optional[Alignment]] = [None] * len(seqs_a)
        for key, idx in _buckets(seqs_a, seqs_b):
            if key is None:  # long pairs: chunked boundary-carry path
                for i in idx:
                    results[i] = self.align_long(seqs_a[i], seqs_b[i])
                continue
            # sub-batch so the in-flight fill stays inside the device
            # memory budget (a 100-pair 10kb bucket is ~100GB of planes)
            step = _align_steps(key, "dirs")
            for s in range(0, len(idx), step):
                sub = idx[s:s + step]
                ga = [seqs_a[i] for i in sub]
                gb = [seqs_b[i] for i in sub]
                out, na, nb = dp.fill_batch(
                    self.scoring, ga, gb, is_sw=False, emit_dirs=True,
                    pow2_pad=True,
                )
                _note_dispatch("dirs_xla")
                # the walk runs on the device: only the ~1 byte/step op
                # trace comes back, never the ~2 bytes/cell dirs tensor
                cap = int(np.max(np.asarray(na) + np.asarray(nb)))
                ops, score = nw_walk_device(out.dirs, _xla_gather,
                                            out.corner, na, nb, cap)
                alns = nw_strings_from_ops(ga, gb, na, nb, ops, score)
                for j, i in enumerate(sub):
                    results[i] = alns[j]
        return results  # type: ignore[return-value]

    def score(self, seq_a: str, seq_b: str) -> int:
        return int(self.score_batch([seq_a], [seq_b])[0])

    def score_batch(self, seqs_a, seqs_b) -> np.ndarray:
        """Scores only — no O(n*m) dirs materialization on the device path
        (the Triton kernel on a GPU when eligible, else the XLA scan).
        Mixed-length batches are bucketed, and symmetric configs
        canonicalize each pair so the b side is the shorter sequence."""
        return _scores_bucketed(self.scoring, seqs_a, seqs_b,
                                is_sw=False)

    def align_long(self, seq_a: str, seq_b: str, chunk: int = 2048) -> Alignment:
        """Long-sequence global alignment: chunked fill with boundary-column
        carry (device memory O(chunk * len_b)); traceback walks the streamed
        per-chunk direction codes."""
        if self.scoring.sentinel_wrap_risk():
            # int32 device fills would wrap like the reference's UB crash
            # (see _route); slow-but-correct int64 host fill instead
            return host_dp.nw_align(self.scoring, seq_a, seq_b)
        from .ops import dp
        from .ops.traceback import ChunkedDirs, nw_traceback

        corner, _, dirs_chunks, _, na, nb = dp.fill_chunked(
            self.scoring, [seq_a], [seq_b], is_sw=False, chunk=chunk,
            emit_dirs=True,
        )
        _note_dispatch("chunked_xla")
        dirs = ChunkedDirs([c[0] for c in dirs_chunks], chunk)
        return nw_traceback(seq_a, seq_b, int(na[0]), int(nb[0]), dirs,
                            corner[0])

    def align_with_matrices(self, seq_a: str, seq_b: str):
        """One fill shared by the alignment and the (M, Ga, Gb) row-major
        matrices (--printmatrices parity without a second fill — the
        reference prints from live fill state, tools/nw_cmdline.c:107-110)."""
        if os.environ.get("SEQALIGN_REF_WRAP") == "1":
            return host_dp.nw_align_ref_wrap(self.scoring, seq_a, seq_b)
        if _route(len(seq_a) * len(seq_b), 1, self.scoring) == "host":
            return host_dp.nw_align_with_matrices(self.scoring, seq_a, seq_b)
        from .ops import dp
        from .ops.traceback import nw_traceback

        out, na, nb = dp.fill_batch(
            self.scoring, [seq_a], [seq_b], is_sw=False, emit_dirs=True,
            emit_m=True, emit_gab=True,
        )
        aln = nw_traceback(seq_a, seq_b, na[0], nb[0],
                           np.asarray(out.dirs)[0], np.asarray(out.corner)[0])
        mats = _deskew_all(self.scoring, out, int(na[0]), int(nb[0]),
                           is_sw=False)
        return aln, mats

    def matrices(self, seq_a: str, seq_b: str):
        """Full (M, Ga, Gb) row-major matrices for --printmatrices parity."""
        return self.align_with_matrices(seq_a, seq_b)[1]


class SmithWaterman:
    """Local multi-hit aligner; ``align`` returns a stateful hit iterator.

    ``ref_mask_compat`` (or env ``SEQALIGN_SW_REF_MASK=1``) opts into the
    reference's buggy shared overlap mask across the pairs THIS instance
    aligns — one instance == one reference ``sw_aligner_t``
    (smith_waterman.c:149 quarter-reset; see traceback.SwRefMaskHistory).
    Iterators must then be consumed in pair order, as the reference's
    align/fetch loop does.
    """

    def __init__(self, scoring: Optional[ScoringConfig] = None,
                 ref_mask_compat: Optional[bool] = None):
        self.scoring = scoring if scoring is not None else scoring_system_sw_default()
        if ref_mask_compat is None:
            ref_mask_compat = os.environ.get("SEQALIGN_SW_REF_MASK") == "1"
        if ref_mask_compat:
            from .ops.traceback import SwRefMaskHistory

            self.history = SwRefMaskHistory()
        else:
            self.history = None

    def align(self, seq_a: str, seq_b: str, min_score: Optional[int] = None):
        return self.align_batch(
            [seq_a], [seq_b],
            None if min_score is None else [min_score])[0]

    def align_batch(self, seqs_a, seqs_b,
                    min_scores: Optional[Sequence[int]] = None) -> List:
        """``min_scores`` (per pair) is an optimization HINT: hits below it
        may be pruned from the stream (never walked, so best-first
        consumption up to the threshold — the CLI loop,
        sw_cmdline.c:204-216 — is byte-identical); hits >= it are exact.
        On the device paths it enables on-device candidate extraction, so
        the M matrix never transfers to host."""
        cells = sum(len(a) * len(b) for a, b in zip(seqs_a, seqs_b))
        if _route(cells, len(seqs_a)) == "host":  # SW: sentinel-free
            return [host_dp.HostSwHits(self.scoring, a, b,
                                       history=self.history)
                    for a, b in zip(seqs_a, seqs_b)]
        if min_scores is None:
            # reference hits always score > 0 (integer scores: M >= 1), so
            # a threshold of 1 prunes nothing — but it turns on the
            # on-device candidate harvest, so the M matrix never
            # transfers to host
            min_scores = [1] * len(seqs_a)
        return self._align_batch_device(seqs_a, seqs_b, min_scores)

    def _align_batch_device(self, seqs_a, seqs_b, min_scores) -> List:
        from .ops import dp
        from .ops.traceback import SwHitIterator

        sc = self.scoring
        results: List = [None] * len(seqs_a)
        for key, idx in _buckets(seqs_a, seqs_b):
            if key is None:  # long pairs: chunked boundary-carry path
                for i in idx:
                    results[i] = self.align_long(seqs_a[i], seqs_b[i],
                                                 min_score=min_scores[i])
                continue
            step = _align_steps(key, "dirs_m")
            for s in range(0, len(idx), step):
                sub = idx[s:s + step]
                ga = [seqs_a[i] for i in sub]
                gb = [seqs_b[i] for i in sub]
                out, na, nb = dp.fill_batch(
                    sc, ga, gb, is_sw=True, emit_dirs=True, emit_m=True,
                    pow2_pad=True,
                )
                _note_dispatch("dirs_xla")
                # device-side harvest: M stays on device, only (flat,
                # score) candidate pairs land on host
                cands = _harvest(out.mmat, na, nb,
                                 [min_scores[i] for i in sub])
                if not sc.no_end_gap_penalty and all(
                        len(c[0]) <= _SW_DEVWALK_CANDS for c in cands):
                    # batched device walks: hit paths come back as op
                    # traces and the dirs tensor stays on the device.  A
                    # hint-less wide pair harvests ~every cell, so past
                    # the cutover the dirs are fetched once instead.
                    walker = _xla_sw_walker(sc, out.dirs, ga, gb)
                    pre, walkers = _sw_prewalk(walker, cands, na)
                    planes = _host_planes(out.dirs)
                    for j, i in enumerate(sub):
                        results[i] = SwHitIterator(
                            sc, ga[j], gb[j], int(na[j]), int(nb[j]),
                            _LazyPlanes(planes, j),
                            history=self.history, candidates=cands[j],
                            pre_paths=pre[j], walker=walkers[j])
                    continue
                dirs = np.asarray(out.dirs)
                for j, i in enumerate(sub):
                    results[i] = SwHitIterator(
                        sc, ga[j], gb[j], int(na[j]), int(nb[j]), dirs[j],
                        history=self.history, candidates=cands[j])
        return results

    def best_score(self, seq_a: str, seq_b: str) -> int:
        return int(self.best_score_batch([seq_a], [seq_b])[0])

    def best_score_batch(self, seqs_a, seqs_b) -> np.ndarray:
        return _scores_bucketed(self.scoring, seqs_a, seqs_b, is_sw=True)

    def align_long(self, seq_a: str, seq_b: str, chunk: int = 2048,
                   min_score: Optional[int] = None):
        """Long-sequence local multi-hit alignment via the chunked fill,
        streaming by default: per-chunk on-device candidate harvest, M
        slabs never materialized on host — memory is O(dirs +
        candidates), bounded for giant pairs.  (``min_score`` tightens
        the harvest threshold; the default 1 is exact — reference hits
        always score >= 1.)"""
        from .ops import dp
        from .ops.traceback import ChunkedDirs, SwHitIterator

        if min_score is None:
            min_score = 1
        _, _, dirs_chunks, m_chunks, na, nb = dp.fill_chunked(
            self.scoring, [seq_a], [seq_b], is_sw=True, chunk=chunk,
            emit_dirs=True, emit_m=True, extract_min=min_score,
        )
        _note_dispatch("chunked_xla")
        return SwHitIterator(
            self.scoring, seq_a, seq_b, int(na[0]), int(nb[0]),
            ChunkedDirs([c[0] for c in dirs_chunks], chunk),
            history=self.history, candidates=m_chunks[0],
        )

    def align_with_matrices(self, seq_a: str, seq_b: str):
        """One fill shared by the hit iterator and the row-major matrices."""
        if _route(len(seq_a) * len(seq_b), 1) == "host":  # SW: no sentinel
            mats = host_dp.fill_matrices(self.scoring, seq_a, seq_b,
                                         is_sw=True)
            return host_dp.HostSwHits(self.scoring, seq_a, seq_b,
                                      matrices=mats,
                                      history=self.history), mats
        from .ops import dp
        from .ops.traceback import SwHitIterator

        out, na, nb = dp.fill_batch(
            self.scoring, [seq_a], [seq_b], is_sw=True, emit_dirs=True,
            emit_m=True, emit_gab=True,
        )
        hits = SwHitIterator(
            self.scoring, seq_a, seq_b, int(na[0]), int(nb[0]),
            np.asarray(out.dirs)[0], np.asarray(out.mmat)[0],
            history=self.history,
        )
        return hits, _deskew_all(self.scoring, out, int(na[0]), int(nb[0]),
                                 is_sw=True)

    def matrices(self, seq_a: str, seq_b: str):
        return self.align_with_matrices(seq_a, seq_b)[1]


def _deskew_all(sc: ScoringConfig, out, na: int, nb: int, *, is_sw):
    """Rebuild row-major matrices incl. the closed-form boundary row/col
    (alignment.c:51-81) the wavefront never materializes."""
    from .ops import dp

    mn = sc.dp_floor(is_sw)
    M = dp.deskew(np.asarray(out.mmat)[0], na, nb, fill=mn)
    Ga = dp.deskew(np.asarray(out.gamat)[0], na, nb, fill=mn)
    Gb = dp.deskew(np.asarray(out.gbmat)[0], na, nb, fill=mn)
    if is_sw:
        M[0, :] = Ga[0, :] = Gb[0, :] = 0
        M[1:, 0] = Ga[1:, 0] = Gb[1:, 0] = mn  # == 0
        M[0, 0] = Ga[0, 0] = Gb[0, 0] = 0
    else:
        xs = np.arange(1, na + 1, dtype=np.int64)
        ys = np.arange(1, nb + 1, dtype=np.int64)
        run_x = 0 if sc.no_start_gap_penalty else sc.gap_open + xs * sc.gap_extend
        run_y = 0 if sc.no_start_gap_penalty else sc.gap_open + ys * sc.gap_extend
        M[0, 1:] = Ga[0, 1:] = mn
        Gb[0, 1:] = run_x
        M[1:, 0] = Gb[1:, 0] = mn
        Ga[1:, 0] = run_y
        M[0, 0] = Ga[0, 0] = Gb[0, 0] = 0
    return M, Ga, Gb


def lcs_hits(seq: str, case_sensitive: bool = True,
             sw: Optional[SmithWaterman] = None):
    """Longest-common-substring enumeration of a sequence against itself:
    constrained SW per lcs_cmdline.c:39-64 (match 1 / mismatch -1 / open -4 /
    extend -1, no gaps, no mismatches); yields only pos_a < pos_b hits.
    Pass ``sw`` (an ``lcs_aligner()``) to reuse one aligner across calls —
    the reference lcs CLI aligns every input line with one sw_aligner_t."""
    if sw is None:
        sw = lcs_aligner(case_sensitive)
    for hit in sw.align(seq, seq):
        if hit.pos_a < hit.pos_b:
            yield hit


def lcs_aligner(case_sensitive: bool = True) -> SmithWaterman:
    """The lcs CLI's constrained SW aligner (lcs_cmdline.c:39-64)."""
    sc = ScoringConfig(
        1, -1, -4, -1,
        no_gaps_in_a=True, no_gaps_in_b=True, no_mismatches=True,
        case_sensitive=case_sensitive,
    )
    return SmithWaterman(sc)
