"""Multi-process execution: ``jax.distributed`` wiring, per-process input
shards, and result re-assembly.

The reference is single-process/single-thread (SURVEY §2.4) — multi-process
scale-out is new capability: pairwise alignment is embarrassingly parallel
over pairs, so each process (one per device, or one per host) reads a
round-robin shard of the input pairs (``io.seqio.read_pairs_sharded``),
fills them on its own local devices, and only the O(B) result vector is
exchanged with a process-level allgather.  No collective runs inside the
DP fill itself; sharding one batch over a mesh lives in
``parallel.engine`` and sequence-parallel fills of one giant pair in
``parallel.wavefront_sp``.

Entry points:

* ``init_from_env()`` — call once per process before any other JAX use.
  Reads ``SEQALIGN_COORDINATOR`` (host:port), ``SEQALIGN_NUM_PROCS``,
  ``SEQALIGN_PROC_ID`` (or explicit kwargs) and brings up
  ``jax.distributed``; a no-op returning False when unset (single process).
* ``distributed_score_file()`` — every host computes scores for its pair
  shard; returns the complete, pair-ordered score vector on every host.

Validated by a real 2-process CPU integration test
(tests/test_distributed.py) and on four GPUs with one process per card
(``chip_smoke.py --four``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..io import seqio
from ..scoring.config import ScoringConfig


def init_from_env(coordinator: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None,
                  local_device_ids=None) -> bool:
    """Initialize the JAX distributed runtime from args or environment.

    Returns True when multi-process mode was brought up, False when no
    coordinator is configured (single-process mode).  Must run before the
    first jax.devices() / computation in the process.
    """
    coordinator = coordinator or os.environ.get("SEQALIGN_COORDINATOR")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ["SEQALIGN_NUM_PROCS"])
    if process_id is None:
        process_id = int(os.environ["SEQALIGN_PROC_ID"])
    import jax

    kwargs = {}
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    return True


def _allgather_ragged(idx: np.ndarray, vals: np.ndarray):
    """Gather per-host (global_pair_index, value) shards of different
    lengths into the full pair-ordered vector, identical on every host."""
    import jax
    from jax.experimental import multihost_utils

    n_local = np.array([len(idx)], np.int32)
    counts = np.asarray(multihost_utils.process_allgather(n_local)).ravel()
    width = int(counts.max(initial=0))
    pid = jax.process_index()
    idx_pad = np.full(width, -1, np.int64)
    idx_pad[: len(idx)] = idx
    val_pad = np.zeros(width, vals.dtype if len(vals) else np.int32)
    val_pad[: len(vals)] = vals
    g_idx = np.asarray(multihost_utils.process_allgather(idx_pad))
    g_val = np.asarray(multihost_utils.process_allgather(val_pad))
    del pid
    total = int(counts.sum())
    out = np.zeros(total, g_val.dtype)
    flat_idx = g_idx.ravel()
    keep = flat_idx >= 0
    out[flat_idx[keep]] = g_val.ravel()[keep]
    return out


def distributed_score_file(sc: ScoringConfig, path1: str,
                           path2: Optional[str] = None, *, is_sw: bool,
                           batch: int = 256) -> np.ndarray:
    """Score every pair in the input file(s) across all hosts.

    Each host streams its round-robin pair shard, fills batches on its
    local devices (Pallas/XLA routing per ``aligners``), and the full
    pair-ordered score vector is assembled with a process allgather —
    every host returns the identical complete result.

    Single-process (no ``init_from_env``) degrades to a plain local run.
    """
    import jax

    from ..aligners import _scores_auto

    pid = jax.process_index()
    nproc = jax.process_count()
    idxs: list[int] = []
    scores: list[np.ndarray] = []
    buf_i: list[int] = []
    buf_a: list[str] = []
    buf_b: list[str] = []

    def flush():
        if not buf_i:
            return
        # defer=True: the batch stays an in-flight device array, so the
        # next batch's file IO + host pack overlaps this batch's device
        # fill (double buffering).  Backpressure: only the newest 4
        # batches stay deferred — older ones are fetched to host numpy so
        # a huge input file can't pile up unbounded device input buffers
        # (ADVICE round 4; mirrors score_pairs_stream's max_inflight=4).
        s = _scores_auto(sc, buf_a, buf_b, is_sw=is_sw, defer=True)
        scores.append(s)
        k = len(scores) - 4
        if k > 0 and not isinstance(scores[k - 1], np.ndarray):
            scores[k - 1] = np.asarray(scores[k - 1])
        idxs.extend(buf_i)
        buf_i.clear()
        buf_a.clear()
        buf_b.clear()

    for idx, (_, seq_a), (_, seq_b) in seqio.read_pairs_sharded(
        path1, path2, pid, nproc
    ):
        buf_i.append(idx)
        buf_a.append(seq_a)
        buf_b.append(seq_b)
        if len(buf_i) >= batch:
            flush()
    flush()
    local_idx = np.asarray(idxs, np.int64)
    local_scores = (
        np.concatenate([np.asarray(s) for s in scores])
        if scores else np.zeros(0, np.int32)
    )
    if nproc == 1:
        out = np.zeros(len(local_idx), local_scores.dtype)
        out[local_idx] = local_scores
        return out
    return _allgather_ragged(local_idx, local_scores)


def _allgather_packed(meta: np.ndarray, buf: np.ndarray):
    """Gather per-host (R_i, K) int64 record tables + uint8 string buffers
    of different sizes; returns (meta_all, buf_list) where buf_list[p] is
    host p's buffer and meta_all rows carry their host id in column 0."""
    import jax
    from jax.experimental import multihost_utils

    sizes = np.array([meta.shape[0], buf.shape[0]], np.int64)
    all_sizes = np.asarray(multihost_utils.process_allgather(sizes))
    rmax = int(all_sizes[:, 0].max(initial=0))
    bmax = int(all_sizes[:, 1].max(initial=0))
    K = meta.shape[1]
    mpad = np.full((max(rmax, 1), K), -1, np.int64)
    if meta.size:
        mpad[: meta.shape[0]] = meta
    bpad = np.zeros(max(bmax, 1), np.uint8)
    bpad[: buf.shape[0]] = buf
    g_meta = np.asarray(multihost_utils.process_allgather(mpad))
    g_buf = np.asarray(multihost_utils.process_allgather(bpad))
    del jax
    metas = []
    bufs = []
    for p in range(all_sizes.shape[0]):
        metas.append(g_meta[p, : all_sizes[p, 0]])
        bufs.append(g_buf[p, : all_sizes[p, 1]])
    return metas, bufs


def distributed_align_file(sc: ScoringConfig, path1: str,
                           path2: Optional[str] = None, *, is_sw: bool,
                           batch: int = 256,
                           min_score: Optional[int] = None,
                           max_hits: Optional[int] = None):
    """Full alignments for every pair in the input file(s) across all
    hosts: each host fills + tracebacks its round-robin pair shard on its
    local devices, then the packed alignment records (scores, positions,
    gapped strings) are assembled with a process allgather — every host
    returns the identical, complete, pair-ordered result
    (SURVEY §2.4-3 "all_gather of scores/alignment strings"; the loop
    being scaled is the reference's align-and-print callback,
    alignment_cmdline.c:611-622).

    NW: list[Alignment].  SW: list[list[Alignment]] — each pair's hit
    stream best-first, pruned at ``min_score`` (default 1 = every
    positive-scoring hit, smith_waterman.c:260-277 semantics) and capped
    at ``max_hits`` per pair.

    Single-process (no ``init_from_env``) degrades to a plain local run.
    """
    import jax

    from ..aligners import NeedlemanWunsch, SmithWaterman
    from ..ops.host_dp import Alignment

    pid = jax.process_index()
    nproc = jax.process_count()
    thr = 1 if min_score is None else int(min_score)

    records: list[tuple] = []  # (idx, hit_no, score, pos_a, pos_b, aln_a, aln_b)
    buf_parts: list[bytes] = []
    buf_len = 0
    al = (SmithWaterman(sc) if is_sw else NeedlemanWunsch(sc))
    buf_i: list[int] = []
    buf_a: list[str] = []
    buf_b: list[str] = []

    def emit(idx, hit_no, r):
        nonlocal buf_len
        pa = r.result_a.encode()
        pb = r.result_b.encode()
        records.append((idx, hit_no, r.score, r.pos_a, r.pos_b,
                        r.len_a, r.len_b, buf_len, len(pa), len(pb)))
        buf_parts.append(pa)
        buf_parts.append(pb)
        buf_len += len(pa) + len(pb)

    def flush():
        if not buf_i:
            return
        if is_sw:
            iters = al.align_batch(buf_a, buf_b,
                                   min_scores=[thr] * len(buf_i))
            for idx, it in zip(buf_i, iters):
                for h_no, h in enumerate(it):
                    if h.score < thr or (max_hits is not None
                                         and h_no >= max_hits):
                        break
                    emit(idx, h_no, h)
        else:
            for idx, r in zip(buf_i, al.align_batch(buf_a, buf_b)):
                emit(idx, 0, r)
        buf_i.clear()
        buf_a.clear()
        buf_b.clear()

    n_total = 0
    for idx, (_, seq_a), (_, seq_b) in seqio.read_pairs_sharded(
        path1, path2, pid, nproc
    ):
        n_total = max(n_total, idx + 1)
        buf_i.append(idx)
        buf_a.append(seq_a)
        buf_b.append(seq_b)
        if len(buf_i) >= batch:
            flush()
    flush()

    meta = np.asarray(records, np.int64).reshape(len(records), 10)
    buf = np.frombuffer(b"".join(buf_parts), np.uint8)

    if nproc > 1:
        metas, bufs = _allgather_packed(meta, buf)
        # total pair count must come from all hosts (shards are ragged)
        from jax.experimental import multihost_utils

        n_total = int(np.asarray(multihost_utils.process_allgather(
            np.array([n_total], np.int64))).max(initial=0))
    else:
        metas, bufs = [meta], [buf]

    out: list = [None] * n_total if not is_sw else [[] for _ in
                                                    range(n_total)]
    staged = []
    for p, (m, bb) in enumerate(zip(metas, bufs)):
        for row in m:
            (idx, hit_no, score, pos_a, pos_b, lena, lenb, off, la_,
             lb_) = (int(v) for v in row)
            ra = bytes(bb[off: off + la_]).decode()
            rb = bytes(bb[off + la_: off + la_ + lb_]).decode()
            staged.append((idx, hit_no,
                           Alignment(ra, rb, score, pos_a, pos_b, lena,
                                     lenb)))
    for idx, hit_no, aln in sorted(staged, key=lambda t: (t[0], t[1])):
        if is_sw:
            out[idx].append(aln)
        else:
            out[idx] = aln
    return out
