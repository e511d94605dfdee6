#!/usr/bin/env python3
"""End-to-end workload of BASELINE.json configs[4]: gzip FASTA in ->
optimal scores (and an alignment subset) out, over N pairs of 1-10kb DNA
reads.  Wall time covers everything: gzip streaming, host pack, device
fills, result fetch.  The reference processes the same workload strictly
serially at ~0.1-1 GCUPS on one core (alignment_cmdline.c:611-622,
BASELINE.md).

Prints one JSON line naming the device it ran on; ``--out`` also writes
the full record.  ``gen_input`` is the shared input generator (the chip
smoke run uses it too).

Usage:
  python tools/bench_e2e.py                     # 64k pairs
  python tools/bench_e2e.py --pairs 512 --align-pairs 8   # smoke
"""

import argparse
import gzip
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ALPHA = np.frombuffer(b"acgt", dtype=np.uint8)


def _mutate(rng, crng, seq: np.ndarray, sub=0.03, indel=0.005) -> np.ndarray:
    """A realistic partner read: substitutions + short indels.  Length-
    affecting draws (indel count/positions/sizes) come from ``rng``,
    letters from ``crng`` — see :func:`gen_input`."""
    n = len(seq)
    out = seq.copy()
    m = crng.random(n) < sub
    out[m] = ALPHA[crng.integers(0, 4, int(m.sum()))]
    # indels: delete or insert at a few positions
    k = rng.poisson(indel * n)
    for _ in range(int(k)):
        p = int(rng.integers(0, max(1, len(out))))
        ln = int(rng.integers(1, 8))
        if rng.random() < 0.5:
            out = np.delete(out, np.s_[p:p + ln])
        else:
            out = np.insert(out, p, ALPHA[crng.integers(0, 4, ln)])
    return out


def gen_input(path: str, n_pairs: int, lo: int, hi: int, seed: int,
              content_seed: int):
    """Write n_pairs read pairs (read, mutated copy) as one gzip FASTA —
    two consecutive records per pair, the reference's --file pairing rule
    (alignment_cmdline.c:578-640).  Lengths come from ``seed`` and
    letters from ``content_seed``, so two inputs can share every padded
    bucket shape while carrying different data."""
    rng = np.random.default_rng(seed)
    crng = np.random.default_rng(content_seed)
    t0 = time.perf_counter()
    with gzip.open(path, "wb", compresslevel=1) as fh:
        for i in range(n_pairs):
            la = int(rng.integers(lo, hi + 1))
            a = ALPHA[crng.integers(0, 4, la)]
            b = _mutate(rng, crng, a)
            fh.write(b">p%d/1\n" % i)
            fh.write(a.tobytes() + b"\n")
            fh.write(b">p%d/2\n" % i)
            fh.write(b.tobytes() + b"\n")
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=65536)
    ap.add_argument("--align-pairs", type=int, default=2048,
                    help="subset run through full alignment (traceback)")
    ap.add_argument("--min-len", type=int, default=1000)
    ap.add_argument("--max-len", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--batch", type=int, default=None,
                    help="pairs per dispatched bucket (default: by route)")
    ap.add_argument("--flush-cells", type=int, default=None,
                    help="padded cells per dispatched XLA bucket batch "
                    "(default: sized from device memory)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--input", default=None,
                    help="reuse an existing FASTA (skips generation)")
    args = ap.parse_args()

    import tempfile

    import jax

    from seqalign_tpu.aligners import (
        NeedlemanWunsch, dispatch_counts, score_pairs_stream,
    )
    from seqalign_tpu.io import seqio
    from seqalign_tpu.scoring.presets import scoring_system_default

    sc = scoring_system_default()

    base = os.path.join(tempfile.gettempdir(), "seqalign_e2e_%d_%d_%d_%d" % (
        args.pairs, args.min_len, args.max_len, args.seed))
    path_cold = args.input or base + "c.fa.gz"
    path = args.input or base + "w.fa.gz"
    for p, cseed in ((path_cold, args.seed), (path, args.seed + 1)):
        if not os.path.exists(p):
            gen_s = gen_input(p, args.pairs, args.min_len, args.max_len,
                              args.seed, cseed)
            sys.stderr.write("e2e: generated %s in %.1fs\n" % (p, gen_s))
    in_bytes = os.path.getsize(path)

    # ---- scores phase: gzip stream -> bucketed deferred fills -> fetch.
    # The cold pass (file A) pays one compile per padded bucket shape
    # (the persistent compile cache keeps them across runs); the warm
    # pass (file B: same lengths, other letters) is the steady-state rate
    # covering IO + pack + fill + fetch.
    def scores_pass(p):
        t0 = time.perf_counter()
        pairs_iter = ((i, ra[1], rb[1])
                      for i, ra, rb in seqio.read_pairs(p))
        n = 0
        checksum = np.int64(0)
        score_first = None
        for idx, scores in score_pairs_stream(sc, pairs_iter, is_sw=False,
                                              flush_pairs=args.batch,
                                              flush_cells=args.flush_cells):
            n += len(idx)
            checksum += np.int64(scores.astype(np.int64).sum())
            if score_first is None and 0 in idx:
                score_first = int(scores[list(idx).index(0)])
        return time.perf_counter() - t0, n, checksum, score_first

    wall_cold, n, _, _ = scores_pass(path_cold)
    sys.stderr.write("e2e: cold scores pass %.1fs\n" % wall_cold)
    wall_scores, n2, checksum, score_first = scores_pass(path)
    assert n2 == n
    _, _, checksum2, _ = scores_pass(path)  # determinism (untimed rerun)
    assert checksum2 == checksum
    # cell count from a cheap metadata pass (lengths only)
    cells = 0
    for _, ra, rb in seqio.read_pairs(path):
        cells += len(ra[1]) * len(rb[1])
    gcups = cells / wall_scores / 1e9

    # ---- align phase: full traceback on a subset (cold subset from
    # file A compiles the dirs shapes; the timed subset is file B's)
    def subset(p):
        sa, sb = [], []
        for i, ra, rb in seqio.read_pairs(p):
            if len(sa) >= args.align_pairs:
                break
            sa.append(ra[1])
            sb.append(rb[1])
        return sa, sb

    nw = NeedlemanWunsch(sc)
    ca, cb = subset(path_cold)
    t1 = time.perf_counter()
    nw.align_batch(ca, cb)
    wall_align_cold = time.perf_counter() - t1
    sub_a, sub_b = subset(path)
    t1 = time.perf_counter()
    alns = nw.align_batch(sub_a, sub_b)
    wall_align = time.perf_counter() - t1
    acells = sum(len(a) * len(b) for a, b in zip(sub_a, sub_b))
    # correctness spot check: alignment scores must equal streamed scores
    if sub_a and score_first is not None:
        assert alns[0].score == score_first, (alns[0].score, score_first)

    rec = {
        "config": "BASELINE.json configs[4] (1-10kb DNA pairs, gzip FASTA)",
        "n_pairs": n,
        "len_range": [args.min_len, args.max_len],
        "input_gzip_mb": round(in_bytes / 1e6, 1),
        "cells_total": int(cells),
        "scores_wall_cold_s": round(wall_cold, 2),
        "scores_wall_s": round(wall_scores, 2),
        "scores_gcups_e2e": round(gcups, 2),
        "scores_pairs_per_s": round(n / wall_scores, 1),
        "score_checksum": int(checksum),
        "align_pairs": len(sub_a),
        "align_wall_cold_s": round(wall_align_cold, 2),
        "align_wall_s": round(wall_align, 2),
        "align_gcups_e2e": round(acells / wall_align / 1e9, 2),
        "align_pairs_per_s": round(len(sub_a) / max(wall_align, 1e-9), 1),
        "dispatch_counts": dispatch_counts(),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
    print(json.dumps({
        "metric": "e2e_scores_gcups", "value": rec["scores_gcups_e2e"],
        "unit": "GCUPS", "pairs_per_s": rec["scores_pairs_per_s"],
        "align_pairs_per_s": rec["align_pairs_per_s"],
        "device": rec["device"],
    }))


if __name__ == "__main__":
    main()
