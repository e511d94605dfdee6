#!/usr/bin/env python3
"""Smoke run of the alignment main path on one NVIDIA GPU.

Drives the library's normal entry points at the sizes its users run and
compares every phase exactly with the int64 host reference
(``ops/host_dp.py``) or with an independent device fill:

  1. gzip FASTA of 4096 pairs of 1-10 kb -> ``score_pairs_stream`` (NW):
     the Triton kernel route against ``SEQALIGN_PALLAS=off`` (XLA) on the
     whole set, 8 pairs of <= 3 kb against the host fill;
  2. ``NeedlemanWunsch.align_batch`` on 64 of those pairs: rescored
     strings equal the phase-1 scores, 4 equal ``host_dp.nw_align``;
  3. ``SmithWaterman.align_batch`` on 256 pairs of 1-2 kb with min scores:
     the first 3 hits of 4 pairs equal ``host_dp.HostSwHits``;
  4. BLOSUM62 SW scores of 2048 protein pairs (8 against the host), and a
     substitution matrix with entries >= 2^11 (NW, all against the host);
  5. one 12 kb pair through the chunked long-pair fill;
  6. ``bin/needleman_wunsch --printscores --file`` on 64 pairs of 1-3 kb:
     the device route's bytes equal the host route's;
  7. the ``gpu``-marked tests (run first, in a child process, before this
     process takes the card).

``--four`` runs only the multi-card paths on four cards and the one-card
results they are compared with: ``sharded_score_batch``,
``sharded_align_batch`` (NW and SW), ``sp_scores``/``sp_align_nw`` on one
20 kb pair, and ``distributed_score_file`` with one process per card.

Times and GCUPS printed here are smoke numbers, not a benchmark.  The last
line of stdout is one JSON object naming the device; any failure exits
non-zero before it.  Usage: ``python chip_smoke.py [--four]``.
"""

import argparse
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 4
SIZE = 1.0  # counts and lengths scale; a CPU rehearsal shrinks it


def size(n):
    return max(4, round(n * SIZE))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise SystemExit("chip_smoke: FAILED: " + what)


def rescore(sc, ra: str, rb: str) -> int:
    """Score of a global alignment from its strings (Gotoh, default flags:
    alignment.c:89-167)."""
    sub = sc.luts()[1]
    score, prev = 0, None
    for ca, cb in zip(ra, rb):
        if ca == "-":
            score += sc.gap_extend + (0 if prev == "a" else sc.gap_open)
            prev = "a"
        elif cb == "-":
            score += sc.gap_extend + (0 if prev == "b" else sc.gap_open)
            prev = "b"
        else:
            score += int(sub[ord(ca), ord(cb)])
            prev = None
    return score


def host_score(sc, a: str, b: str, is_sw: bool) -> int:
    from seqalign_tpu.ops import host_dp

    M, Ga, Gb = host_dp.fill_matrices(sc, a, b, is_sw)
    if is_sw:
        return int(M.max(initial=0))
    return int(max(M[-1, -1], Ga[-1, -1], Gb[-1, -1]))


def read_pairs(path):
    from seqalign_tpu.io import seqio

    return [(ra[1], rb[1]) for _, ra, rb in seqio.read_pairs(path)]


def write_fasta(path, pairs):
    with open(path, "w") as fh:
        for i, (a, b) in enumerate(pairs):
            fh.write(">p%d/1\n%s\n>p%d/2\n%s\n" % (i, a, i, b))


def gen_pairs(tmp, name, n, lo, hi, seed):
    """n (read, mutated copy) pairs from tools/bench_e2e.gen_input."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from bench_e2e import gen_input

    path = os.path.join(tmp, name + ".fa.gz")
    gen_input(path, n, lo, hi, seed, seed + 1)
    return path


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def gcups(pairs, seconds):
    return sum(len(a) * len(b) for a, b in pairs) / seconds / 1e9


@contextlib.contextmanager
def env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: v for k, v in kv.items() if v is not None})
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------


def phase_gpu_tests(tmp, tag):
    xml = os.path.join(tmp, "gpu_tests.xml")
    p, dt = timed(lambda: subprocess.run(
        [sys.executable, "-m", "pytest", os.path.join(REPO, "tests"), "-q",
         "-m", "gpu", "-p", "no:cacheprovider", "--junitxml", xml],
        cwd=REPO, env=dict(os.environ, SEQALIGN_TEST_GPU="1"),
        capture_output=True, text=True, timeout=600))
    check(p.returncode == 0, "gpu tests failed:\n" + p.stdout[-4000:])
    suite = ET.parse(xml).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    n, skipped = int(suite.get("tests")), int(suite.get("skipped"))
    check(n > 0 and skipped == 0, "gpu tests: %d run, %d skipped" %
          (n, skipped))
    log("phase 7 gpu-marked tests %s: %d passed in %.1f s" % (tag, n, dt))


def phase_e2e(tmp, tag):
    from seqalign_tpu import aligners
    from seqalign_tpu.scoring.presets import scoring_system_default

    sc = scoring_system_default()
    path = gen_pairs(tmp, "e2e", size(4096), size(1000), size(10000), SEED)
    pairs = read_pairs(path)

    def run():
        from seqalign_tpu.io import seqio

        out = {}
        it = ((i, ra[1], rb[1]) for i, ra, rb in seqio.read_pairs(path))
        for idx, s in aligners.score_pairs_stream(sc, it, is_sw=False):
            out.update(zip(idx.tolist(), s.tolist()))
        return [out[i] for i in range(len(out))]

    results = {}
    for route, mode in (("kernel", None), ("xla", "off")):
        with env(SEQALIGN_PALLAS=mode):
            before = aligners.dispatch_counts().get("scores_" + route, 0)
            results[route], dt = timed(run)
            check(aligners.dispatch_counts().get("scores_" + route, 0)
                  > before, "phase 1 did not take the %s route" % route)
        log("phase 1 e2e scores %s: %s route %.1f s, %.2f GCUPS incl. "
            "compile (4096 pairs of 1-10 kb)" % (tag, route, dt,
                                                 gcups(pairs, dt)))
    check(results["kernel"] == results["xla"],
          "phase 1: kernel and XLA scores differ")
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    log("phase 1 device memory %s: peak %.1f GB of %.1f GB" % (
        tag, stats.get("peak_bytes_in_use", 0) / 1e9,
        stats.get("bytes_limit", 0) / 1e9))
    short = [i for i, (a, b) in enumerate(pairs)
             if max(len(a), len(b)) <= size(3000)][:8]
    check(len(short) == 8, "phase 1: too few short pairs")
    for i in short:
        check(results["kernel"][i] == host_score(sc, *pairs[i], False),
              "phase 1: pair %d differs from the host fill" % i)
    log("phase 1 e2e scores %s: 4096 kernel == XLA, 8 == host: OK" % tag)
    return pairs, results["kernel"]


def phase_nw_align(tag, pairs, scores):
    from seqalign_tpu.aligners import NeedlemanWunsch
    from seqalign_tpu.ops import host_dp

    nw = NeedlemanWunsch()
    pick = [i for i, (a, b) in enumerate(pairs)
            if max(len(a), len(b)) <= size(3000)][:64]
    sa = [pairs[i][0] for i in pick]
    sb = [pairs[i][1] for i in pick]
    alns, dt = timed(lambda: nw.align_batch(sa, sb))
    for i, aln in zip(pick, alns):
        check(aln.score == scores[i] ==
              rescore(nw.scoring, aln.result_a, aln.result_b),
              "phase 2: pair %d rescored != phase-1 score" % i)
    for j in range(4):
        check(alns[j] == host_dp.nw_align(nw.scoring, sa[j], sb[j]),
              "phase 2: pair %d strings differ from the host" % pick[j])
    log("phase 2 NW align_batch %s: 64 pairs %.1f s (%.2f GCUPS incl. "
        "compile), rescored == scores, 4 == host: OK"
        % (tag, dt, gcups(list(zip(sa, sb)), dt)))


def phase_sw_align(tmp, tag):
    from seqalign_tpu.aligners import SmithWaterman
    from seqalign_tpu.ops import host_dp

    pairs = read_pairs(gen_pairs(tmp, "sw", size(256), size(1000),
                                 size(2000), SEED + 10))
    sw = SmithWaterman()
    sa = [a for a, _ in pairs]
    sb = [b for _, b in pairs]
    min_score = size(100)
    its, dt = timed(lambda: sw.align_batch(sa, sb, [min_score] * len(sa)))
    for j in range(4):
        # hits below the min-score hint may be pruned from the stream
        host = host_dp.HostSwHits(sw.scoring, sa[j], sb[j])
        want = [h for h in (host.fetch() for _ in range(3))
                if h is not None and h.score >= min_score]
        got = [its[j].fetch() for _ in range(len(want))]
        check(want and got == want, "phase 3: pair %d hits differ" % j)
    log("phase 3 SW align_batch %s: 256 pairs %.1f s (%.2f GCUPS incl. "
        "compile), first 3 hits of 4 pairs == host: OK"
        % (tag, dt, gcups(pairs, dt)))


def phase_matrices(tag):
    import numpy as np

    from seqalign_tpu.aligners import NeedlemanWunsch, SmithWaterman
    from seqalign_tpu.scoring.config import ScoringConfig
    from seqalign_tpu.scoring.presets import scoring_system_BLOSUM62

    rng = np.random.default_rng(SEED + 20)
    aa = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    lo, hi = size(100), size(1000) + 1
    prot = [(aa[rng.integers(0, 20, rng.integers(lo, hi))].tobytes()
             .decode(), aa[rng.integers(0, 20, rng.integers(lo, hi))]
             .tobytes().decode()) for _ in range(size(2048))]
    b62 = scoring_system_BLOSUM62()
    got, dt = timed(lambda: SmithWaterman(b62).best_score_batch(
        [a for a, _ in prot], [b for _, b in prot]))
    for j in range(8):
        check(got[j] == host_score(b62, *prot[j], True),
              "phase 4: protein pair %d differs from the host" % j)
    log("phase 4 BLOSUM62 SW scores %s: 2048 pairs %.1f s (%.2f GCUPS "
        "incl. compile), 8 == host: OK" % (tag, dt, gcups(prot, dt)))

    big = ScoringConfig(0, 0, -3000, -700).add_mutations(
        "acgt", [[5001, -2049, -4097, -3001], [-2049, 6007, -2051, -4099],
                 [-4097, -2051, 7919, -2053], [-3001, -4099, -2053, 4099]],
        use_match_mismatch=False)
    dna = np.frombuffer(b"acgt", np.uint8)
    pairs = [(dna[rng.integers(0, 4, rng.integers(200, 601))].tobytes()
              .decode(), dna[rng.integers(0, 4, rng.integers(200, 601))]
              .tobytes().decode()) for _ in range(64)]
    got = NeedlemanWunsch(big).score_batch([a for a, _ in pairs],
                                           [b for _, b in pairs])
    for j, (a, b) in enumerate(pairs):
        check(got[j] == host_score(big, a, b, False),
              "phase 4: large-matrix pair %d differs from the host" % j)
    log("phase 4 matrix entries >= 2^11 %s: 64 NW scores == host: OK" % tag)


def phase_long(tmp, tag):
    from seqalign_tpu import aligners
    from seqalign_tpu.aligners import NeedlemanWunsch

    (a, b), = read_pairs(gen_pairs(tmp, "long", 1, size(12000),
                                   size(12000), SEED + 30))
    check(len(a) * len(b) > aligners.LONG_PAIR_CELLS,
          "phase 5: pair is not past LONG_PAIR_CELLS")
    nw = NeedlemanWunsch()
    before = aligners.dispatch_counts().get("chunked_xla", 0)
    (aln,), dt = timed(lambda: nw.align_batch([a], [b]))
    check(aligners.dispatch_counts().get("chunked_xla", 0) > before,
          "phase 5: the chunked fill did not run")
    score = int(nw.score_batch([a], [b])[0])
    check(rescore(nw.scoring, aln.result_a, aln.result_b) == aln.score
          == score, "phase 5: rescored alignment != score_batch")
    log("phase 5 long pair %s: %dx%d aligned in %.1f s, rescored == "
        "score_batch: OK" % (tag, len(a), len(b), dt))


def phase_cli(tmp, tag):
    from seqalign_tpu import aligners
    from seqalign_tpu.cli.needleman_wunsch import main

    pairs = read_pairs(gen_pairs(tmp, "cli", 64, size(1000), size(3000),
                                 SEED + 40))
    path = os.path.join(tmp, "cli.fa")
    write_fasta(path, pairs)
    args = ["--printscores", "--file", path]
    host = subprocess.run(
        [os.path.join(REPO, "bin", "needleman_wunsch")] + args,
        env=dict(os.environ, SEQALIGN_FORCE="host"), capture_output=True,
        check=True, timeout=900).stdout
    # the device route runs the same entry point in this process: one
    # process per card
    out = io.StringIO()
    before = aligners.dispatch_counts().get("dirs_xla", 0)
    with contextlib.redirect_stdout(out):
        rc, dt = timed(lambda: main(["needleman_wunsch"] + args))
    check(rc in (None, 0), "phase 6: CLI exit %r" % rc)
    check(aligners.dispatch_counts().get("dirs_xla", 0) > before,
          "phase 6: the CLI did not route to the device")
    check(out.getvalue().encode() == host,
          "phase 6: device CLI output differs from the host route")
    log("phase 6 CLI %s: 64 pairs of 1-3 kb in %.1f s on the device, "
        "bytes == host route: OK" % (tag, dt))


def one_card(tmp):
    tag = "[%s]" % card()  # raises where there is no NVIDIA driver
    log("card: " + tag)
    phase_gpu_tests(tmp, "(before JAX starts here)")
    import jax

    check(jax.default_backend() == "gpu", "no GPU: backend %s"
          % jax.default_backend())
    pairs, scores = phase_e2e(tmp, tag)
    phase_nw_align(tag, pairs, scores)
    phase_sw_align(tmp, tag)
    phase_matrices(tag)
    phase_long(tmp, tag)
    phase_cli(tmp, tag)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def dist_worker(path: str) -> None:
    """One process of distributed_score_file: one card, scores on stdout."""
    import jax

    from seqalign_tpu.parallel.distributed import (
        distributed_score_file, init_from_env,
    )
    from seqalign_tpu.scoring.presets import scoring_system_default

    check(init_from_env(), "worker: no coordinator")
    check(jax.local_devices()[0].platform == "gpu", "worker: no GPU")
    scores = distributed_score_file(scoring_system_default(), path,
                                    is_sw=False)
    print(json.dumps([int(s) for s in scores]))


def phase_distributed(path, tag):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(4):
        # files, not pipes: a worker blocked on a full pipe would stall
        # the others in the collective
        out, err = (open("%s.%d.%s" % (path, rank, s), "w+")
                    for s in ("out", "err"))
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             path], cwd=REPO, stdout=out, stderr=err, env=dict(
                os.environ, CUDA_VISIBLE_DEVICES=str(rank),
                SEQALIGN_COORDINATOR="localhost:%d" % port,
                SEQALIGN_NUM_PROCS="4", SEQALIGN_PROC_ID=str(rank))),
            out, err))
    outs = []
    try:
        for p, out, err in procs:
            p.wait(timeout=900)
            out.seek(0)
            err.seek(0)
            check(p.returncode == 0,
                  "distributed worker failed:\n" + err.read()[-3000:])
            outs.append(json.loads(out.read().strip().splitlines()[-1]))
    finally:
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()
    check(all(o == outs[0] for o in outs), "workers disagree")
    return outs[0]


def four_cards(tmp):
    path = gen_pairs(tmp, "four", size(1024), size(1000), size(3000),
                     SEED + 50)
    (dist, dt_dist) = timed(lambda: phase_distributed(path, ""))
    import jax

    check(jax.default_backend() == "gpu" and len(jax.devices()) == 4,
          "need four GPUs, found %s x %d" % (jax.default_backend(),
                                             len(jax.devices())))
    tag = "[%s]" % card().replace("\n", "; ")
    log("cards: " + tag)
    from seqalign_tpu.aligners import NeedlemanWunsch, SmithWaterman
    from seqalign_tpu.parallel.engine import (
        make_mesh, sharded_align_batch, sharded_score_batch,
    )
    from seqalign_tpu.parallel.wavefront_sp import sp_align_nw, sp_scores
    from seqalign_tpu.scoring.presets import (
        scoring_system_default, scoring_system_sw_default,
    )

    sc = scoring_system_default()
    pairs = read_pairs(path)
    sa = [a for a, _ in pairs]
    sb = [b for _, b in pairs]
    one, dt1 = timed(lambda: NeedlemanWunsch(sc).score_batch(sa, sb))
    check(list(one) == dist, "distributed scores != one-card scores")
    log("four: distributed_score_file %s: 4 processes, 1024 pairs %.1f s "
        "== one card: OK" % (tag, dt_dist))
    mesh = make_mesh(4)
    got, dt4 = timed(lambda: sharded_score_batch(sc, sa, sb, is_sw=False,
                                                 mesh=mesh))
    check(list(got) == list(one), "sharded scores != one-card scores")
    log("four: sharded_score_batch %s: 1024 pairs %.1f s (one card %.1f "
        "s, both incl. compile) == one card: OK" % (tag, dt4, dt1))

    # the sharded align path fetches whole dirs (and SW's M) to the host,
    # so it gets fewer pairs than the scores paths
    sub_a, sub_b = sa[:32], sb[:32]
    nw_one = NeedlemanWunsch(sc).align_batch(sub_a, sub_b)
    nw_four, dt_nw = timed(lambda: sharded_align_batch(
        sc, sub_a, sub_b, is_sw=False, mesh=mesh))
    check(nw_four == nw_one, "sharded NW alignments != one card")
    sub_a, sub_b = sa[:16], sb[:16]
    swc = scoring_system_sw_default()
    min_score = size(100)
    sw_one = SmithWaterman(swc).align_batch(sub_a, sub_b,
                                            [min_score] * len(sub_a))
    sw_four, dt_sw = timed(lambda: sharded_align_batch(
        swc, sub_a, sub_b, is_sw=True, mesh=mesh))
    for j in range(len(sub_a)):
        want = [h for h in (sw_four[j].fetch() for _ in range(3))
                if h is not None and h.score >= min_score]
        check(want and [sw_one[j].fetch() for _ in want] == want,
              "sharded SW hits != one card (pair %d)" % j)
    log("four: sharded_align_batch %s: 32 NW alignments (%.1f s) and SW "
        "hits of 16 pairs (%.1f s) == one card: OK" % (tag, dt_nw, dt_sw))

    (a, b), = read_pairs(gen_pairs(tmp, "sp", 1, size(20000), size(20000),
                                   SEED + 60))
    mesh_sp = make_mesh(4, axis="seq")
    sp, dt_sp = timed(lambda: sp_scores(sc, [a], [b], mesh_sp))
    ref = NeedlemanWunsch(sc).score_batch([a], [b])
    check(int(sp[0]) == int(ref[0]), "sp_scores != one card")
    aln, dt_al = timed(lambda: sp_align_nw(sc, a, b, mesh_sp))
    check(aln == NeedlemanWunsch(sc).align_batch([a], [b])[0],
          "sp_align_nw != one card")
    log("four: sp_scores %.1f s, sp_align_nw %.1f s %s on a %dx%d pair == "
        "one card: OK" % (dt_sp, dt_al, tag, len(a), len(b)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-card phases on four GPUs")
    ap.add_argument("--dist-worker", metavar="FASTA",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    if args.dist_worker:
        dist_worker(args.dist_worker)
        return
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four:
            four_cards(tmp)
        else:
            one_card(tmp)
    import jax

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
