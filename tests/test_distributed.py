"""Multi-host wiring test: a REAL 2-process jax.distributed run on CPU.

Two worker processes form a cluster via jax.distributed.initialize, each
reads its round-robin pair shard of the same input file
(io.seqio.read_pairs_sharded), scores locally, and allgathers — both must
print the complete, identical, pair-ordered score vector, equal to a
single-process run.  (SURVEY §2.4-3; the same code path several hosts
run, one process per device.)
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_dist_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_pairs(tmp_path, n_pairs=11, seed=5):
    rng = np.random.default_rng(seed)
    seqs = []
    p = tmp_path / "pairs.fa"
    with open(p, "w") as fh:
        for i in range(2 * n_pairs):
            s = "".join(rng.choice(list("acgt"), rng.integers(2, 30)))
            seqs.append(s)
            fh.write(f">s{i}\n{s}\n")
    return str(p), seqs


@pytest.mark.parametrize("is_sw", [False, True])
def test_two_process_distributed_scores(tmp_path, is_sw):
    path, seqs = _write_pairs(tmp_path)
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            SEQALIGN_COORDINATOR=f"127.0.0.1:{port}",
            SEQALIGN_NUM_PROCS="2",
            SEQALIGN_PROC_ID=str(pid),
            JAX_PLATFORMS="cpu",
        )
        cmd = [sys.executable, WORKER, path] + (["--sw"] if is_sw else [])
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd=REPO,
        ))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err.decode()[-2000:]
        outs.append(json.loads(out.decode().strip().splitlines()[-1]))

    # single-process ground truth
    from seqalign_tpu.aligners import NeedlemanWunsch, SmithWaterman

    sa = seqs[0::2]
    sb = seqs[1::2]
    if is_sw:
        want = [int(s) for s in SmithWaterman().best_score_batch(sa, sb)]
    else:
        want = [int(s) for s in NeedlemanWunsch().score_batch(sa, sb)]

    for o in outs:
        assert o["multi"] is True
        assert o["scores"] == want


def test_single_process_distributed_score_file(tmp_path):
    """No coordinator configured: degrades to a plain local run."""
    path, seqs = _write_pairs(tmp_path, n_pairs=5, seed=9)
    from seqalign_tpu.aligners import NeedlemanWunsch
    from seqalign_tpu.parallel.distributed import distributed_score_file
    from seqalign_tpu.scoring.presets import scoring_system_default

    got = distributed_score_file(scoring_system_default(), path, is_sw=False)
    want = NeedlemanWunsch().score_batch(seqs[0::2], seqs[1::2])
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("is_sw", [False, True])
def test_two_process_distributed_alignments(tmp_path, is_sw):
    """Full alignments across 2 real jax.distributed processes: both hosts
    must assemble the identical, complete, pair-ordered alignment records
    (SURVEY §2.4-3 — scores AND packed traceback strings across processes)."""
    path, seqs = _write_pairs(tmp_path, n_pairs=9, seed=13)
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            SEQALIGN_COORDINATOR=f"127.0.0.1:{port}",
            SEQALIGN_NUM_PROCS="2",
            SEQALIGN_PROC_ID=str(pid),
            JAX_PLATFORMS="cpu",
        )
        cmd = [sys.executable, WORKER, path, "--align"] + (
            ["--sw"] if is_sw else [])
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd=REPO,
        ))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err.decode()[-2000:]
        outs.append(json.loads(out.decode().strip().splitlines()[-1]))

    from seqalign_tpu.aligners import NeedlemanWunsch, SmithWaterman

    sa = seqs[0::2]
    sb = seqs[1::2]
    if is_sw:
        want = [[[h.result_a, h.result_b, h.score, h.pos_a, h.pos_b]
                 for h in hits]
                for hits in SmithWaterman().align_batch(
                    sa, sb, min_scores=[1] * len(sa))]
        norm = lambda alns: [[list(h) for h in hits] for hits in alns]  # noqa: E731
    else:
        want = [[r.result_a, r.result_b, r.score]
                for r in NeedlemanWunsch().align_batch(sa, sb)]
        norm = lambda alns: [list(r) for r in alns]  # noqa: E731

    for o in outs:
        assert o["multi"] is True
        assert norm(o["alns"]) == want
