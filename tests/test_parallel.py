"""Sharded (8-virtual-device mesh) batch scoring must agree with the
single-device path and the numpy oracle."""

import numpy as np

from seqalign_tpu.aligners import NeedlemanWunsch, SmithWaterman
from seqalign_tpu.ops import oracle
from seqalign_tpu.parallel.engine import make_mesh, sharded_score_batch
from seqalign_tpu.scoring.presets import (
    scoring_system_default,
    scoring_system_sw_default,
)


def _rand_pairs(n, rng, maxlen=40):
    pairs = []
    for _ in range(n):
        la, lb = rng.integers(1, maxlen, 2)
        pairs.append((
            "".join(rng.choice(list("acgt"), la)),
            "".join(rng.choice(list("acgt"), lb)),
        ))
    return pairs


def test_sharded_nw_scores_match():
    rng = np.random.default_rng(7)
    pairs = _rand_pairs(13, rng)  # deliberately not a multiple of 8
    sc = scoring_system_default()
    mesh = make_mesh(8)
    got = sharded_score_batch(sc, [a for a, _ in pairs], [b for _, b in pairs],
                              is_sw=False, mesh=mesh)
    want = NeedlemanWunsch(sc).score_batch([a for a, _ in pairs],
                                           [b for _, b in pairs])
    np.testing.assert_array_equal(got, want)
    for (a, b), s in zip(pairs, got):
        assert oracle.nw_align(sc, a, b)[2] == s


def test_sharded_sw_best_scores_match():
    rng = np.random.default_rng(8)
    pairs = _rand_pairs(8, rng)
    sc = scoring_system_sw_default()
    mesh = make_mesh(8)
    got = sharded_score_batch(sc, [a for a, _ in pairs], [b for _, b in pairs],
                              is_sw=True, mesh=mesh)
    want = SmithWaterman(sc).best_score_batch([a for a, _ in pairs],
                                              [b for _, b in pairs])
    np.testing.assert_array_equal(got, want)


def test_sharded_align_batch_traceback_matches_host():
    """Full-traceback fills over the mesh (ragged batch): alignments and SW
    hit streams must equal the host reference path exactly."""
    from seqalign_tpu.ops import host_dp
    from seqalign_tpu.parallel.engine import sharded_align_batch

    rng = np.random.default_rng(9)
    pairs = _rand_pairs(11, rng)
    sa = [a for a, _ in pairs]
    sb = [b for _, b in pairs]
    mesh = make_mesh(8)

    sc = scoring_system_default()
    got = sharded_align_batch(sc, sa, sb, is_sw=False, mesh=mesh)
    want = [host_dp.nw_align(sc, a, b) for a, b in pairs]
    assert got == want

    sw = scoring_system_sw_default()
    got_h = [list(h) for h in sharded_align_batch(sw, sa, sb, is_sw=True,
                                                  mesh=mesh)]
    want_h = [list(host_dp.HostSwHits(sw, a, b)) for a, b in pairs]
    assert got_h == want_h


def test_sharded_fill_rides_v2_kernel():
    """The sharded align path fills every shard with the XLA dirs scan
    (the only traceback fill) and reproduces the host alignments."""
    import numpy as np

    from seqalign_tpu import aligners
    from seqalign_tpu.ops import host_dp
    from seqalign_tpu.parallel.engine import make_mesh, sharded_align_batch
    from seqalign_tpu.scoring.presets import scoring_system_default

    rng = np.random.default_rng(9)
    lut = np.frombuffer(b"acgt", dtype=np.uint8)
    seqs_a = [bytes(lut[rng.integers(0, 4, rng.integers(1, 120))]).decode()
              for _ in range(11)]
    seqs_b = [bytes(lut[rng.integers(0, 4, rng.integers(1, 90))]).decode()
              for _ in range(11)]
    sc = scoring_system_default()
    before = aligners.dispatch_counts().get("sharded_dirs_xla", 0)
    res = sharded_align_batch(sc, seqs_a, seqs_b, is_sw=False,
                              mesh=make_mesh())
    after = aligners.dispatch_counts().get("sharded_dirs_xla", 0)
    assert after > before, "sharded fill did not ride the XLA dirs scan"
    for j in range(len(seqs_a)):
        w = host_dp.nw_align(sc, seqs_a[j], seqs_b[j])
        assert (res[j].result_a, res[j].result_b, res[j].score) == (
            w.result_a, w.result_b, w.score)


def test_sharded_scores_gap_open_positive_correct(monkeypatch):
    """The scores kernel's folded H = max(M, Ga, Gb) reduction is only
    valid for gap_open <= 0: a positive-gap_open config must stay on the
    XLA shard path even when the kernel route is on, and stay exact vs
    the host fill for both NW and SW."""
    monkeypatch.setenv("SEQALIGN_PALLAS", "interpret")
    from seqalign_tpu.ops import host_dp
    from seqalign_tpu.scoring.config import ScoringConfig

    rng = np.random.default_rng(11)
    pairs = _rand_pairs(21, rng)
    sa = [a for a, _ in pairs]
    sb = [b for _, b in pairs]
    sc = ScoringConfig(match=2, mismatch=-3, gap_open=1, gap_extend=-1)
    mesh = make_mesh(8)
    for is_sw in (False, True):
        got = sharded_score_batch(sc, sa, sb, is_sw=is_sw, mesh=mesh)
        want = np.zeros(len(sa), np.int32)
        for i, (a, b) in enumerate(pairs):
            M, Ga, Gb = host_dp.fill_matrices(sc, a, b, is_sw)
            want[i] = M.max(initial=0) if is_sw else max(
                M[-1, -1], Ga[-1, -1], Gb[-1, -1])
        np.testing.assert_array_equal(got, want)


def test_sharded_scores_ragged_batch_rides_v2(monkeypatch):
    """Filler rows of a ragged (non-mesh-multiple) batch record length 1,
    so the batch still takes the kernel route under shard_map (here in
    the Pallas interpreter) and stays exact."""
    from seqalign_tpu import aligners

    monkeypatch.setenv("SEQALIGN_PALLAS", "interpret")
    rng = np.random.default_rng(12)
    pairs = _rand_pairs(13, rng)  # 13 % 8 != 0 -> ragged
    sa = [a for a, _ in pairs]
    sb = [b for _, b in pairs]
    sc = scoring_system_default()
    mesh = make_mesh(8)
    before = aligners.dispatch_counts().get("sharded_scores_kernel", 0)
    got = sharded_score_batch(sc, sa, sb, is_sw=False, mesh=mesh)
    after = aligners.dispatch_counts().get("sharded_scores_kernel", 0)
    assert after > before, "ragged batch did not ride the scores kernel"
    monkeypatch.setenv("SEQALIGN_PALLAS", "off")
    want = NeedlemanWunsch(sc).score_batch(sa, sb)
    np.testing.assert_array_equal(got, want)


def test_sharded_score_stream_double_buffered():
    """The streaming scorer must yield per-batch results identical to
    sharded_score_batch, in order, with multiple batches in flight."""
    from seqalign_tpu.parallel.engine import sharded_score_stream

    rng = np.random.default_rng(17)
    sc = scoring_system_default()
    mesh = make_mesh(8)
    batches = []
    for n in (13, 8, 3, 16):  # ragged + exact mesh multiples
        pairs = _rand_pairs(n, rng)
        batches.append(([a for a, _ in pairs], [b for _, b in pairs]))
    got = list(sharded_score_stream(sc, iter(batches), is_sw=False,
                                    mesh=mesh, depth=3))
    assert len(got) == len(batches)
    for (sa, sb), g in zip(batches, got):
        want = sharded_score_batch(sc, sa, sb, is_sw=False, mesh=mesh)
        np.testing.assert_array_equal(g, want)
