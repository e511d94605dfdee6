"""Streaming / on-device SW candidate extraction: with a min_score hint the
M matrix never reaches the host (dp.sw_extract_candidates harvests (flat,
score) pairs on device; chunked mode per slab) — and the emitted hit stream
must stay EXACTLY the reference's best-first sequence down to the threshold
(smith_waterman.c:153-161 ordering, 187-190 overlap-abort semantics)."""

import numpy as np
import pytest

from seqalign_tpu import aligners
from seqalign_tpu.aligners import SmithWaterman
from seqalign_tpu.ops import dp
from seqalign_tpu.scoring.config import ScoringConfig
from seqalign_tpu.scoring.presets import scoring_system_sw_default


def _rand_seq(rng, n):
    return "".join(rng.choice(list("acgt"), n))


def _key(h):
    return (h.score, h.pos_a, h.pos_b, h.len_a, h.len_b,
            h.result_a, h.result_b)


def _stream(it, min_score):
    """Consume like the CLI: best-first until below min_score."""
    out = []
    for h in it:
        if h.score < min_score:
            break
        out.append(_key(h))
    return out


def test_extract_candidates_matches_host_enumeration():
    rng = np.random.default_rng(7)
    sc = scoring_system_sw_default()
    seqs_a = [_rand_seq(rng, n) for n in (60, 33, 80, 5)]
    seqs_b = [_rand_seq(rng, n) for n in (50, 70, 21, 64)]
    out, na, nb = dp.fill_batch(sc, seqs_a, seqs_b, is_sw=True,
                                emit_dirs=False, emit_m=True)
    mmat = np.asarray(out.mmat)
    for min_s in (1, 3, 8):
        cands = dp.sw_extract_candidates(out.mmat, na, nb, min_s)
        for i, (sa, sb) in enumerate(zip(seqs_a, seqs_b)):
            w = len(sa) + 1
            want = []
            for y in range(1, len(sb) + 1):
                row = mmat[i, y - 1: y - 1 + len(sa), y]
                for xo in np.nonzero(row >= min_s)[0]:
                    want.append((y * w + xo + 1, int(row[xo])))
            got = sorted(zip(cands[i][0].tolist(), cands[i][1].tolist()))
            assert got == sorted(want), (i, min_s)


@pytest.mark.parametrize("min_score", [1, 4, 10])
def test_device_pruned_stream_matches_unpruned(monkeypatch, min_score):
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    rng = np.random.default_rng(min_score)
    sw = SmithWaterman(scoring_system_sw_default())
    seqs_a = [_rand_seq(rng, n) for n in (40, 75, 64)]
    seqs_b = [_rand_seq(rng, n) for n in (66, 30, 64)]
    plain = sw.align_batch(seqs_a, seqs_b)
    pruned = sw.align_batch(seqs_a, seqs_b, min_scores=[min_score] * 3)
    for p, q in zip(plain, pruned):
        want = _stream(p, min_score)
        got = [_key(h) for h in q]
        # pruned stream = exact prefix >= min_score
        assert got[: len(want)] == want
        assert all(k[0] >= min_score for k in got)


@pytest.mark.parametrize("chunk", [16, 48])
def test_streaming_chunked_matches_oneshot(chunk):
    rng = np.random.default_rng(chunk)
    a, b = _rand_seq(rng, 90), _rand_seq(rng, 60)
    sw = SmithWaterman(scoring_system_sw_default())
    min_score = 6
    one = _stream(sw.align(a, b), min_score)
    stream = [_key(h)
              for h in sw.align_long(a, b, chunk=chunk, min_score=min_score)]
    assert stream[: len(one)] == one
    assert all(k[0] >= min_score for k in stream)


def test_streaming_never_materializes_m(monkeypatch):
    """The streaming path must not fetch M slabs to host."""
    calls = []
    orig = np.asarray

    def spy(x, *a, **k):
        arr = orig(x, *a, **k)
        calls.append(arr.nbytes)
        return arr

    sw = SmithWaterman(scoring_system_sw_default())
    rng = np.random.default_rng(3)
    a, b = _rand_seq(rng, 200), _rand_seq(rng, 150)
    it = sw.align_long(a, b, chunk=64, min_score=20)
    hits = list(it)
    assert it.mmat is None
    assert all(h.score >= 20 for h in hits)


def test_constrained_mode_pruned_stream(monkeypatch):
    """Pruning composes with the constrained no-gap scoring modes on the
    XLA device path."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    sc = ScoringConfig(2, -2, -2, -1, no_gaps_in_a=True, no_gaps_in_b=True)
    rng = np.random.default_rng(9)
    a, b = _rand_seq(rng, 55), _rand_seq(rng, 48)
    sw = SmithWaterman(sc)
    want = _stream(sw.align(a, b), 4)
    got = [_key(h) for h in sw.align(a, b, min_score=4)]
    assert got[: len(want)] == want


def test_pallas_path_device_candidates(monkeypatch):
    """Through the device dirs fill with min_scores, the M planes never
    reach the host — candidates are harvested on device — and the hit
    stream matches the host path exactly."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    rng = np.random.default_rng(13)
    sw = SmithWaterman(scoring_system_sw_default())
    seqs_a = ["".join(rng.choice(list("acgt"), rng.integers(5, 15)))
              for _ in range(5)]
    seqs_b = ["".join(rng.choice(list("acgt"), rng.integers(5, 15)))
              for _ in range(5)]
    import seqalign_tpu.ops.host_dp as host_dp

    pruned = sw.align_batch(seqs_a, seqs_b, min_scores=[4] * 5)
    for it, a, b in zip(pruned, seqs_a, seqs_b):
        assert it.mmat is None  # device harvest: no M on host
        want = _stream(host_dp.HostSwHits(sw.scoring, a, b), 4)
        got = [_key(h) for h in it]
        assert got[: len(want)] == want
        assert all(k[0] >= 4 for k in got)


def test_cli_output_identical_with_pruning(monkeypatch, tmp_path, capsys):
    """Full SW CLI bytes with the device path + pruning == host-path bytes
    (the pruning hint must be invisible in output)."""
    from seqalign_tpu.cli.smith_waterman import main

    rng = np.random.default_rng(21)
    fa = tmp_path / "pairs.fa"
    recs = []
    for i in range(6):
        recs.append(">a%d\n%s\n>b%d\n%s\n"
                    % (i, _rand_seq(rng, 40 + i * 13), i,
                       _rand_seq(rng, 35 + i * 9)))
    fa.write_text("".join(recs))

    monkeypatch.setenv("SEQALIGN_FORCE", "host")
    main(["sw", "--pretty", "--printseq", "--file", str(fa)])
    host_out = capsys.readouterr().out
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    main(["sw", "--pretty", "--printseq", "--file", str(fa)])
    dev_out = capsys.readouterr().out
    assert dev_out == host_out


def test_device_walker_candidate_gate(monkeypatch):
    """Hit streams are identical whether the iterator uses the batched
    device pre-walk (small candidate sets) or the dirs-fetch host walk
    (the gate's choice for hint-less wide pairs, where per-hit device
    walks would cost a device round trip each)."""
    import seqalign_tpu.aligners as aligners
    from seqalign_tpu.aligners import SmithWaterman

    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    rng = np.random.default_rng(42)
    dna = list("acgt")
    sa = ["".join(rng.choice(dna, int(n)))
          for n in rng.integers(30, 90, 6)]
    sb = ["".join(rng.choice(dna, int(n)))
          for n in rng.integers(30, 90, 6)]

    def stream(threshold):
        monkeypatch.setattr(aligners, "_SW_DEVWALK_CANDS", threshold)
        al = SmithWaterman()
        return [[(h.score, h.pos_a, h.pos_b, h.result_a, h.result_b)
                 for h in hs] for hs in al.align_batch(sa, sb)]

    dev = stream(1 << 30)  # everything on the device walker
    host = stream(0)       # everything on the host walk
    assert dev == host
    assert any(dev)  # the comparison is not vacuous
