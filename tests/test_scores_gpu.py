"""The GPU scores kernel (ops/scores_gpu.py) in the Pallas interpreter
against the XLA wavefront, its eligibility gate, and the one routing
decision in aligners._scores_route.  Tests marked ``gpu`` compile the
kernel for a real card and skip elsewhere."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from seqalign_tpu import aligners
from seqalign_tpu.ops import dp, host_dp, scores_gpu
from seqalign_tpu.scoring.config import ScoringConfig
from seqalign_tpu.scoring.presets import (
    scoring_system_BLOSUM62,
    scoring_system_default,
    scoring_system_sw_default,
)


def _pairs(rng, B, LA, LB, alpha="acgtACGT", min_len=1):
    sa = ["".join(rng.choice(list(alpha), rng.integers(min_len, LA + 1)))
          for _ in range(B)]
    sb = ["".join(rng.choice(list(alpha), rng.integers(min_len, LB + 1)))
          for _ in range(B)]
    return sa, sb


def _kernel_scores(sc, sa, sb, is_sw, pad_a=None, pad_b=None):
    ac, bc, na, nb = dp.pack_inputs_mm(sc, sa, sb, pad_a, pad_b)
    return np.asarray(scores_gpu.scores_gpu(
        jnp.asarray(ac), jnp.asarray(bc), jnp.asarray(na), jnp.asarray(nb),
        is_sw=is_sw, nsg=sc.no_start_gap_penalty,
        neg=sc.no_end_gap_penalty, match=sc.match, mismatch=sc.mismatch,
        go=sc.gap_open, ge=sc.gap_extend, mn=sc.dp_floor(is_sw),
        interpret=True))


def _xla_scores(sc, sa, sb, is_sw):
    out, _, _ = dp.fill_batch(sc, sa, sb, is_sw=is_sw, emit_dirs=False)
    return np.asarray(out.best) if is_sw else \
        np.asarray(out.corner).max(axis=1)


# (B, LA, LB, pad): ragged batches below one block, across blocks and
# column tiles, non-pow2 widths, and length-1 pairs
_SHAPES = [(5, 9, 7, None), (40, 70, 45, None), (33, 128, 100, (128, 128)),
           (64, 3, 2, None)]
_FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(
    map(str, s[:3])))
@pytest.mark.parametrize("nsg,neg", _FLAGS, ids=["dflt", "nsg", "neg",
                                                 "nsg+neg"])
@pytest.mark.parametrize("is_sw", [False, True], ids=["nw", "sw"])
def test_kernel_matches_xla(is_sw, nsg, neg, shape):
    B, LA, LB, pad = shape
    sc = ScoringConfig(2 if is_sw else 1, -2, -4, -1,
                       no_start_gap_penalty=nsg, no_end_gap_penalty=neg)
    rng = np.random.default_rng(B + LA + 7 * nsg + 11 * neg + is_sw)
    sa, sb = _pairs(rng, B, LA, LB)
    pa, pb = pad or (None, None)
    got = _kernel_scores(sc, sa, sb, is_sw, pa, pb)
    np.testing.assert_array_equal(got, _xla_scores(sc, sa, sb, is_sw))


@pytest.mark.parametrize("cfg", [
    (1, -1, 0, 0), (2, -1, 0, 0), (5, -4, -10, -1), (1, 1, -3, -2),
    (0, -3, -1, -1), (3, -7, -8, -3)], ids=str)
@pytest.mark.parametrize("is_sw", [False, True], ids=["nw", "sw"])
def test_kernel_scoring_values(is_sw, cfg):
    """Zero gaps, positive mismatch, zero match, large penalties: the
    folded recurrence and the dropped floors stay exact."""
    sc = ScoringConfig(*cfg, case_sensitive=True)
    assert scores_gpu.eligible(sc, is_sw, 64, 64)
    rng = np.random.default_rng(sum(cfg) + 40 + is_sw)
    sa, sb = _pairs(rng, 37, 60, 50)
    np.testing.assert_array_equal(_kernel_scores(sc, sa, sb, is_sw),
                                  _xla_scores(sc, sa, sb, is_sw))


def test_kernel_default_presets_vs_host():
    """The presets through the kernel equal the int64 host fill."""
    rng = np.random.default_rng(3)
    sa, sb = _pairs(rng, 20, 40, 40, alpha="acgt")
    for sc, is_sw in ((scoring_system_default(), False),
                      (scoring_system_sw_default(), True)):
        got = _kernel_scores(sc, sa, sb, is_sw)
        for g, a, b in zip(got, sa, sb):
            M, Ga, Gb = host_dp.fill_matrices(sc, a, b, is_sw)
            want = M.max(initial=0) if is_sw else max(
                M[-1, -1], Ga[-1, -1], Gb[-1, -1])
            assert g == want


def _cfg(kind):
    if kind == "default":
        return scoring_system_default()
    if kind == "free_gaps":
        return ScoringConfig(1, -2, -4, -1, no_start_gap_penalty=True,
                             no_end_gap_penalty=True)
    if kind == "wildcard":
        return ScoringConfig(2, -3, -5, -2).add_wildcard("n", 1)
    if kind == "swap":
        return ScoringConfig(1, -2, -4, -1).add_mutation("a", "g", 0)
    if kind == "blosum62":
        return scoring_system_BLOSUM62()
    if kind == "no_gaps_a":
        return ScoringConfig(1, -2, -4, -1, no_gaps_in_a=True)
    if kind == "no_gaps_b":
        return ScoringConfig(1, -2, -4, -1, no_gaps_in_b=True)
    if kind == "no_mismatches":
        return ScoringConfig(1, -2, -4, -1, no_mismatches=True)
    if kind == "gap_open_positive":
        return ScoringConfig(2, -3, 1, -1)
    if kind == "gap_extend_positive":
        return ScoringConfig(2, -3, -2, 1)
    if kind == "beyond_sentinel":
        sc = scoring_system_default()
        sc.mismatch = -100  # CLI-style mutation: min_penalty stays frozen
        sc._luts = None
        return sc
    raise KeyError(kind)


_ROUTES = [
    # (config, is_sw, route on a GPU)
    ("default", False, "kernel"), ("default", True, "kernel"),
    ("free_gaps", False, "kernel"), ("free_gaps", True, "kernel"),
    ("wildcard", False, "xla"), ("swap", True, "xla"),
    ("blosum62", True, "xla"), ("no_gaps_a", False, "xla"),
    ("no_gaps_b", True, "xla"), ("no_mismatches", False, "xla"),
    ("gap_open_positive", False, "xla"), ("gap_extend_positive", True,
                                          "xla"),
    ("beyond_sentinel", False, "xla"), ("beyond_sentinel", True, "kernel"),
]


@pytest.fixture
def gpu_backend(monkeypatch):
    """Make the route gate see a GPU backend (nothing compiles here)."""
    monkeypatch.delenv("SEQALIGN_PALLAS", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


@pytest.mark.parametrize("kind,is_sw,route", _ROUTES,
                         ids=[f"{k}-{'sw' if s else 'nw'}"
                              for k, s, _ in _ROUTES])
def test_route_by_mode_on_gpu(gpu_backend, monkeypatch, kind, is_sw, route):
    sc = _cfg(kind)
    assert aligners._scores_route(sc, is_sw, 1024, 1024) == route
    # the two explicit modes: off pins XLA, interpret runs the kernel in
    # the interpreter wherever the kernel is eligible
    monkeypatch.setenv("SEQALIGN_PALLAS", "off")
    assert aligners._scores_route(sc, is_sw, 1024, 1024) == "xla"
    monkeypatch.setenv("SEQALIGN_PALLAS", "interpret")
    want = "interpret" if route == "kernel" else "xla"
    assert aligners._scores_route(sc, is_sw, 1024, 1024) == want


def test_route_cpu_never_interprets(monkeypatch):
    """Without SEQALIGN_PALLAS=interpret a CPU backend takes XLA: the
    interpreter is never chosen implicitly."""
    monkeypatch.delenv("SEQALIGN_PALLAS", raising=False)
    assert jax.default_backend() == "cpu"
    for sc, is_sw in ((scoring_system_default(), False),
                      (scoring_system_sw_default(), True)):
        assert aligners._scores_route(sc, is_sw, 128, 128) == "xla"


def test_route_rejects_unknown_mode(monkeypatch):
    monkeypatch.setenv("SEQALIGN_PALLAS", "on")
    with pytest.raises(ValueError, match="SEQALIGN_PALLAS"):
        aligners._scores_route(scoring_system_default(), False, 64, 64)


def test_route_width_bound():
    """Scores whose magnitude could approach int32 limits stay on XLA."""
    sc = ScoringConfig(1 << 20, -(1 << 20), -4, -1)
    assert scores_gpu.eligible(sc, False, 64, 64)
    assert not scores_gpu.eligible(sc, False, 4096, 4096)


def test_gpu_route_compiles_for_card(gpu_backend, monkeypatch):
    """On a GPU backend score_batch calls the kernel with interpret=False
    (here a spy stands in for the compiled kernel) and returns its
    scores in the caller's pair order."""
    calls = []

    def spy(a, b, na, nb, **kw):
        calls.append(kw["interpret"])
        return jnp.asarray(np.asarray(na) * 1000 + np.asarray(nb))

    monkeypatch.setattr(scores_gpu, "scores_gpu", spy)
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    sa = ["acgt" * k for k in (3, 1, 5, 2)]
    sb = ["ac" * k for k in (1, 4, 2, 3)]
    got = aligners.NeedlemanWunsch().score_batch(sa, sb)
    assert calls == [False]
    # symmetric config: each pair is side-swapped so b is the shorter
    want = [max(len(a), len(b)) * 1000 + min(len(a), len(b))
            for a, b in zip(sa, sb)]
    assert list(got) == want


def test_failing_kernel_raises(gpu_backend, monkeypatch):
    """No fallback hides a kernel failure: it reaches the caller."""
    def boom(*a, **k):
        raise RuntimeError("kernel failed to compile")

    monkeypatch.setattr(scores_gpu, "scores_gpu", boom)
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    rng = np.random.default_rng(0)
    sa, sb = _pairs(rng, 8, 20, 20, alpha="acgt")
    with pytest.raises(RuntimeError, match="kernel failed"):
        aligners.NeedlemanWunsch().score_batch(sa, sb)
    with pytest.raises(RuntimeError, match="kernel failed"):
        list(aligners.score_pairs_stream(
            scoring_system_sw_default(),
            ((i, a, b) for i, (a, b) in enumerate(zip(sa, sb))),
            is_sw=True))


@pytest.mark.parametrize("is_sw", [False, True], ids=["nw", "sw"])
def test_interpret_route_end_to_end(monkeypatch, is_sw):
    """score_batch and score_pairs_stream through the kernel route (in
    the interpreter) equal the XLA route, across mixed-width buckets
    merged into one length-sorted batch."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    rng = np.random.default_rng(11 + is_sw)
    sa, sb = _pairs(rng, 21, 150, 90, alpha="acgt")
    sc = scoring_system_sw_default() if is_sw else scoring_system_default()
    monkeypatch.setenv("SEQALIGN_PALLAS", "off")
    want = aligners._scores_bucketed(sc, sa, sb, is_sw=is_sw)
    monkeypatch.setenv("SEQALIGN_PALLAS", "interpret")
    before = aligners.dispatch_counts().get("scores_kernel", 0)
    got = aligners._scores_bucketed(sc, sa, sb, is_sw=is_sw)
    assert aligners.dispatch_counts()["scores_kernel"] == before + 1
    np.testing.assert_array_equal(got, want)
    streamed = np.zeros(len(sa), np.int32)
    for idx, s in aligners.score_pairs_stream(
            sc, ((i, a, b) for i, (a, b) in enumerate(zip(sa, sb))),
            is_sw=is_sw, flush_pairs=8):
        streamed[idx] = s
    np.testing.assert_array_equal(streamed, want)


# ---------------------------------------------------------------------------
# exact substitution profile (no float matmul that TF32 could round)
# ---------------------------------------------------------------------------


def test_profile_is_integer_gather():
    """dp_fill builds its substitution profile with an int32 gather: the
    traced program has no dot_general at all (a float32 product may run
    in TF32 on a GPU, exact only below 2^11)."""
    sc = scoring_system_default()
    a = np.frombuffer(b"acgtacgt" * 2, np.uint8).reshape(2, 8)
    ac, bc, subK, imK = dp.compact_inputs(sc, a, a)
    jaxpr = str(jax.make_jaxpr(
        lambda *x: dp.dp_fill(*x, np.int32(-4), np.int32(-1),
                              np.int32(sc.dp_floor(False)), is_sw=False,
                              nsg=False, neg=False, nga=False, ngb=False,
                              nmm=False, emit_dirs=True, emit_m=False,
                              emit_gab=False))(
        *(jnp.asarray(v) for v in (ac, bc, np.array([8, 5], np.int32),
                                   np.array([8, 7], np.int32), subK, imK))))
    assert "dot_general" not in jaxpr
    assert "gather" in jaxpr


@pytest.mark.parametrize("is_sw", [False, True], ids=["nw", "sw"])
def test_large_matrix_file_exact(tmp_path, monkeypatch, is_sw):
    """A custom matrix file with entries >= 2^11 scores and aligns on the
    device path exactly as on the int64 host path."""
    from seqalign_tpu.scoring.loader import load_matrix

    rows = [[5001, -2049, -4097, -3001], [-2049, 6007, -2051, -4099],
            [-4097, -2051, 7919, -2053], [-3001, -4099, -2053, 4099]]
    path = tmp_path / "big.txt"
    path.write_text("# large scores\n  A C G T\n" + "".join(
        "%s %s\n" % (c, " ".join(map(str, r))) for c, r in zip("ACGT", rows)))
    sc = ScoringConfig(0, 0, -3000, -700)
    load_matrix(str(path), sc)
    assert not dp.mm_eligible(sc)
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    rng = np.random.default_rng(12 + is_sw)
    sa, sb = _pairs(rng, 6, 30, 30, alpha="acgt")
    if is_sw:
        got = [[(h.score, h.pos_a, h.pos_b, h.result_a) for h in it]
               for it in aligners.SmithWaterman(sc).align_batch(sa, sb)]
        want = [[(h.score, h.pos_a, h.pos_b, h.result_a)
                 for h in host_dp.HostSwHits(sc, a, b)]
                for a, b in zip(sa, sb)]
        assert got == want
        best = aligners.SmithWaterman(sc).best_score_batch(sa, sb)
        assert list(best) == [max([h[0] for h in w] or [0]) for w in want]
    else:
        got = aligners.NeedlemanWunsch(sc).align_batch(sa, sb)
        want = [host_dp.nw_align(sc, a, b) for a, b in zip(sa, sb)]
        assert got == want
        assert list(aligners.NeedlemanWunsch(sc).score_batch(sa, sb)) == \
            [w.score for w in want]
        assert max(abs(w.score) for w in want) >= 1 << 11


# ---------------------------------------------------------------------------
# device memory sizing
# ---------------------------------------------------------------------------


class _FakeDevice:
    def __init__(self, limit):
        self.limit = limit

    def memory_stats(self):
        return None if self.limit is None else {"bytes_limit": self.limit}


@pytest.mark.parametrize("limit,la,lb,path,want", [
    (64 << 30, 1024, 1024, "scores", (32 << 30) // (12 << 20)),
    (64 << 30, 4096, 4096, "dirs", (32 << 30) // (14 << 24)),
    (64 << 30, 4096, 1024, "dirs_m", (32 << 30) // (20 << 24)),
    (64 << 30, 1024, 4096, "scores", (32 << 30) // (12 << 24)),
    (64 << 30, 65536, 65536, "dirs_m", 1),
    (None, 1024, 1024, "scores", (2 << 30) // (12 << 20)),
])
def test_xla_pairs_cap(monkeypatch, limit, la, lb, path, want):
    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice(limit)])
    assert aligners._xla_pairs_cap(la, lb, path) == want


def test_scores_batch_cap_by_route(monkeypatch):
    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice(64 << 30)])
    sc = scoring_system_default()
    monkeypatch.setenv("SEQALIGN_PALLAS", "off")
    cap = aligners._scores_batch_cap(sc, False, 5120, 4096)
    assert cap == aligners._xla_pairs_cap(8192, 4096, "scores") // 2
    monkeypatch.setenv("SEQALIGN_PALLAS", "interpret")
    assert aligners._scores_batch_cap(sc, False, 5120, 4096) is None


def test_align_sub_batches_fit_budget(monkeypatch):
    """align_batch splits a bucket into fills that fit the budget."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setattr(aligners, "_device_budget", lambda: 14 * 64 * 64 * 3)
    seen = []
    orig = dp.fill_batch

    def spy(sc, sa, sb, **kw):
        seen.append(len(sa))
        return orig(sc, sa, sb, **kw)

    monkeypatch.setattr(dp, "fill_batch", spy)
    rng = np.random.default_rng(5)
    sa, sb = _pairs(rng, 8, 60, 60, alpha="acgt", min_len=33)
    nw = aligners.NeedlemanWunsch()
    got = nw.align_batch(sa, sb)
    assert seen == [3, 3, 2]
    assert got == [host_dp.nw_align(nw.scoring, a, b)
                   for a, b in zip(sa, sb)]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("is_sw", [False, True], ids=["nw", "sw"])
def test_gpu_kernel_matches_xla(gpu_device, is_sw):
    """The kernel as compiled for the card equals the XLA fill on a
    ragged batch that spans several blocks and column tiles, in every
    eligible mode."""
    rng = np.random.default_rng(21 + is_sw)
    sa, sb = _pairs(rng, 300, 700, 500, alpha="acgt")
    for nsg, neg in _FLAGS:
        sc = ScoringConfig(2 if is_sw else 1, -2, -4, -1,
                           no_start_gap_penalty=nsg, no_end_gap_penalty=neg)
        ac, bc, na, nb = dp.pack_inputs_mm(sc, sa, sb)
        got = np.asarray(scores_gpu.scores_gpu(
            jnp.asarray(ac), jnp.asarray(bc), jnp.asarray(na),
            jnp.asarray(nb), is_sw=is_sw, nsg=nsg, neg=neg, match=sc.match,
            mismatch=sc.mismatch, go=sc.gap_open, ge=sc.gap_extend,
            mn=sc.dp_floor(is_sw)))
        np.testing.assert_array_equal(got, _xla_scores(sc, sa, sb, is_sw))


@pytest.mark.gpu
def test_gpu_score_batch_routes_to_kernel(gpu_device, monkeypatch):
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.delenv("SEQALIGN_PALLAS", raising=False)
    rng = np.random.default_rng(8)
    sa, sb = _pairs(rng, 200, 900, 900, alpha="acgt")
    nw = aligners.NeedlemanWunsch()
    before = aligners.dispatch_counts().get("scores_kernel", 0)
    got = nw.score_batch(sa, sb)
    assert aligners.dispatch_counts()["scores_kernel"] > before
    monkeypatch.setenv("SEQALIGN_PALLAS", "off")
    np.testing.assert_array_equal(got, nw.score_batch(sa, sb))


@pytest.mark.gpu
def test_gpu_matrix_scores_exact_above_tf32(gpu_device, monkeypatch):
    """Substitution scores >= 2^11 (beyond TF32's 11-bit mantissa) are
    exact through the XLA profile on the card."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    sc = ScoringConfig(0, 0, -3000, -700).add_mutations(
        "acgt", [[5001, -2049, -4097, -3001], [-2049, 6007, -2051, -4099],
                 [-4097, -2051, 7919, -2053], [-3001, -4099, -2053, 4099]],
        use_match_mismatch=False)
    rng = np.random.default_rng(9)
    sa, sb = _pairs(rng, 40, 200, 200, alpha="acgt")
    got = aligners.NeedlemanWunsch(sc).score_batch(sa, sb)
    assert list(got) == [host_dp.nw_align(sc, a, b).score
                         for a, b in zip(sa, sb)]
