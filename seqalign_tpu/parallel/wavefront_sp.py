"""Sequence-parallel wavefront: one (giant) pair's DP lanes sharded across
the device mesh, with per-diagonal halo exchange between devices.

This is the context-parallel analog from SURVEY §2.4/§5: the anti-diagonal
state vectors (H, E, F over b-positions) are split across an axis of the
mesh; each diagonal step every device computes its lane slice and sends its
LAST lane to the right neighbor via ``jax.lax.ppermute`` — the one-lane halo
the y-1 shift needs.  Row-0 boundary values are injected on the device that
owns lane 0; the NW corner is recovered with a cross-device ``pmax``.

Scores-only, default flags (the H/E/F reduction of alignment.c:89-167 — see
ops/scores_gpu.py for its exactness argument).  Complements the pair-batch
data parallelism in ``engine.py``: use THIS when single pairs are too long
for one chip's memory/compute, use pair-batch sharding for throughput.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..ops.dp import POISON, _profile, _shear, compact_inputs, pad_batch
from ..scoring.config import ScoringConfig


def _local_fill(ss, na, nb, go, ge, mn, *, axis, LBshard, D, is_sw):
    """Per-device body under shard_map: lanes = this device's slice of the
    global y-1 axis; halo = one lane to the right neighbor per diagonal."""
    i32 = jnp.int32
    nd = jax.lax.psum(1, axis)
    idx = jax.lax.axis_index(axis)
    B = ss.shape[1]
    gop = go + ge

    # global y0 coordinate of each local lane
    y0 = jax.lax.broadcasted_iota(i32, (B, LBshard), 1) + idx * LBshard
    lane0 = y0 == 0

    def halo_shift(v, fillv):
        """sh over the GLOBAL lane axis: receive the left neighbor's last
        lane over ICI, then shift locally; the global lane 0 gets fillv."""
        edge = v[:, -1:]
        recv = jax.lax.ppermute(
            edge, axis, [(i, (i + 1) % nd) for i in range(nd)]
        )
        s = jnp.concatenate([recv, v[:, :-1]], axis=1)
        return jnp.where(lane0, fillv, s)

    # derive from the sharded input so scan carries are mesh-varying
    zero = jnp.zeros_like(ss[0])
    mnv = zero + mn

    if is_sw:
        h = e = f = hs = es = hs2 = zero
        run = lambda d: jnp.int32(0)
    else:
        run = lambda d: go + d * ge
        h = jnp.where(lane0, gop, mn)  # diag 1: cell (1, 0)
        f = mnv
        sh1 = jnp.where(y0 == 1, gop, mn)
        hs = jnp.where(lane0, gop, sh1)
        es = jnp.where(lane0, mn, sh1)
        hs2 = jnp.where(lane0, 0, mn)

    INT_MIN = jnp.int32(np.iinfo(np.int32).min)
    accv = zero + (0 if is_sw else INT_MIN)
    lane_nb = y0 == (nb[:, None] - 1)

    def step(carry, xs):
        h, hs, es, f, hs2, accv = carry
        d, ss_row = xs
        e_new = jnp.maximum(jnp.maximum(hs + gop, es + ge), mn)
        f_new = jnp.maximum(jnp.maximum(h + gop, f + ge), mn)
        m_arg = hs2 + ss_row
        h_new = jnp.maximum(m_arg, jnp.maximum(e_new, f_new))

        # x == 0 column at global lane d-1
        at0 = y0 == (d - 1)
        rv = run(d)
        h_new = jnp.where(at0, rv, h_new)
        e_new = jnp.where(at0, rv, e_new)
        f_new = jnp.where(at0, 0 if is_sw else mn, f_new)

        if is_sw:
            accv = jnp.maximum(accv, jnp.maximum(m_arg, 0))
        else:
            hit = ((na + nb) == d)[:, None]
            accv = jnp.where(lane_nb & hit, h_new, accv)

        sh_h = halo_shift(h_new, rv)
        sh_e = halo_shift(e_new, 0 if is_sw else mn)
        return (h_new, sh_h, sh_e, f_new, hs, accv), None

    dvec = jnp.arange(2, D + 2, dtype=i32)
    carry, _ = jax.lax.scan(step, (h, hs, es, f, hs2, accv), (dvec, ss))
    accv = carry[5]
    local_best = jnp.max(accv, axis=1)  # (B,)
    return jax.lax.pmax(local_best, axis)


def sp_scores(sc: ScoringConfig, seqs_a, seqs_b, mesh: Mesh,
              axis: str = "seq", *, is_sw: bool = False) -> np.ndarray:
    """Optimal scores with the DP lane axis sharded over ``mesh[axis]``.
    Default-flags configs with gap_open <= 0 (like the GPU scores kernel);
    anything else routes through the batch engine (identical results,
    pair-batch sharding instead of lane sharding)."""
    if sc.gap_open > 0 or (
        sc.no_start_gap_penalty or sc.no_end_gap_penalty or sc.no_gaps_in_a
        or sc.no_gaps_in_b or sc.no_mismatches
    ) or (not is_sw and sc.sentinel_wrap_risk()):
        from ..aligners import _scores_auto

        return np.asarray(_scores_auto(sc, seqs_a, seqs_b, is_sw=is_sw))
    nd = mesh.shape[axis]
    a, na = pad_batch(seqs_a)
    b, nb = pad_batch(seqs_b)
    LB = -(-b.shape[1] // nd) * nd
    b = np.pad(b, ((0, 0), (0, LB - b.shape[1])))
    ac, bc, subK, imK = compact_inputs(sc, a, b)
    del imK
    LA = ac.shape[1]
    D = LA + LB  # diagonals 2..LA+LB+1 padded by one for the shear slice
    go = np.int32(sc.gap_open)
    ge = np.int32(sc.gap_extend)
    mn = np.int32(sc.dp_floor(is_sw))

    @jax.jit
    def prep(ac, bc, na, nb, subK):
        # poison pad positions (dp.POISON) so pad-region MATCH
        # values clamp <= 0 and the SW best needs no validity masks
        Ka, Kb = subK.shape
        ac = jnp.where(
            jax.lax.broadcasted_iota(jnp.int32, ac.shape, 1) < na[:, None],
            ac, Ka,
        )
        bc = jnp.where(
            jax.lax.broadcasted_iota(jnp.int32, bc.shape, 1) < nb[:, None],
            bc, Kb,
        )
        subK = jnp.pad(subK, ((0, 1), (0, 1)), constant_values=POISON)
        p = _profile(ac, bc, subK, jnp.int32)
        sh = _shear(p)[:, :, :D]  # (B, LB, D): [b, y0, r]
        return sh.transpose(2, 0, 1)  # (D, B, LB): lane axis last

    ss = prep(jnp.asarray(ac), jnp.asarray(bc), jnp.asarray(na),
              jnp.asarray(nb), jnp.asarray(subK))

    fn = shard_map(
        lambda ss, na_, nb_: _local_fill(
            ss, na_, nb_, go, ge, mn, axis=axis, LBshard=LB // nd, D=D,
            is_sw=is_sw,
        ),
        mesh=mesh,
        in_specs=(P(None, None, axis), P(), P()),
        out_specs=P(),
    )
    scores = np.asarray(jax.jit(fn)(ss, jnp.asarray(na), jnp.asarray(nb)))
    return scores


def _sp_chunk_dirs(A_local, blv, na, nb, CA, LB, go, ge, mn, mt, mm,
                   x_off, bcol, *, axis, LBshard, chunked_in):
    """Per-device body: one a-chunk of a single giant pair's dirs fill,
    lanes (the y axis incl. the dummy y=0 row, dp.dp_fill's layout)
    sharded over ``axis`` with one-lane ppermute halos.  Emits this
    device's slice of the packed direction codes, the chunk's boundary-out
    column, and the (pmax-reduced) NW corner.  Semantics mirror
    dp.dp_fill(chunked=True, emit_dirs=True) with default flags and
    in-scan equality scoring (mm_eligible configs), so the emitted slabs
    feed ops.traceback.ChunkedDirs / nw_traceback unchanged."""
    i32 = jnp.int32
    nd = jax.lax.psum(1, axis)
    idx = jax.lax.axis_index(axis)
    gop = go + ge
    D = CA + LB - 1  # local diagonals 2 .. CA+LB

    yv = jax.lax.broadcasted_iota(i32, (LBshard,), 0) + idx * LBshard
    lane0 = yv == 0

    def halo_shift(v, fillv):
        edge = v[-1:]
        recv = jax.lax.ppermute(
            edge, axis, [(i, (i + 1) % nd) for i in range(nd)])
        s = jnp.concatenate([recv, v[:-1]], axis=0)
        return jnp.where(lane0, fillv, s)

    INT_MIN = jnp.int32(np.iinfo(np.int32).min)

    def pv(x):
        # scan carries must be mesh-varying under shard_map: mark the
        # constant-built initials as varying over the lane axis (no-op on
        # values that already derive from a sharded input / axis_index)
        try:
            if axis in getattr(jax.typeof(x), "vma", ()):
                return x
            return jax.lax.pcast(x, axis, to="varying")
        except AttributeError:  # older jax: derive from a sharded input
            return x + (blv[:1] * 0 if x.ndim else blv[0] * 0)

    mnv = pv(jnp.full((LBshard,), mn, i32))
    bM, bGa, bGb = bcol
    bM_sh = halo_shift(bM, mn)
    bGa_sh = halo_shift(bGa, mn)
    bGb_sh = halo_shift(bGb, mn)

    def row0(d):
        """Cell (0, x_off + d): M = Ga = mn, Gb = global row-0 gap run."""
        return (mn, mn, go + (x_off + d) * ge)

    # init: local diagonals 0 and 1 (only lane 0 = row-0 boundary exists;
    # other lanes belong to earlier chunks and are replaced via bcol)
    l0 = row0(jnp.asarray(0, i32))
    l1 = row0(jnp.asarray(1, i32))
    if chunked_in:
        pm2 = jnp.where(lane0, l0[0], mnv)
        pga2 = jnp.where(lane0, l0[1], mnv)
        pgb2 = jnp.where(lane0, l0[2], mnv)
        pm1 = jnp.where(lane0, l1[0], mnv)
        pga1 = jnp.where(lane0, l1[1], mnv)
        pgb1 = jnp.where(lane0, l1[2], mnv)
    else:
        # unchunked first chunk: (0,0) corner = 0 in all three; diagonal 1
        # = cell (1, 0) column boundary, injected via the bcol input which
        # the caller builds from the closed form, so same as chunked_in
        pm2 = jnp.where(lane0, 0, mnv)
        pga2 = jnp.where(lane0, 0, mnv)
        pgb2 = jnp.where(lane0, 0, mnv)
        pm1 = jnp.where(lane0, l1[0], mnv)
        pga1 = jnp.where(lane0, l1[1], mnv)
        pgb1 = jnp.where(lane0, l1[2], mnv)

    # rolling a-codes: av(d)[y] = A_local[d - y - 1] (pads PADA)
    # rolling a-code conveyor: av(d)[y] = A_local[d - y - 1]; the dummy
    # lane 0 carries the NEXT code so the per-diagonal shift delivers it
    # to lane 1 (av(2) = [A[1], A[0], PADA, ...])
    Apad = jnp.concatenate([
        A_local, jnp.full((D + 2,), PADA_SP, i32)])
    av0 = pv(jnp.where(yv == 0, Apad[1],
                       jnp.where(yv == 1, Apad[0], PADA_SP)))

    corner = pv(jnp.full((3,), INT_MIN, i32))
    boutM = mnv
    boutGa = mnv
    boutGb = mnv
    lane_is_nb = yv == nb

    def step(carry, dvar):
        (pm2, pga2, pgb2, pm1, pga1, pgb1, av, corner,
         boutM, boutGa, boutGb) = carry
        x = dvar - yv  # local x per lane

        m2s = halo_shift(pm2, mn)
        ga2s = halo_shift(pga2, mn)
        gb2s = halo_shift(pgb2, mn)
        m1s = halo_shift(pm1, mn)
        ga1s = halo_shift(pga1, mn)
        gb1s = halo_shift(pgb1, mn)

        fc = x == 1  # lanes reading the carried boundary column x_off
        m2s = jnp.where(fc, bM_sh, m2s)
        ga2s = jnp.where(fc, bGa_sh, ga2s)
        gb2s = jnp.where(fc, bGb_sh, gb2s)
        pm1c = jnp.where(fc, bM, pm1)
        pga1c = jnp.where(fc, bGa, pga1)
        pgb1c = jnp.where(fc, bGb, pgb1)

        ss = jnp.where(av == blv, mt, mm)
        Mv = jnp.maximum(jnp.maximum(jnp.maximum(m2s, ga2s), gb2s) + ss,
                         mn)
        ga_v = jnp.maximum(jnp.maximum(
            jnp.maximum(m1s + gop, ga1s + ge), gb1s + gop), mn)
        gb_v = jnp.maximum(jnp.maximum(
            jnp.maximum(pm1c + gop, pga1c + gop), pgb1c + ge), mn)

        def pick(ga_ok, gb_ok, m_ok):
            return jnp.where(ga_ok, 1,
                             jnp.where(gb_ok, 2,
                                       jnp.where(m_ok, 0, 3))).astype(i32)

        dm = pick(ga2s + ss == Mv, gb2s + ss == Mv, m2s + ss == Mv)
        dga = pick(ga1s + ge == ga_v, gb1s + gop == ga_v,
                   m1s + gop == ga_v)
        dgb = pick(pga1c + gop == gb_v, pgb1c + ge == gb_v,
                   pm1c + gop == gb_v)
        dirrow = (dm | (dga << 2) | (dgb << 4)).astype(jnp.uint8)

        # inject the row-0 boundary at the dummy lane 0
        r0 = row0(dvar)
        Mv = jnp.where(lane0, r0[0], Mv)
        ga_v = jnp.where(lane0, r0[1], ga_v)
        gb_v = jnp.where(lane0, r0[2], gb_v)

        hit = ((na + nb) == (dvar + x_off)) & (na > x_off) \
            & (na <= x_off + CA)
        take = lambda v: jnp.max(jnp.where(lane_is_nb, v, INT_MIN))
        vals = jnp.stack([take(Mv), take(ga_v), take(gb_v)])
        corner = jnp.where(hit, vals, corner)

        lc = x == CA
        boutM = jnp.where(lc, Mv, boutM)
        boutGa = jnp.where(lc, ga_v, boutGa)
        boutGb = jnp.where(lc, gb_v, boutGb)

        av = halo_shift(av, Apad[dvar])
        return (pm1, pga1, pgb1, Mv, ga_v, gb_v, av, corner,
                boutM, boutGa, boutGb), dirrow

    dvec = jnp.arange(2, D + 2, dtype=i32)
    carry0 = (pm2, pga2, pgb2, pm1, pga1, pgb1, av0, corner,
              boutM, boutGa, boutGb)
    carry, dirs = jax.lax.scan(step, carry0, dvec)
    corner = jax.lax.pmax(carry[7], axis)
    return dirs, (carry[8], carry[9], carry[10]), corner


PADA_SP = 1 << 20  # pad code for the rolling a window (never equals b)


def sp_align_nw(sc: ScoringConfig, seq_a: str, seq_b: str, mesh: Mesh,
                axis: str = "seq", chunk: int = 2048):
    """Global alignment of ONE giant pair with the DP lane axis sharded
    over the mesh: each device fills its y-slice with ppermute halo
    exchange and stores its slice of the packed direction codes; the host
    stitches the traceback across slices — the sequence-parallel analog
    of context parallelism (SURVEY §5 long-context row, alignment.c:181-190
    is the O(n*m) memory bound this breaks across chips).

    Equality (``mm_eligible``) scoring with default flags; other configs
    fall back to the single-device ``align_long``.  Bit-identical to
    ``NeedlemanWunsch.align_long`` (same ChunkedDirs slab contract)."""
    from ..aligners import NeedlemanWunsch
    from ..ops import dp as _dp
    from ..ops.traceback import ChunkedDirs, nw_traceback

    if (not _dp.mm_eligible(sc) or sc.gap_open > 0
            or sc.no_start_gap_penalty or sc.no_end_gap_penalty
            or sc.no_gaps_in_a or sc.no_gaps_in_b or sc.no_mismatches
            or sc.sentinel_wrap_risk()):
        return NeedlemanWunsch(sc).align_long(seq_a, seq_b, chunk=chunk)

    nd = mesh.shape[axis]
    a, na_arr = pad_batch([seq_a])
    b, nb_arr = pad_batch([seq_b])
    na, nb = int(na_arr[0]), int(nb_arr[0])
    ac, bc = _dp.compact_inputs_mm(sc, a, b)
    CA = min(chunk, -(-na // 8) * 8)
    nchunks = max(1, -(-na // CA))
    # lane axis = y in [0, LB] (dummy 0 row) padded to a multiple of nd
    LB = nb
    LBp = -(-(LB + 1) // nd) * nd
    blv_full = np.full(LBp, PADA_SP + 1, np.int64)  # never equals a-codes
    blv_full[1: nb + 1] = np.asarray(bc[0][:nb])
    blv = jnp.asarray(blv_full.astype(np.int32))

    go = np.int32(sc.gap_open)
    ge = np.int32(sc.gap_extend)
    mn = np.int32(sc.dp_floor(False))
    mt = np.int32(sc.match)
    mm = np.int32(sc.mismatch)

    # initial boundary column x=0 (closed form, alignment.c:51-81)
    yvals = np.arange(LBp, dtype=np.int64)
    runy = sc.gap_open + yvals * sc.gap_extend
    bM0 = np.where(yvals == 0, 0, mn).astype(np.int32)
    bGa0 = np.where(yvals == 0, 0, runy).astype(np.int32)
    bGb0 = np.where(yvals == 0, 0, mn).astype(np.int32)

    def local(A_loc, blv_, x_off, bM, bGa, bGb):
        return _sp_chunk_dirs(
            A_loc, blv_, np.int32(na), np.int32(nb), CA, LBp - 1,
            go, ge, mn, mt, mm, x_off, (bM, bGa, bGb),
            axis=axis, LBshard=LBp // nd, chunked_in=True)

    # x_off is traced so every chunk reuses ONE compiled program
    fn = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(axis), P(), P(axis), P(axis), P(axis)),
        out_specs=(P(None, axis), (P(axis), P(axis), P(axis)), P()),
    ))

    acodes = np.asarray(ac[0])
    bcol = (jnp.asarray(bM0), jnp.asarray(bGa0), jnp.asarray(bGb0))
    slabs = []
    corner = np.full(3, np.iinfo(np.int32).min, np.int64)
    for c in range(nchunks):
        A_loc = np.full(CA, PADA_SP, np.int32)
        seg = np.asarray(acodes[c * CA: c * CA + CA])
        valid = np.arange(len(seg)) < (na - c * CA)
        A_loc[: len(seg)] = np.where(valid, seg, PADA_SP)
        dirs, bout, corner_c = fn(jnp.asarray(A_loc), blv,
                                  jnp.asarray(c * CA, jnp.int32), *bcol)
        # slab: (D_c, LB+1) with lane = y (dummy col 0), the
        # dp.fill_chunked contract consumed by ChunkedDirs
        slabs.append(np.asarray(dirs)[:, : LB + 1])
        corner = np.maximum(corner, np.asarray(corner_c))
        bcol = bout
    aln = nw_traceback(seq_a, seq_b, na, nb, ChunkedDirs(slabs, CA),
                       corner.astype(np.int64))
    return aln
