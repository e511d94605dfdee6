"""Batched anti-diagonal wavefront DP (Gotoh three-matrix) in pure JAX.

Data-parallel redesign of the reference's scalar row-major fill
(alignment.c:28-168): cells on one anti-diagonal ``d = x + y`` are
independent (the recurrence only reads ``[y-1][x-1]``, ``[y-1][x]``,
``[y][x-1]``), so the fill becomes a ``lax.scan`` over diagonals whose
per-step work is a dense ``(batch, lanes)`` vector update.

Differences from the reference by design (semantics preserved exactly):

* The reference stores three full int32 matrices and *recomputes* score
  equalities during traceback (alignment.c:244-350).  We instead emit packed
  2-bit-per-matrix **direction codes** during the fill, computed with the
  traceback's own guard/equality/priority procedure (GAP_A > GAP_B > MATCH,
  alignment.c:311-327), so host traceback is a pure O(path) pointer chase and
  provably picks the identical path in every tie case.
* Matrices live in a **skewed (diagonal-major) layout**: row ``r`` holds
  diagonal ``d = r + 2``; cell ``(y, x)`` maps to ``[x + y - 2, y]``.  This is
  the layout the wavefront writes natively (contiguous stores per step).
* Everything is batched: ``B`` pairs padded to ``(LA, LB)`` fill in one
  program; per-pair true lengths ``na/nb`` drive the last-row/last-column
  special cases (free end gaps, alignment.c:122-127,140-145; no-gaps
  exceptions, alignment.c:128-137,146-155) as lane masks.

Substitution scores are delivered to the scan precomputed: sequences are
alphabet-compacted on the host, the per-pair profile matrix
``P[x, y] = sub(a[x], b[y])`` is one int32 gather from the compact table,
and the diagonal skew is a pad+flatten+reshape shear (a pure memory copy:
padding each row of ``P^T`` to width LA+LB+2 and re-viewing rows at stride
LA+LB+1 lands ``P[d-y, y]`` at ``[y, d]``).  The scan body is then pure
int32 arithmetic with no lookups.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..scoring.config import ScoringConfig, UnknownCharPair, encode

# Persistent compile cache.  JAX reads JAX_COMPILATION_CACHE_DIR itself;
# without it, a fixed directory in the checkout, so repeated runs of the
# same bucket shapes skip compilation.  Every device path imports this
# module before its first compile.
COMPILE_CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR") or \
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")
if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)

MATCH, GAP_A, GAP_B, DIR_FAIL = 0, 1, 2, 3
# Pad substitution score for poisoned pad positions (parallel/wavefront_sp):
# pad-region MATCH values clamp <= 0, so an SW best needs no lane masks.
POISON = -(1 << 22)


class DPOutputs(NamedTuple):
    """Device results of a batched fill.

    corner: (B, 3) int32 — M/Ga/Gb at (nb, na) per pair (NW start cell).
    best:   (B,) int32 — max M over valid interior cells (SW best score).
    dirs:   (B, D, LB+1) uint8 skewed packed direction codes, or None.
    mmat:   (B, D, LB+1) int32 skewed MATCH matrix, or None.
    gamat/gbmat: skewed GAP_A/GAP_B matrices (for matrix dumps), or None.
    """

    corner: jnp.ndarray
    best: jnp.ndarray
    dirs: Optional[jnp.ndarray]
    mmat: Optional[jnp.ndarray]
    gamat: Optional[jnp.ndarray]
    gbmat: Optional[jnp.ndarray]
    bout: Optional[tuple] = None  # chunked mode: (M, Ga, Gb) at x = x_off+CA


def _max3(a, b, c):
    return jnp.maximum(a, jnp.maximum(b, c))


def _profile(codes_a, codes_b, tableK, out_dtype):
    """P[b, x, y] = tableK[codes_a[b, x], codes_b[b, y]] as one integer
    gather from the flattened compact table: exact for every int32 score
    (a float matmul formulation would round on GPUs that run f32 products
    in TF32, which keeps 11 bits)."""
    Kb = tableK.shape[1]
    idx = codes_a.astype(jnp.int32)[:, :, None] * Kb + \
        codes_b.astype(jnp.int32)[:, None, :]
    return jnp.take(tableK.reshape(-1).astype(out_dtype), idx, axis=0,
                    mode="clip")


def _shear(p):
    """Skew (B, LA, LB) profile to diagonals: out[b, y0, r] = p[b, r-y0, y0]
    (r = diagonal index d-2, y0 = y-1).  Implemented as a pure reshape trick:
    pad each row of p^T to width LA+LB+2, flatten, and re-view rows at
    stride LA+LB+1 — no gather."""
    B, LA, LB = p.shape
    pt = p.transpose(0, 2, 1)  # (B, LB, LA): pt[b, y0, x0]
    W = LA + LB + 2
    pt = jnp.pad(pt, ((0, 0), (0, 0), (0, W - LA)))
    flat = pt.reshape(B, LB * W)
    stride = W - 1  # = LA + LB + 1; LB*W >= LB*stride, so just truncate
    return flat[:, : LB * stride].reshape(B, LB, stride)


@functools.partial(
    jax.jit,
    static_argnames=(
        "is_sw",
        "nsg",
        "neg",
        "nga",
        "ngb",
        "nmm",
        "emit_dirs",
        "emit_m",
        "emit_gab",
        "chunked",
    ),
)
def dp_fill(
    a,  # (B, LA) int32 alphabet-compacted codes (see compact_inputs)
    b,  # (B, LB) int32
    na,  # (B,) int32 true lengths
    nb,  # (B,) int32
    subK,  # (Ka, Kb) int32 compact substitution table
    imK,  # (Ka, Kb) int32 0/1 compact is-match table
    gap_open,  # scalar int32 (the reference's gap_open: EXTRA cost of opening)
    gap_extend,  # scalar int32
    mn,  # scalar int32 DP floor: 0 for SW, NEG_INF sentinel for NW
    x_off=None,  # chunked: scalar int32 global-x offset of this chunk
    bcol=None,  # chunked: (bM, bGa, bGb) boundary columns (B, LB+1), lane=y
    *,
    is_sw: bool,
    nsg: bool,  # no_start_gap_penalty
    neg: bool,  # no_end_gap_penalty
    nga: bool,  # no_gaps_in_a
    ngb: bool,  # no_gaps_in_b
    nmm: bool,  # no_mismatches
    emit_dirs: bool,
    emit_m: bool,
    emit_gab: bool,
    chunked: bool = False,
) -> DPOutputs:
    """When ``chunked``: fill the sub-rectangle x in [x_off+1, x_off+LA] of a
    longer DP, taking the column x = x_off as ``bcol`` and emitting the
    column x = x_off+LA as ``bout`` (long-sequence decomposition; the
    boundary-carry analog of sequence parallelism).  Coordinate-dependent
    semantics (last-column specials, corner capture, boundary runs) use
    global x throughout."""
    B, LA = a.shape
    _, LB = b.shape
    LBp = LB + 1
    D = LA + LB - 1  # diagonals d = 2 .. LA+LB

    i32 = jnp.int32
    gap_open = jnp.asarray(gap_open, i32)
    gap_extend = jnp.asarray(gap_extend, i32)
    mn = jnp.asarray(mn, i32)
    gop = gap_open + gap_extend  # gap_open_penalty (alignment.c:38)
    na = na.astype(i32)
    nb = nb.astype(i32)
    if chunked:
        x_off = jnp.asarray(x_off, i32)
        bM, bGa, bGb = (v.astype(i32) for v in bcol)
    else:
        x_off = jnp.asarray(0, i32)

    yv = jnp.arange(LBp, dtype=i32)  # lane -> y coordinate

    # ---- skewed substitution scores: ss[r, :, y] = sub(a[x-1], b[y-1]),
    # x = (r+2) - y.  Table gather + reshape shear.
    def skewed(table):
        p = _profile(a, b, table, i32)  # (B, LA, LB)
        sh_ = _shear(p)[:, :, :D]  # (B, LB, D): [b, y-1, r]
        lanes = jnp.pad(sh_, ((0, 0), (1, 0), (0, 0)))  # lane 0 dummy
        return lanes.transpose(2, 0, 1)  # (D, B, LBp)

    ss_all = skewed(subK)
    im_all = (skewed(imK) != 0) if nmm else None

    nax = na[:, None]  # (B, 1)
    nbx = nb[:, None]

    def boundary_vals(d):
        """Row/col-0 init values for (local) diagonal d (alignment.c:51-81);
        the row-0 gap run uses the GLOBAL x coordinate."""
        if is_sw:
            z = jnp.zeros((B, 1), i32)
            return (z, z, z), (z, z, z)
        if nsg:
            gaprun = jnp.zeros((B, 1), i32)
            gaprun_y = gaprun
        else:
            gaprun = jnp.broadcast_to(
                gap_open + (x_off + d) * gap_extend, (B, 1)
            )
            gaprun_y = jnp.broadcast_to(gap_open + d * gap_extend, (B, 1))
        mncol = jnp.full((B, 1), mn, i32)
        lane0 = (mncol, mncol, gaprun)  # cell (0, x_off + d): M, Ga, Gb
        laned = (mncol, gaprun_y, mncol)  # cell (d, 0)
        return lane0, laned

    def inject(d, Mv, Gav, Gbv):
        lane0, laned = boundary_vals(d)
        at0 = yv[None, :] == 0
        Mv = jnp.where(at0, lane0[0], Mv)
        Gav = jnp.where(at0, lane0[1], Gav)
        Gbv = jnp.where(at0, lane0[2], Gbv)
        if not chunked:
            # column x=0 cells exist only in unchunked fills (chunked fills
            # take the left column from bcol substitution instead)
            atd = yv[None, :] == d
            Mv = jnp.where(atd, laned[0], Mv)
            Gav = jnp.where(atd, laned[1], Gav)
            Gbv = jnp.where(atd, laned[2], Gbv)
        return Mv, Gav, Gbv

    INT_MIN = jnp.int32(np.iinfo(np.int32).min)
    lane_is_nb = yv[None, :] == nb[:, None]  # (B, LBp), one lane per pair

    def corner_at(d, Mv, Gav, Gbv, corner):
        hit = (na + nb) == (d + x_off)  # (B,) global diagonal match
        if chunked:
            # this chunk owns the corner only if x = na lies inside it
            hit = hit & (na > x_off) & (na <= x_off + LA)
        take = lambda v: jnp.max(jnp.where(lane_is_nb, v, INT_MIN), axis=1)
        vals = jnp.stack([take(Mv), take(Gav), take(Gbv)], axis=1)
        return jnp.where(hit[:, None], vals, corner)

    # ---- init: diagonals d=0 (just cell (0,0)) and d=1.  Derive from the
    # batch inputs (zb) so the scan carry is mesh-varying under shard_map.
    zb = jnp.zeros_like(na)[:, None]  # (B, 1) int32
    mnvec = zb + mn
    mnvec = jnp.broadcast_to(mnvec, (B, LBp)) + jnp.zeros((1, LBp), i32)
    if chunked:
        # prev2 = local diag 0: only lane0 = row-0 boundary at x_off;
        # prev1 = local diag 1: only lane0 = row-0 boundary at x_off+1.
        # All other lanes belong to earlier chunks and are never read
        # unsubstituted (the x==1 lanes take bcol instead).
        l0a, _ = boundary_vals(jnp.asarray(0, i32))
        l0b, _ = boundary_vals(jnp.asarray(1, i32))
        at0 = yv[None, :] == 0
        d0 = tuple(jnp.where(at0, l0a[k], mnvec) for k in range(3))
        d1 = tuple(jnp.where(at0, l0b[k], mnvec) for k in range(3))
    else:
        zerov = jnp.where(yv[None, :] == 0, 0, mn)
        m0 = zerov + zb  # (0,0) = 0 in all three
        d0 = (m0, m0, m0)
        d1 = inject(jnp.asarray(1, i32), mnvec, mnvec, mnvec)

    corner = zb + jnp.zeros((1, 3), i32)
    if not is_sw and not chunked:
        corner = corner_at(jnp.asarray(0, i32), *d0, corner)
        corner = corner_at(jnp.asarray(1, i32), *d1, corner)
    best = jnp.zeros_like(na)
    if chunked:
        bM_sh = jnp.concatenate([jnp.full((B, 1), mn, i32), bM[:, :-1]], 1)
        bGa_sh = jnp.concatenate([jnp.full((B, 1), mn, i32), bGa[:, :-1]], 1)
        bGb_sh = jnp.concatenate([jnp.full((B, 1), mn, i32), bGb[:, :-1]], 1)
        boutM = mnvec
        boutGa = mnvec
        boutGb = mnvec

    def step(carry, xs):
        if chunked:
            (pm2, pga2, pgb2, pm1, pga1, pgb1, corner, best,
             boutM, boutGa, boutGb) = carry
        else:
            pm2, pga2, pgb2, pm1, pga1, pgb1, corner, best = carry
        if nmm:
            dvar, ss, im = xs
        else:
            dvar, ss = xs
            im = None
        x = dvar - yv  # (LBp,) LOCAL x coordinate per lane

        fill = jnp.full((B, 1), mn, i32)
        sh = lambda v: jnp.concatenate([fill, v[:, :-1]], axis=1)  # lane y-1
        m2s, ga2s, gb2s = sh(pm2), sh(pga2), sh(pgb2)
        m1s, ga1s, gb1s = sh(pm1), sh(pga1), sh(pgb1)

        if chunked:
            # lanes at local x == 1 read the carried boundary column x_off:
            # diagonal preds (y-1, x_off) = sh(bcol), left preds (y, x_off)
            # = bcol.  Up preds stay in-chunk.
            fc = (x == 1)[None, :]
            m2s = jnp.where(fc, bM_sh, m2s)
            ga2s = jnp.where(fc, bGa_sh, ga2s)
            gb2s = jnp.where(fc, bGb_sh, gb2s)
            pm1 = jnp.where(fc, bM, pm1)
            pga1 = jnp.where(fc, bGa, pga1)
            pgb1 = jnp.where(fc, bGb, pgb1)

        gx = x + x_off  # GLOBAL x coordinate per lane
        lastcol = gx[None, :] == nax  # global x == na
        lastrow = yv[None, :] == nbx  # y == nb

        # MATCH (alignment.c:89-119)
        Mv = jnp.maximum(_max3(m2s, ga2s, gb2s) + ss, mn)
        if nmm:
            Mv = jnp.where(im, Mv, mn)  # alignment.c:101-104

        # GAP_A: gap in seq_a, consumes b; reads diagonal d-1 at lane y-1
        # (alignment.c:121-137)
        ga_v = jnp.maximum(_max3(m1s + gop, ga1s + gap_extend, gb1s + gop), mn)
        if neg:
            ga_v = jnp.where(lastcol, _max3(m1s, ga1s, gb1s), ga_v)
        if nga:
            ga_v = jnp.where(lastcol, ga_v, mn)

        # GAP_B: gap in seq_b, consumes a; reads diagonal d-1 at lane y
        # (alignment.c:139-155)
        gb_v = jnp.maximum(_max3(pm1 + gop, pga1 + gop, pgb1 + gap_extend), mn)
        if neg:
            gb_v = jnp.where(lastrow, _max3(pm1, pga1, pgb1), gb_v)
        if ngb:
            gb_v = jnp.where(lastrow, gb_v, mn)

        if emit_dirs:
            # Direction codes replicate alignment_reverse_move
            # (alignment.c:244-350): guard -> equality -> priority
            # GAP_A, GAP_B, MATCH.  Coordinates in guards are GLOBAL.
            xb = jnp.broadcast_to(gx[None, :], lastcol.shape)
            yb = jnp.broadcast_to(yv[None, :], lastrow.shape)

            def pick(ga_ok, gb_ok, m_ok):
                return jnp.where(
                    ga_ok,
                    GAP_A,
                    jnp.where(gb_ok, GAP_B, jnp.where(m_ok, MATCH, DIR_FAIL)),
                ).astype(jnp.int32)

            # guards: no_gaps matrices reachable only at boundary coords
            # (alignment.c:312-314,319-321)
            def guard_a(pred_x_is0, pred_x_isn):
                if not nga:
                    return True
                return pred_x_is0 | pred_x_isn

            def guard_b(pred_y_is0, pred_y_ism):
                if not ngb:
                    return True
                return pred_y_is0 | pred_y_ism

            # current = MATCH: preds at (y-1, x-1), penalty = sub each
            dm = pick(
                guard_a(xb == 1, (xb - 1) == nax) & (ga2s + ss == Mv),
                guard_b(yb == 1, (yb - 1) == nbx) & (gb2s + ss == Mv),
                m2s + ss == Mv,
            )
            # current = GAP_A: preds at (y-1, x); end-gap rewrite when
            # x == na (alignment.c:265-268)
            if neg:
                a_open = jnp.where(lastcol, 0, gop)
                a_ext = jnp.where(lastcol, 0, gap_extend)
            else:
                a_open, a_ext = gop, gap_extend
            dga = pick(
                guard_a(xb == 0, lastcol) & (ga1s + a_ext == ga_v),
                guard_b(yb == 1, (yb - 1) == nbx) & (gb1s + a_open == ga_v),
                m1s + a_open == ga_v,
            )
            # current = GAP_B: preds at (y, x-1)
            if neg:
                b_open = jnp.where(lastrow, 0, gop)
                b_ext = jnp.where(lastrow, 0, gap_extend)
            else:
                b_open, b_ext = gop, gap_extend
            dgb = pick(
                guard_a(xb == 1, (xb - 1) == nax) & (pga1 + b_open == gb_v),
                guard_b(yb == 0, lastrow) & (pgb1 + b_ext == gb_v),
                pm1 + b_open == gb_v,
            )
            dirrow = (dm | (dga << 2) | (dgb << 4)).astype(jnp.uint8)

        Mv, ga_v, gb_v = inject(dvar, Mv, ga_v, gb_v)
        if not is_sw:
            corner = corner_at(dvar, Mv, ga_v, gb_v, corner)
        else:
            valid = (yb_ := yv[None, :]) >= 1
            valid = valid & (yb_ <= nbx) & (x[None, :] >= 1)
            valid = valid & (gx[None, :] <= nax)
            best = jnp.maximum(best, jnp.max(jnp.where(valid, Mv, mn), axis=1))

        if chunked:
            # capture the chunk's last column x_off + LA as boundary-out
            lc = (x == LA)[None, :]
            boutM = jnp.where(lc, Mv, boutM)
            boutGa = jnp.where(lc, ga_v, boutGa)
            boutGb = jnp.where(lc, gb_v, boutGb)

        ys = []
        if emit_dirs:
            ys.append(dirrow)
        if emit_m:
            ys.append(Mv)
        if emit_gab:
            ys.append(ga_v)
            ys.append(gb_v)
        if chunked:
            carry = (pm1, pga1, pgb1, Mv, ga_v, gb_v, corner, best,
                     boutM, boutGa, boutGb)
        else:
            carry = (pm1, pga1, pgb1, Mv, ga_v, gb_v, corner, best)
        return carry, tuple(ys)

    dvec = jnp.arange(2, LA + LB + 1, dtype=i32)
    xs = (dvec, ss_all, im_all) if nmm else (dvec, ss_all)
    if chunked:
        carry0 = (*d0, *d1, corner, best, boutM, boutGa, boutGb)
    else:
        carry0 = (*d0, *d1, corner, best)
    carry, ys = jax.lax.scan(step, carry0, xs)
    corner, best = carry[6], carry[7]
    bout = (carry[8], carry[9], carry[10]) if chunked else None

    ys = list(ys)
    tr = lambda v: v.transpose(1, 0, 2)  # (D, B, LBp) -> (B, D, LBp)
    dirs = tr(ys.pop(0)) if emit_dirs else None
    mmat = tr(ys.pop(0)) if emit_m else None
    gamat = tr(ys.pop(0)) if emit_gab else None
    gbmat = tr(ys.pop(0)) if emit_gab else None
    return DPOutputs(corner, best, dirs, mmat, gamat, gbmat, bout)


# ---------------------------------------------------------------------------
# Host-facing wrapper
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def pad_width(n: int) -> int:
    """Padded bucket width for a sequence side: pow2 up to 4096 (bounds
    the compiled-shape count at short L), then multiples of 1024 (the
    1-10kb regime: pow2 buckets would pad a 4097-long side to 8192 — 2x
    wasted cells; 1024-granular buckets waste <= 25%)."""
    if n <= 4096:
        return _next_pow2(n)
    return -(-n // 1024) * 1024


def seq_lens(seqs) -> np.ndarray:
    """int32 lengths of a sequence list (native list walk when
    available)."""
    from ..io import packer

    return packer.seq_lens(seqs)


def pad_batch(seqs, pad_to: Optional[int] = None,
              fold: Optional[np.ndarray] = None):
    """Encode + right-pad a list of sequences into a (B, L) uint8 array,
    optionally translating every byte through ``fold`` in the same pass.

    Rides the native packer (io/packer.py: one GIL-released translate-copy
    per row) with a vectorized numpy fallback.  Host pack is serial
    per-host work that every device fill waits on, so it must stay far
    cheaper per pair than the fill."""
    n = len(seqs)
    if n == 0:
        return (np.zeros((0, max(1, pad_to or 1)), np.uint8),
                np.zeros((0,), np.int32))
    if isinstance(seqs[0], (str, bytes, bytearray)):
        from ..io import packer

        seql = seqs if isinstance(seqs, list) else list(seqs)
        if pad_to is not None:
            # optimistic single pass at the requested width — the packer
            # rejects overlong rows, and only then do we pay a Python
            # length pass to find the true max
            try:
                return packer.pack(seql, max(1, pad_to), fold)
            except ValueError:
                pass
        lens = seq_lens(seqs)
        L = max(1, int(lens.max(initial=0)))
        if pad_to is not None:
            L = max(pad_to, L)
        out, lens = packer.pack(seql, L, fold)
        return out, lens
    # arbitrary code containers: per-element encode fallback
    enc = [encode(s) if not isinstance(s, np.ndarray)
           else np.ascontiguousarray(s, np.uint8) for s in seqs]
    blob = b"".join(e.tobytes() for e in enc)
    lens = np.fromiter((len(s) for s in seqs), np.int32, count=n)
    L = max(1, int(lens.max(initial=0)))
    if pad_to is not None:
        L = max(pad_to, L)
    out = np.zeros((n, L), dtype=np.uint8)
    # row-major boolean assignment consumes the blob in sequence order
    mask = np.arange(L, dtype=np.int32)[None, :] < lens[:, None]
    out[mask] = np.frombuffer(blob, np.uint8)
    if fold is not None:
        out = fold[out]
    return out, lens


def pack_inputs_mm(sc: ScoringConfig, seqs_a, seqs_b,
                   pad_a: Optional[int] = None,
                   pad_b: Optional[int] = None):
    """One-pass pack for the equality-scoring kernel: pad + fold each side
    in a single native translate-copy (equivalent to
    ``compact_inputs_mm(sc, *pad_batch(...))`` but without the second
    full-array gather).  Returns (ac, bc, na, nb)."""
    fold = sc.luts()[0]
    ac, na = pad_batch(seqs_a, pad_a, fold)
    bc, nb = pad_batch(seqs_b, pad_b, fold)
    return ac, bc, na, nb


def compact_inputs(sc: ScoringConfig, a_bytes: np.ndarray, b_bytes: np.ndarray,
                   kpad: int = 8, return_maps: bool = False):
    """Host-side alphabet compaction: map raw bytes to dense codes and slice
    the 256x256 LUTs down to the (Ka, Kb) tables the device actually needs.
    Tables are padded to multiples of ``kpad`` to bound recompilation.
    ``return_maps`` appends the 256-entry byte->code maps (mapa, mapb) so
    callers can re-map further byte batches — e.g. on device."""
    _, sub, ismatch, _ = sc.luts()
    ua = _present_bytes(a_bytes)
    ub = _present_bytes(b_bytes)
    Ka = -(-len(ua) // kpad) * kpad
    Kb = -(-len(ub) // kpad) * kpad
    mapa = np.zeros(256, np.int32)
    mapa[ua] = np.arange(len(ua), dtype=np.int32)
    mapb = np.zeros(256, np.int32)
    mapb[ub] = np.arange(len(ub), dtype=np.int32)
    subK = np.zeros((Ka, Kb), np.int32)
    subK[: len(ua), : len(ub)] = sub[np.ix_(ua, ub)]
    imK = np.zeros((Ka, Kb), np.int32)
    imK[: len(ua), : len(ub)] = ismatch[np.ix_(ua, ub)]
    if np.abs(subK).max(initial=0) >= (1 << 24):
        raise ValueError("substitution scores must be < 2^24 in magnitude")
    out = (mapa[a_bytes], mapb[b_bytes], subK, imK)
    return out + (mapa, mapb) if return_maps else out


def _present_bytes(arr: np.ndarray) -> np.ndarray:
    """Sorted unique byte values via a 256-slot presence scatter — one
    pass over the data instead of np.unique's sort ([0] for empty input,
    matching the old behavior)."""
    present = np.zeros(256, bool)
    present[arr.reshape(-1)] = True
    u = np.flatnonzero(present)
    return u if len(u) else np.array([0], np.int64)


def mm_eligible(sc: ScoringConfig) -> bool:
    """True when scoring is pure match/mismatch on fold-equality — no
    swaps, no wildcards (alignment_scoring.c:76-93 with
    substitution_matrix == NULL).  Then code equality from
    :func:`compact_inputs_mm` is exactly the match predicate, enabling the
    in-kernel equality-scoring fast path."""
    return bool(sc.use_match_mismatch and not sc._swap_set.any()
                and not sc._wild_set.any())


def compact_inputs_mm(sc: ScoringConfig, a_bytes: np.ndarray,
                      b_bytes: np.ndarray):
    """Shared-alphabet fold-canonical codes for the equality-scoring
    kernel: both sequences map through ONE union alphabet of case-folded
    bytes, so ``code_a == code_b`` <=> the pair scores ``match``.  (The
    regular :func:`compact_inputs` compacts a and b independently — its
    codes must never be compared across sequences.)  Only valid for
    :func:`mm_eligible` configs."""
    # The only contract consumers rely on is code_a == code_b <=> match:
    # the folded bytes THEMSELVES satisfy it, so no per-batch alphabet
    # scan or rank remapping is needed at all — one uint8 LUT gather per
    # side.  The gather rides the native fold (io/packer.py) — callers
    # that still hold the raw sequence lists should prefer
    # :func:`pack_inputs_mm`, which folds during the pack copy itself.
    from ..io import packer

    fold = sc.luts()[0]
    return packer.fold_bytes(a_bytes, fold), packer.fold_bytes(b_bytes, fold)


def check_valid_pairs(sc: ScoringConfig, seq_a, seq_b):
    """Host-side equivalent of the reference's per-cell unknown-pair abort
    (alignment_scoring.c:179-181): the DP evaluates every (char_a, char_b)
    cross pair, so checking the unique-char cross product is exact."""
    _, _, _, valid = sc.luts()
    ua = np.unique(encode(seq_a))
    ub = np.unique(encode(seq_b))
    if len(ua) and len(ub):
        bad = ~valid[np.ix_(ua, ub)]
        if bad.any():
            i, j = np.argwhere(bad)[0]
            fold = sc.luts()[0]
            raise UnknownCharPair(
                "Unknown character pair (%c,%c) and match/mismatch have not "
                "been set" % (chr(fold[ua[i]]), chr(fold[ub[j]]))
            )


def fill_batch(
    sc: ScoringConfig,
    seqs_a,
    seqs_b,
    *,
    is_sw: bool,
    emit_dirs: bool = True,
    emit_m: bool = False,
    emit_gab: bool = False,
    pad_a: Optional[int] = None,
    pad_b: Optional[int] = None,
    pow2_pad: bool = False,
    validate: bool = True,
) -> tuple[DPOutputs, np.ndarray, np.ndarray]:
    """Batched fill for python-level sequence lists.

    Returns (device outputs, na, nb). Shapes are padded (optionally to powers
    of two to bound recompilation across batches).
    """
    if validate:
        for sa, sb in zip(seqs_a, seqs_b):
            check_valid_pairs(sc, sa, sb)
    a, na = pad_batch(seqs_a, pad_a)
    b, nb = pad_batch(seqs_b, pad_b)
    if pow2_pad:
        a2, b2 = _next_pow2(a.shape[1]), _next_pow2(b.shape[1])
        a = np.pad(a, ((0, 0), (0, a2 - a.shape[1])))
        b = np.pad(b, ((0, 0), (0, b2 - b.shape[1])))
    ac, bc, subK, imK = compact_inputs(sc, a, b)
    out = dp_fill(
        jnp.asarray(ac),
        jnp.asarray(bc),
        jnp.asarray(na),
        jnp.asarray(nb),
        jnp.asarray(subK),
        jnp.asarray(imK),
        np.int32(sc.gap_open),
        np.int32(sc.gap_extend),
        np.int32(sc.dp_floor(is_sw)),
        is_sw=is_sw,
        nsg=sc.no_start_gap_penalty,
        neg=sc.no_end_gap_penalty,
        nga=sc.no_gaps_in_a,
        ngb=sc.no_gaps_in_b,
        nmm=sc.no_mismatches,
        emit_dirs=emit_dirs,
        emit_m=emit_m,
        emit_gab=emit_gab,
    )
    return out, na, nb


def fill_chunked(
    sc: ScoringConfig,
    seqs_a,
    seqs_b,
    *,
    is_sw: bool,
    chunk: int = 2048,
    emit_dirs: bool = True,
    emit_m: bool = False,
    validate: bool = True,
    extract_min=None,
):
    """Long-sequence fill: chunk seq_a into ``chunk``-column slabs, carrying
    the (M, Ga, Gb) boundary column between slabs (SURVEY §5 long-context —
    the sequence-parallel analog).  Device memory is O(chunk * LB) instead of
    O(LA * LB); direction codes / M values stream to host per chunk.

    Returns (corner (B,3), best (B,), dirs_chunks, m_chunks, na, nb) where
    dirs_chunks / m_chunks are lists of per-chunk (B, D_c, LB+1) host arrays
    in local-diagonal layout (cell (y, x): chunk (x-1)//chunk, local
    x_l = x - c*chunk, row x_l + y - 2, lane y).

    Streaming SW mode: with ``extract_min`` set (requires emit_m), M slabs
    are never fetched — each chunk's hit candidates (M >= max(extract_min,1))
    are harvested on device (``sw_extract_candidates``) and merged, and the
    4th return value is instead a per-pair list of (flats, scores) arrays.
    Host memory is then O(dirs + candidates), bounded for giant pairs.
    """
    if validate:
        for sa, sb in zip(seqs_a, seqs_b):
            check_valid_pairs(sc, sa, sb)
    a, na = pad_batch(seqs_a)
    b, nb = pad_batch(seqs_b)
    B = a.shape[0]
    LB = b.shape[1]
    CA = chunk
    nchunks = max(1, -(-a.shape[1] // CA))
    a = np.pad(a, ((0, 0), (0, nchunks * CA - a.shape[1])))
    ac, bc, subK, imK = compact_inputs(sc, a, b)
    go = np.int32(sc.gap_open)
    ge = np.int32(sc.gap_extend)
    mn = np.int32(sc.dp_floor(is_sw))

    # initial boundary = the x=0 column closed form (alignment.c:51-81)
    yv = np.arange(LB + 1, dtype=np.int64)
    if is_sw:
        bM = np.zeros((B, LB + 1), np.int32)
        bGa = bM.copy()
        bGb = bM.copy()
    else:
        runs = (
            np.zeros(LB + 1, np.int64)
            if sc.no_start_gap_penalty
            else sc.gap_open + yv * sc.gap_extend
        )
        col = np.where(yv == 0, 0, int(mn)).astype(np.int64)
        bM = np.broadcast_to(col, (B, LB + 1)).astype(np.int32).copy()
        bGb = bM.copy()
        ga = np.where(yv == 0, 0, runs).astype(np.int32)
        bGa = np.broadcast_to(ga, (B, LB + 1)).copy()

    flags = dict(
        is_sw=is_sw, nsg=sc.no_start_gap_penalty, neg=sc.no_end_gap_penalty,
        nga=sc.no_gaps_in_a, ngb=sc.no_gaps_in_b, nmm=sc.no_mismatches,
    )
    corner = np.zeros((B, 3), np.int32)
    best = np.zeros((B,), np.int32)
    dirs_chunks = []
    m_chunks = []
    cands = [([], []) for _ in range(B)] if extract_min is not None else None
    najj = jnp.asarray(na)
    nbjj = jnp.asarray(nb)
    subKj = jnp.asarray(subK)
    imKj = jnp.asarray(imK)
    bcj = jnp.asarray(bc)
    for c in range(nchunks):
        x_off = np.int32(c * CA)
        out = dp_fill(
            jnp.asarray(ac[:, c * CA:(c + 1) * CA]), bcj, najj, nbjj,
            subKj, imKj, go, ge, mn, x_off,
            (jnp.asarray(bM), jnp.asarray(bGa), jnp.asarray(bGb)),
            emit_dirs=emit_dirs, emit_m=emit_m, emit_gab=False,
            chunked=True, **flags,
        )
        if emit_dirs:
            dirs_chunks.append(np.asarray(out.dirs))
        if emit_m:
            if extract_min is not None:
                for i, (fl, sv) in enumerate(sw_extract_candidates(
                        out.mmat, na, nb, extract_min, x_off=int(x_off))):
                    cands[i][0].append(fl)
                    cands[i][1].append(sv)
            else:
                m_chunks.append(np.asarray(out.mmat))
        bM, bGa, bGb = (np.asarray(v) for v in out.bout)
        # merge corner from the owning chunk (where x = na falls)
        hit = (na > c * CA) & (na <= (c + 1) * CA)
        corner = np.where(hit[:, None], np.asarray(out.corner), corner)
        best = np.maximum(best, np.asarray(out.best))
    if extract_min is not None:
        m_chunks = [(np.concatenate(f), np.concatenate(s)) for f, s in cands]
    return corner, best, dirs_chunks, m_chunks, na, nb


# ---------------------------------------------------------------------------
# On-device SW candidate extraction (the device-side analog of the
# reference's flat-index harvest + sort, smith_waterman.c:153-161).  The
# full M matrix never leaves the device: a count pass sizes a static top_k
# fetch, and only the candidate cells (score, flat-index) transfer to host,
# where a tiny lexsort applies the exact reference ordering
# (score desc, x asc, flat asc — sort_r stable contract).
# ---------------------------------------------------------------------------


def _sw_cand_geometry(mmat, na, nb, min_s, x_off):
    """Shared mapping: skewed cell [b, r, lane] -> (y=lane, x=r+2-y+x_off);
    valid interior cells with M >= max(min_s, 1)."""
    i32 = jnp.int32
    B, D, LBp = mmat.shape
    LA = D - LBp + 2  # this slab's x extent (D = LA + LB - 1)
    yv = jnp.arange(LBp, dtype=i32)[None, None, :]
    rv = jnp.arange(D, dtype=i32)[None, :, None]
    x_local = rv + 2 - yv
    x = x_local + jnp.asarray(x_off, i32)
    thr = jnp.maximum(min_s.astype(i32), 1)[:, None, None]
    valid = (
        (yv >= 1) & (yv <= nb.astype(i32)[:, None, None])
        & (x_local >= 1) & (x_local <= LA)  # skew-pad slots hold garbage
        & (x >= 1) & (x <= na.astype(i32)[:, None, None])
        & (mmat >= thr)
    )
    return valid, x


@jax.jit
def _sw_cand_count(mmat, na, nb, min_s, x_off):
    valid, _ = _sw_cand_geometry(mmat, na, nb, min_s, x_off)
    return valid.sum(axis=(1, 2), dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("k",))
def _sw_cand_topk(mmat, na, nb, min_s, x_off, k):
    valid, x = _sw_cand_geometry(mmat, na, nb, min_s, x_off)
    B, D, LBp = mmat.shape
    key = jnp.where(valid, mmat, jnp.int32(-(2**31))).reshape(B, -1)
    vals, idx = jax.lax.top_k(key, k)
    # (y, x) return separately: composing flat = y*(na+1)+x on device would
    # wrap int32 for giant pairs (x64 is off); the host composes
    ys = (idx % LBp).astype(jnp.int32)
    xb = jnp.broadcast_to(x, mmat.shape).reshape(B, -1)
    xs = jnp.take_along_axis(xb, idx, axis=1)
    return vals, ys, xs


def sw_extract_candidates(mmat, na, nb, min_scores, x_off=0):
    """Harvest SW hit candidates (cells with M >= max(min_score, 1)) from a
    device-resident skewed M batch without fetching the matrix.

    Returns a list of per-pair ``(flats, scores)`` numpy arrays (flats
    int64 = y * (na+1) + x with global x — composed on host so giant pairs
    never wrap int32), UNSORTED (the SwHitIterator applies the reference
    tie ordering).  ``min_scores`` broadcasts to (B,).  Pass ``x_off`` for
    chunked slabs.
    """
    B, D, LBp = mmat.shape
    min_s = jnp.broadcast_to(jnp.asarray(min_scores, jnp.int32), (B,))
    naj, nbj = jnp.asarray(na), jnp.asarray(nb)
    counts = np.asarray(_sw_cand_count(mmat, naj, nbj, min_s, x_off))
    kmax = int(counts.max(initial=0))
    empty = np.zeros(0, np.int64)
    if kmax == 0:
        return [(empty, empty.astype(np.int32)) for _ in range(B)]
    k = min(D * LBp, _next_pow2(kmax))
    vals, ys, xs = _sw_cand_topk(mmat, naj, nbj, min_s, x_off, k=k)
    vals, ys, xs = np.asarray(vals), np.asarray(ys), np.asarray(xs)
    na_np = np.asarray(na).astype(np.int64)
    out = []
    for i in range(B):
        c = counts[i]
        flats = ys[i, :c].astype(np.int64) * (na_np[i] + 1) \
            + xs[i, :c].astype(np.int64)
        out.append((flats, vals[i, :c]))
    return out


def deskew(skewed: np.ndarray, na: int, nb: int, fill=0) -> np.ndarray:
    """Convert one pair's skewed (D, LB+1) array back to (nb+1, na+1) row-major
    [y][x] (for --printmatrices parity; boundary row/col must be filled by the
    caller from closed-form init values)."""
    out = np.full((nb + 1, na + 1), fill, dtype=skewed.dtype)
    for y in range(1, nb + 1):
        d0 = y + 1 - 2  # row index of x=1
        out[y, 1 : na + 1] = skewed[d0 : d0 + na, y]
    return out
