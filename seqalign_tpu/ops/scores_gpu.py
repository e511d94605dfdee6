"""Scores-only Gotoh fill for NVIDIA Hopper: Pallas through Triton.

The XLA wavefront (``ops/dp.py``) is a ``lax.scan`` over anti-diagonals
that keeps its (M, Ga, Gb) carry planes in device memory between steps,
about 100 bytes of traffic per cell.  This kernel keeps the DP state in
registers instead:

* **One lane is one pair.**  A program owns ``32 * NUM_WARPS`` pairs; the
  caller sorts pairs by length so a block is homogeneous.
* The program walks ``b`` in column tiles of ``T`` (static, unrolled).  For
  each tile a ``fori_loop`` runs over the rows of ``a`` up to the block's
  longest ``na``; the tile's per-column state (H and Gb of the row above)
  is the loop carry, so it lives in registers.
* Between tiles, the left boundary column (H and Ga at ``y = j0``) goes
  through a per-block ``(LA + 1, lanes)`` int32 buffer: 16 bytes per row
  per tile per lane, about ``16 / T`` bytes per cell.

Recurrence (alignment.c:89-167, the same equations as ``dp.dp_fill``) with
``H = max(M, Ga, Gb)``.  Because ``gap_open <= 0`` (``gop = gap_open +
ext <= ext``), ``max(M + gop, Ga + ext, Gb + gop) == max(H + gop, Ga +
ext) == max(max(M, Gb) + gop, Ga + ext)``: only H, Ga (running along the
row) and Gb (per column) are carried, and the running Ga chain costs one
add and one max per column.  The floors drop out: in NW every interior
value is within ``(la + lb)`` steps of 0, so the NEG_INF floor never
binds; in SW only M keeps its 0 floor, because with ``ext <= 0`` an
unfloored Ga or Gb only differs from the floored one where both are <= 0,
below M >= 0 in every max that reads them.  All arithmetic is int32, and
:func:`eligible` admits only configurations where no term can wrap, so
every score equals the XLA fill's exactly.

Scope: equality scoring (``dp.mm_eligible``), NW corner score and SW best
score, default flags plus free start/end gaps.  Everything else stays on
``dp.fill_batch``; the route is decided in ``aligners._scores_route``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..scoring.config import ScoringConfig
from . import dp

# Measured on an H100 at B=4096, L=1024 (PERF.md): T=32 beat 16, 48 and 64
# overall; 1 and 4 warps per program ran level; two or four pairs per
# thread ran 2-10x slower, and Triton's num_stages changed nothing.
T = 32  # column-tile width: registers per lane grow with T
NUM_WARPS = 1
_BIG = 1 << 30  # SW pad-column score: max(H - _BIG, 0) == 0 for H < 2^30


def eligible(sc: ScoringConfig, is_sw: bool, la: int, lb: int) -> bool:
    """True when the kernel computes exactly what ``dp.fill_batch`` does
    for this configuration and padded shape."""
    if not dp.mm_eligible(sc):
        return False
    if sc.no_gaps_in_a or sc.no_gaps_in_b or sc.no_mismatches:
        return False
    if sc.gap_open > 0 or sc.gap_extend > 0:  # the fold and floor proofs
        return False
    tmn, _ = sc.true_penalty_bounds()
    if not is_sw and tmn < min(0, sc.min_penalty):
        # a step below the frozen sentinel headroom: NEG_INF + step would
        # wrap, and the folded terms would not wrap the same way
        return False
    step = max(abs(sc.match), abs(sc.mismatch),
               abs(sc.gap_open) + abs(sc.gap_extend))
    # every value stays within (la + lb) steps of 0, far from int32 limits
    return step * (la + lb + 2) < (1 << 29)


def _kernel(a_ref, b_ref, na_ref, nb_ref, out_ref, sh_ref, se_ref, *,
            is_sw, nsg, neg, match, mismatch, go, ge, mn, barrier):
    i32 = jnp.int32
    na = na_ref[...]
    nb = nb_ref[...]
    rows = jnp.max(na)
    ntiles = (jnp.max(nb) + T - 1) // T
    gop = go + ge
    zero = jnp.zeros_like(na)

    def edge(n):
        """H on the x = 0 column / y = 0 row at distance n >= 1
        (alignment.c:51-81): max(NEG_INF, gap run)."""
        if is_sw:
            return zero
        run = 0 if nsg else go + n * ge
        return zero + jnp.maximum(mn, run)

    def tile(k, acc):
        j0 = k * T
        bt, mt, mm, isnb, hup, f = [], [], [], [], [], []
        for t in range(T):
            y = j0 + t + 1
            bt.append(b_ref[j0 + t, :])
            isnb.append(nb == y)
            if is_sw:
                # columns past nb score -BIG, so their M is 0 and the best
                # needs no column mask
                mt.append(jnp.where(y <= nb, match, -_BIG))
                mm.append(jnp.where(y <= nb, mismatch, -_BIG))
            else:
                mt.append(match)
                mm.append(mismatch)
            hup.append(edge(y))  # H(y, 0)
            f.append(zero + (0 if is_sw else mn))  # Gb(y, 0)
        hd0 = jnp.where(j0 == 0, zero, edge(j0))  # H(j0, 0)
        has_nb = (nb > j0) & (nb <= j0 + T)

        def load(x):
            return a_ref[x - 1, :], sh_ref[x, :], se_ref[x, :]

        def row(x, carry):
            hd, hup, f, acc, (av, hl, el) = carry
            # the next row's loads go out before this row's arithmetic
            # (the row loop is latency-bound; this measured 1.3x)
            nxt = load(jnp.minimum(x + 1, rows))
            first = j0 == 0
            hl = jnp.where(first, edge(x), hl)  # H(j0, x)
            el = jnp.where(first, zero + (0 if is_sw else mn), el)  # Ga(j0, x)
            lastcol = na == x
            # c: max(M, Gb) + gop of the column to the left; the running
            # Ga chain is then one add and one max per column
            diag, lh, le, c = hd, hl, el, hl + gop
            hup2, f2 = [], []
            sel = zero
            for t in range(T):
                s = jnp.where(av == bt[t], mt[t], mm[t])
                m = diag + s
                if is_sw:
                    m = jnp.maximum(m, 0)
                g = jnp.maximum(hup[t] + gop, f[t] + ge)
                if neg:
                    g = jnp.where(isnb[t], hup[t], g)
                e = jnp.maximum(le + ge, c)
                if neg:
                    e = jnp.where(lastcol, lh, e)
                mg = jnp.maximum(m, g)
                h = jnp.maximum(mg, e)
                c = mg + gop
                diag = hup[t]
                hup2.append(h)
                f2.append(g)
                lh, le = h, e
                if is_sw:
                    sel = jnp.maximum(sel, m)
                else:
                    sel = jnp.where(isnb[t], h, sel)
            sh_ref[x, :] = lh
            se_ref[x, :] = le
            if is_sw:
                acc = jnp.maximum(acc, jnp.where(x <= na, sel, 0))
            else:
                acc = jnp.where(lastcol & has_nb, sel, acc)
            return hl, hup2, f2, acc, nxt

        acc = jax.lax.fori_loop(1, rows + 1, row,
                                (hd0, hup, f, acc, load(1)))[3]
        if barrier:
            # the next tile reads the boundary column this one stored
            pl_triton.debug_barrier()
        return acc

    acc0 = zero if is_sw else zero + mn
    out_ref[...] = jax.lax.fori_loop(0, ntiles, tile, acc0).astype(i32)


@functools.partial(jax.jit, static_argnames=(
    "is_sw", "nsg", "neg", "match", "mismatch", "go", "ge", "mn",
    "interpret"))
def scores_gpu(a, b, na, nb, *, is_sw: bool, nsg: bool, neg: bool,
               match: int, mismatch: int, go: int, ge: int, mn: int,
               interpret: bool = False):
    """Optimal scores of B pairs: NW corner max, or SW best.

    ``a`` (B, LA) and ``b`` (B, LB) hold equality-comparable codes
    (``dp.pack_inputs_mm``); ``na``/``nb`` (B,) are the true lengths, all
    >= 1.  Returns (B,) int32.  ``interpret`` runs the Pallas interpreter
    (tests on the CPU); otherwise the kernel compiles for the GPU."""
    B, LA = a.shape
    LB = b.shape[1]
    blk = 32 * NUM_WARPS
    Bp = -(-B // blk) * blk
    LBp = -(-LB // T) * T
    pad = ((0, Bp - B), (0, 0))
    aT = jnp.pad(a.astype(jnp.int32), pad).T
    bT = jnp.pad(b.astype(jnp.int32), ((0, Bp - B), (0, LBp - LB))).T
    nap = jnp.pad(na.astype(jnp.int32), (0, Bp - B), constant_values=1)
    nbp = jnp.pad(nb.astype(jnp.int32), (0, Bp - B), constant_values=1)
    kern = functools.partial(
        _kernel, is_sw=is_sw, nsg=nsg, neg=neg, match=match,
        mismatch=mismatch, go=go, ge=ge, mn=mn, barrier=not interpret)
    lanes = lambda i: (0, i)
    out, _, _ = pl.pallas_call(
        kern,
        grid=(Bp // blk,),
        in_specs=[
            pl.BlockSpec((LA, blk), lanes),
            pl.BlockSpec((LBp, blk), lanes),
            pl.BlockSpec((blk,), lambda i: (i,)),
            pl.BlockSpec((blk,), lambda i: (i,)),
        ],
        out_specs=[
            pl.BlockSpec((blk,), lambda i: (i,)),
            pl.BlockSpec((LA + 1, blk), lanes),
            pl.BlockSpec((LA + 1, blk), lanes),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((Bp,), jnp.int32),
            jax.ShapeDtypeStruct((LA + 1, Bp), jnp.int32),  # H(j0, x)
            jax.ShapeDtypeStruct((LA + 1, Bp), jnp.int32),  # Ga(j0, x)
        ],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="nw_sw_scores_fill",
    )(aT, bT, nap, nbp)
    return out[:B]
