"""Multi-device scale-out: data-parallel pair-batch sharding over a mesh.

The reference is single-process/single-thread (SURVEY.md §2.4) — distributed
execution is new capability: a 1-D ``jax.sharding.Mesh`` over all devices,
the pair batch sharded over the ``pairs`` axis with ``shard_map``, scoring
LUTs replicated (they are <=256KB), and results returned still sharded so
the host gathers only what it reads.  No collectives are needed in the
forward fill — pairwise alignment is embarrassingly parallel over pairs,
which is exactly why the mesh axis rides the batch dimension.  Each shard
runs the single-device fill the route gate picks
(``aligners._scores_route``): the Triton scores kernel or the XLA scan.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import dp
from ..scoring.config import ScoringConfig


def make_mesh(n_devices: Optional[int] = None, axis: str = "pairs") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _flags(sc: ScoringConfig, is_sw: bool) -> dict:
    return dict(
        is_sw=is_sw,
        nsg=sc.no_start_gap_penalty,
        neg=sc.no_end_gap_penalty,
        nga=sc.no_gaps_in_a,
        ngb=sc.no_gaps_in_b,
        nmm=sc.no_mismatches,
    )


def _sc_key(sc: ScoringConfig) -> tuple:
    """Value key for jit-function memoisation.  Scalars + flags +
    ``min_penalty`` (the NEG_INF sentinel input mutators change) cover the
    fields a closure bakes in; ``id(sc.luts())`` covers the swap/wildcard
    tables — every mutator (add_mutation/add_wildcard) resets ``_luts``,
    so a mutated config gets a fresh compiled-LUT tuple and a new key.
    ``_memo`` additionally keeps that tuple alive in the cache entry so
    CPython can never recycle its id for a different config while the
    cached fn lives (ADVICE round 4, medium)."""
    return (sc.match, sc.mismatch, sc.gap_open, sc.gap_extend,
            sc.min_penalty, sc.no_start_gap_penalty,
            sc.no_end_gap_penalty, sc.no_gaps_in_a, sc.no_gaps_in_b,
            sc.no_mismatches, sc.case_sensitive, sc.use_match_mismatch,
            id(sc.luts()))


# jitted shard_map fns keyed on (builder, sc value key, mesh, options).
# Without this every batch built a FRESH jax.jit(shard_map(closure)) —
# a full retrace per call (~2.1s/batch measured on the real chip for the
# streaming scorer, vs ~ms once cached).  Entries are (fn, keepalive):
# the keepalive pins the config's luts tuple so the id() in the key stays
# unambiguous for the entry's lifetime.
_FN_CACHE: dict = {}


def _memo(key, build, keep=None):
    hit = _FN_CACHE.get(key)
    if hit is None:
        if len(_FN_CACHE) > 512:  # unbounded CLI soaks: drop, don't leak
            _FN_CACHE.clear()
        hit = (build(), keep)
        _FN_CACHE[key] = hit
    return hit[0]


def make_sharded_score_fn(sc: ScoringConfig, mesh: Mesh, *, is_sw: bool,
                          axis: str = "pairs"):
    """Compile fn(a_codes, b_codes, na, nb, subK, imK) -> (B,) int32 optimal
    scores, with the pair batch sharded across the mesh and the compact
    scoring tables replicated. B must divide by the mesh size.
    Memoised on (config value, mesh) so repeat batches reuse the trace."""
    key = ("score", _sc_key(sc), mesh, is_sw, axis)
    return _memo(key, lambda: _build_sharded_score_fn(
        sc, mesh, is_sw=is_sw, axis=axis), keep=sc.luts())


def _build_sharded_score_fn(sc: ScoringConfig, mesh: Mesh, *, is_sw: bool,
                            axis: str):
    flags = _flags(sc, is_sw)
    go = np.int32(sc.gap_open)
    ge = np.int32(sc.gap_extend)
    mn = np.int32(sc.dp_floor(is_sw))

    def local_fill(a, b, na, nb, subK, imK):
        out = dp.dp_fill(
            a, b, na, nb, subK, imK, go, ge, mn,
            emit_dirs=False, emit_m=False, emit_gab=False, **flags,
        )
        if is_sw:
            return out.best
        return jnp.max(out.corner, axis=1)

    sharded = shard_map(
        local_fill,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P()),
        out_specs=P(axis),
    )
    return jax.jit(sharded)


def make_sharded_fill_fn(sc: ScoringConfig, mesh: Mesh, *, is_sw: bool,
                         emit_m: bool = False, axis: str = "pairs"):
    """Compile fn(a, b, na, nb, subK, imK) -> (dirs, mmat|None, corner, best)
    with the pair batch sharded across the mesh — the full-traceback fill
    for multi-chip batches (host traceback then walks per-pair planes).
    Memoised on (config value, mesh) so repeat batches reuse the trace."""
    key = ("fill", _sc_key(sc), mesh, is_sw, emit_m, axis)
    return _memo(key, lambda: _build_sharded_fill_fn(
        sc, mesh, is_sw=is_sw, emit_m=emit_m, axis=axis), keep=sc.luts())


def _build_sharded_fill_fn(sc: ScoringConfig, mesh: Mesh, *, is_sw: bool,
                           emit_m: bool, axis: str):
    flags = _flags(sc, is_sw)
    go = np.int32(sc.gap_open)
    ge = np.int32(sc.gap_extend)
    mn = np.int32(sc.dp_floor(is_sw))

    def local_fill(a, b, na, nb, subK, imK):
        out = dp.dp_fill(
            a, b, na, nb, subK, imK, go, ge, mn,
            emit_dirs=True, emit_m=emit_m, emit_gab=False, **flags,
        )
        mm = out.mmat if emit_m else jnp.zeros((a.shape[0],), jnp.int32)
        return out.dirs, mm, out.corner, out.best

    sharded = shard_map(
        local_fill,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
    )
    return jax.jit(sharded)


def sharded_align_batch(sc: ScoringConfig, seqs_a, seqs_b, *, is_sw: bool,
                        mesh: Optional[Mesh] = None):
    """Full alignments with the fill sharded over the mesh: NW returns a
    list of Alignment, SW a list of SwHitIterator — identical results to the
    single-device path (the traceback walks the same direction codes)."""
    from ..ops import host_dp
    from ..ops.traceback import SwHitIterator, nw_traceback

    if not is_sw and sc.sentinel_wrap_risk():
        # NW sentinel-overflow regime: int32 device fills would wrap like
        # the reference's UB crash — int64 host fills instead (see
        # aligners._route; README known deviations)
        return [host_dp.nw_align(sc, x, y) for x, y in zip(seqs_a, seqs_b)]
    mesh = mesh if mesh is not None else make_mesh()
    n = len(seqs_a)
    nd = mesh.devices.size
    a, na = dp.pad_batch(seqs_a)
    b, nb = dp.pad_batch(seqs_b)
    rem = (-n) % nd
    if rem:
        a = np.pad(a, ((0, rem), (0, 0)))
        b = np.pad(b, ((0, rem), (0, 0)))
        na = np.pad(na, (0, rem), constant_values=1)
        nb = np.pad(nb, (0, rem), constant_values=1)
    ac, bc, subK, imK = dp.compact_inputs(sc, a, b)
    fn = make_sharded_fill_fn(sc, mesh, is_sw=is_sw, emit_m=is_sw)
    dirs, mmat, corner, best = fn(
        jnp.asarray(ac), jnp.asarray(bc), jnp.asarray(na), jnp.asarray(nb),
        jnp.asarray(subK), jnp.asarray(imK),
    )
    from ..aligners import _note_dispatch

    _note_dispatch("sharded_dirs_xla")
    dirs = np.asarray(dirs)
    corner = np.asarray(corner)
    if is_sw:
        mmat = np.asarray(mmat)
        return [
            SwHitIterator(sc, seqs_a[j], seqs_b[j], int(na[j]), int(nb[j]),
                          dirs[j], mmat[j])
            for j in range(n)
        ]
    return [
        nw_traceback(seqs_a[j], seqs_b[j], na[j], nb[j], dirs[j], corner[j])
        for j in range(n)
    ]


def sharded_score_batch(sc: ScoringConfig, seqs_a, seqs_b, *, is_sw: bool,
                        mesh: Optional[Mesh] = None) -> np.ndarray:
    """Host convenience: pad + pad batch to mesh multiple, run, unpad."""
    dev, n = _score_dispatch(sc, seqs_a, seqs_b, is_sw=is_sw,
                             mesh=mesh if mesh is not None else make_mesh())
    return np.asarray(dev)[:n]


def _score_dispatch(sc: ScoringConfig, seqs_a, seqs_b, *, is_sw: bool,
                    mesh: Mesh):
    """Pack + dispatch one sharded scores batch WITHOUT fetching: returns
    (device_scores, n).  JAX dispatch is asynchronous, so callers can pack
    and dispatch the next batch while this one fills (the double-buffered
    pipeline in :func:`sharded_score_stream`)."""
    from ..aligners import _note_dispatch, _scores_route

    n = len(seqs_a)
    nd = mesh.devices.size
    rem = (-n) % nd
    if rem:
        # filler pairs pad the batch to a mesh multiple; their recorded
        # length is 1 (the kernel route needs every length >= 1; results
        # are sliced to n).  The filler rows pack as zero bytes.
        seqs_a = list(seqs_a) + [""] * rem
        seqs_b = list(seqs_b) + [""] * rem
    a, na = dp.pad_batch(seqs_a)
    b, nb = dp.pad_batch(seqs_b)
    na[n:] = 1
    nb[n:] = 1
    route = "xla"
    if min(na.min(initial=1), nb.min(initial=1)) >= 1:
        route = _scores_route(sc, is_sw, a.shape[1], b.shape[1])
    if route != "xla":
        ac, bc = dp.compact_inputs_mm(sc, a, b)
        fn = make_sharded_kernel_fn(sc, mesh, is_sw=is_sw,
                                    interpret=route == "interpret")
        scores = fn(jnp.asarray(ac), jnp.asarray(bc), jnp.asarray(na),
                    jnp.asarray(nb))
    else:
        ac, bc, subK, imK = dp.compact_inputs(sc, a, b)
        fn = make_sharded_score_fn(sc, mesh, is_sw=is_sw)
        scores = fn(jnp.asarray(ac), jnp.asarray(bc),
                    jnp.asarray(na), jnp.asarray(nb),
                    jnp.asarray(subK), jnp.asarray(imK))
    _note_dispatch("sharded_scores_" + ("xla" if route == "xla"
                                        else "kernel"))
    return scores, n


def make_sharded_kernel_fn(sc: ScoringConfig, mesh: Mesh, *, is_sw: bool,
                           interpret: bool, axis: str = "pairs"):
    """fn(a_codes, b_codes, na, nb) -> (B,) int32 scores with each shard
    of the pair batch filled by the Triton scores kernel
    (``ops.scores_gpu``; codes from ``dp.compact_inputs_mm``).  Memoised
    like :func:`make_sharded_score_fn`."""
    from ..ops.scores_gpu import scores_gpu

    key = ("kernel", _sc_key(sc), mesh, is_sw, interpret, axis)

    def build():
        def local(a, b, na, nb):
            return scores_gpu(
                a, b, na, nb, is_sw=is_sw, nsg=sc.no_start_gap_penalty,
                neg=sc.no_end_gap_penalty, match=sc.match,
                mismatch=sc.mismatch, go=sc.gap_open, ge=sc.gap_extend,
                mn=sc.dp_floor(is_sw), interpret=interpret)

        # pallas_call outputs carry no varying-mesh-axes annotation, so
        # the vma check is off (every output is per-shard anyway)
        return jax.jit(shard_map(local, mesh=mesh, in_specs=(P(axis),) * 4,
                                 out_specs=P(axis), check_vma=False))

    return _memo(key, build, keep=sc.luts())


def sharded_score_stream(sc: ScoringConfig, batches, *, is_sw: bool,
                         mesh: Optional[Mesh] = None, depth: int = 2):
    """Double-buffered streaming scorer: ``batches`` yields
    ``(seqs_a, seqs_b)`` tuples; yields one ``np.ndarray`` of scores per
    batch, in order.

    Host work (padding, alphabet compaction, shard packing) for batch
    k+1 .. k+depth-1 overlaps the device fill of batch k: dispatches are
    asynchronous and the result fetch (`np.asarray`) happens only once
    ``depth`` batches are in flight.  With host pack ~O(bytes) and the
    fill ~O(cells), the device never starves for realistic L — the basis
    of overlapping host and device work (the reference streams pairs
    strictly serially: alignment_cmdline.c:611-622)."""
    import collections

    mesh = mesh if mesh is not None else make_mesh()
    inflight = collections.deque()
    for sa, sb in batches:
        inflight.append(_score_dispatch(sc, sa, sb, is_sw=is_sw,
                                        mesh=mesh))
        if len(inflight) >= depth:
            dev, n = inflight.popleft()
            yield np.asarray(dev)[:n]
    while inflight:
        dev, n = inflight.popleft()
        yield np.asarray(dev)[:n]
