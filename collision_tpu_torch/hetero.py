"""Two-level radius bucketing: mixed-radii scenes (collision_tpu/hetero.py).

The uniform engines size their grid by 2*r_max, so a few large spheres
collapse it for everybody. This engine parks the ``nb`` largest spheres
(the big set B) out of the small-small pass: radius -inf gives them an
empty box ([+inf, -inf], empty at any coordinate magnitude) that fails
every strict test while the sphere keeps its slot, so n and the scene
bounds stay as they are, and the S-S engine runs at the small class's
r_max. The three pair classes are enumerated apart and disjointly:

  S-S: the parked scene through the column engine (``engine="column"``:
       the dual count, the masks and the sparse emission) or the slab
       engine (``engine="slab"``: the dual dispatch at two rows);
  B-S: kernels/bigpass.py, the big table against the parked stream (the
       parked bigs on the stream side are empty, so no B-B pair leaks in);
  B-B: one [nb, nb] strict-overlap mask with an i < j dedup.

Pairs come in that order (S-S, then the slab engine's residual pairs,
B-S, B-B), each class in the JAX package's order, so the buffers are
bit-identical to its. Totals are exact; ``ok`` reports every static-knob
violation.
"""

import numpy as np
import torch

from . import tracing
from .columns import CHUNK, default_column_config, plan_columns
from .fill import column_fill_from_plan, slab_fill_from_plan
from .kernels import bigpass, compact
from .kernels.slab_sweep import slab_count_dual
from .kernels.sweep import sweep_count_dual
from .slabs import NO_PAIR, default_slab_config, plan_slabs

#: Big-set size cap: the spheres parked out of the small-small pass.
DEFAULT_NB = 1024


def default_nb(n):
    """Big-set size for an n-sphere scene (always < n, chunk-aligned)."""
    nb = min(DEFAULT_NB, max(CHUNK, n // 8))
    return max(CHUNK, (nb // CHUNK) * CHUNK) if n > CHUNK else CHUNK


def _big_indices(radii, nb):
    """The ids of the ``nb`` largest radii, largest first and the lower id
    first among equal radii, as ``jax.lax.top_k`` orders them (a stable
    descending sort; ``torch.topk`` orders ties otherwise)."""
    return torch.sort(radii, descending=True, stable=True).indices[:nb]


def _bigs_table(coords, radii, bidx, nb):
    """(rows f32[nb/64, 64, 8], zlo f32[nb/64], zhi f32[nb/64]): the big
    spheres' test rows (xlo ylo zlo xhi yhi zhi id-bits +inf; rows of
    negative radius all +inf but the ids) and each chunk's z extent (min
    zlo / max zhi over its live members), the big pass's input.

    Chunk 0 holds the 64 largest radii in ``bidx`` order (the giants,
    tested against every row); the rest are sorted by z with a stable
    sort, so each stream row meets a short run of chunks.
    """
    c = coords[bidx]
    r = radii[bidx]
    if nb > CHUNK:
        perm = torch.cat([
            torch.arange(CHUNK, device=coords.device),
            CHUNK + torch.argsort(c[CHUNK:, 2], stable=True)])
        c, r, bidx = c[perm], r[perm], bidx[perm]
    idf = bidx.to(torch.int32).view(torch.float32)
    live = r >= 0
    tracing.host_sync("hetero._bigs_table")
    inf = torch.tensor(np.inf, dtype=torch.float32, device=coords.device)
    cols = [c[:, 0] - r, c[:, 1] - r, c[:, 2] - r,
            c[:, 0] + r, c[:, 1] + r, c[:, 2] + r]
    rows = torch.stack([torch.where(live, v, inf) for v in cols]
                       + [idf, inf.expand(nb)], dim=1)          # [nb, 8]
    nbc = nb // CHUNK
    zlo = torch.where(live, c[:, 2] - r, inf).view(nbc, CHUNK).amin(1)
    zhi = torch.where(live, c[:, 2] + r, -inf).view(nbc, CHUNK).amax(1)
    return rows.view(nbc, CHUNK, 8), zlo, zhi


def bigs_from_numpy(bigs, device):
    """The port's bigs table from the JAX ``_bigs_table``'s (rows, zlo,
    zhi) as numpy arrays, so both packages' big passes can run on one
    identical table."""
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in bigs)


@tracing.spanned("ct.hetero.split")
def _split(coords, radii, nb):
    """(nb, bidx, parked radii, bigs table) of an n-sphere scene for a
    requested ``nb`` (None: :func:`default_nb`)."""
    n = coords.shape[0]
    if nb is None:
        nb = default_nb(n)
    nb = min(nb, (n // CHUNK) * CHUNK) or min(CHUNK, n)
    if nb <= 0 or n <= CHUNK:
        raise ValueError("hetero engine needs n > 64 spheres")
    bidx = _big_indices(radii, nb)
    # -inf, not a finite negative radius: x -/+ 1 rounds back to x in f32
    # once |x| >= 2^24, which would leave a point box overlapping its own
    # big sphere.
    parked = radii.index_fill(0, bidx, -np.inf)
    return nb, bidx, parked, _bigs_table(coords, radii, bidx, nb)


def hetero_collide(coords, radii, capacity, nb=None, gxy=None,
                   col_capacity=None, slab_rows=None, rpw=1,
                   engine="column", gx=None, with_flags=False):
    """One heterogeneous-radii step: (pairs int64[capacity, 2] or None,
    int64 total, ok).

    ``engine`` picks the S-S pass: "column" (the parked column plan at
    ``gxy``/``col_capacity``/``slab_rows``, defaults from
    ``columns.default_column_config(n)``; its count runs the dual dispatch
    at base = max(1, min(rpw - 1, 4)) rows, its fill the masks at ``rpw``
    aligned rows) or "slab" (the parked slab plan at ``gx``, defaults from
    ``slabs.default_slab_config``; count and fill by dual dispatch at two
    rows; ``rpw`` and ``gxy`` unused). ``with_flags`` (slab only) appends
    (gx_ok, other_ok): the parts of ``ok`` that a finer slab grid can fix
    and the parts it cannot. Ids are uint32 values in int64; unused slots
    hold 0xFFFFFFFF.
    """
    if engine not in ("slab", "column"):
        raise ValueError(f"Unknown hetero engine: {engine}")
    if with_flags and engine != "slab":
        raise ValueError("with_flags requires engine='slab'")
    nb, bidx, parked, bigs = _split(coords, radii, nb)
    # Counted here, not in ``collide``: the retry ladder also runs the
    # engine directly.
    tracing.ATTEMPTS["hetero"] += 1
    if engine == "slab":
        return _hetero_slab(coords, radii, parked, bigs, bidx, nb, capacity,
                            gx, col_capacity, slab_rows, with_flags)
    n = coords.shape[0]
    d_gxy, d_cc, d_sr = default_column_config(n)
    plan = plan_columns(coords, parked, d_gxy if gxy is None else gxy,
                        d_cc if col_capacity is None else col_capacity,
                        d_sr if slab_rows is None else slab_rows)
    with tracing.span("ct.hetero.big"):
        mbb, tot_bb = _bb_mask(coords, radii, bidx, nb)
    if capacity == 0:
        # The dual count's sweep runs one row short of the fill's rung;
        # the residual jobs count the rest.
        base = max(1, min(int(rpw) - 1, 4)) if rpw > 1 else 1
        cnt_s, ok_s = sweep_count_dual(plan, base=base)
        with tracing.span("ct.hetero.big"):
            tot_bs, ovf_bs = bigpass.big_count_only(bigs, plan.stream)
        return None, cnt_s + tot_bs + tot_bb, ok_s & ovf_bs
    sa, sb, tot_s, ok_s = column_fill_from_plan(plan, capacity, rpw)
    with tracing.span("ct.hetero.big"):
        bsa, bsb, tot_bs, ovf_bs = bigpass.big_pairs(bigs, plan.stream,
                                                       capacity)
        bba, bbb, bb_cap = _bb_extract(mbb, bidx, nb, capacity)
        pairs, total = _assemble(sa, sb, tot_s, bsa, bsb, tot_bs, bba, bbb,
                                 bb_cap, tot_bb, capacity)
    return pairs, total, ok_s & ovf_bs


def _bb_mask(coords, radii, bidx, nb):
    """B-B: the [nb, nb] strict-overlap mask with the i < j dedup, and its
    int64 count."""
    bc = coords[bidx]
    br = radii[bidx, None]
    lo, hi = bc - br, bc + br
    idx = torch.arange(nb, device=coords.device)
    mbb = idx[:, None] < idx[None, :]
    for a in range(3):
        mbb &= (hi[:, None, a] > lo[None, :, a]) \
            & (lo[:, None, a] < hi[None, :, a])
    return mbb, mbb.sum()


def _bb_extract(mbb, bidx, nb, capacity):
    """Original-id B-B pair buffers of the dedup'd overlap mask (through
    the compaction kernel), at most min(capacity, nb(nb-1)/2) slots."""
    bb_cap = min(capacity, nb * (nb - 1) // 2)
    bb_idx, _ = compact.compact_mask(mbb.reshape(-1), max(bb_cap, 8))
    bbi = torch.clamp_max(bb_idx, nb * nb - 1)
    live = bb_idx != NO_PAIR
    bba = torch.where(live, bidx[bbi // nb], NO_PAIR)[:bb_cap]
    bbb = torch.where(live, bidx[bbi % nb], NO_PAIR)[:bb_cap]
    return bba, bbb, bb_cap


def _assemble(sa, sb, tot_s, bsa, bsb, tot_bs, bba, bbb, bb_cap, tot_bb,
              capacity):
    """(pairs int64[capacity, 2], total): the S-S, B-S and B-B segments one
    after another, truncated at ``capacity``."""
    total = tot_s + tot_bs + tot_bb
    ts = torch.clamp_max(tot_s, capacity)
    tbs = torch.clamp_max(tot_bs, capacity)
    q = torch.arange(capacity, device=sa.device)
    in_s = q < ts
    in_bs = ~in_s & (q < ts + tbs)
    qbs = torch.clamp(q - ts, 0, capacity - 1)
    qbb = torch.clamp(q - ts - tbs, 0, bb_cap - 1)
    ida = torch.where(in_s, sa, torch.where(in_bs, bsa[qbs], bba[qbb]))
    idb = torch.where(in_s, sb, torch.where(in_bs, bsb[qbs], bbb[qbb]))
    live = q < torch.clamp_max(total, capacity)
    pairs = torch.where(live[:, None], torch.stack([ida, idb], dim=1),
                        NO_PAIR)
    return pairs, total


def _hetero_slab(coords, radii, parked, bigs, bidx, nb, capacity, gx,
                 col_capacity, slab_rows, with_flags):
    """The slab S-S pass: the parked scene through the slab plan and the
    dual dispatch at two rows (the parked plans' windows are sized by the
    small class's r_max, which leaves a fat tail of windows between 128
    and 256 lanes: a second sweep row empties it)."""
    d_gx, d_cc, d_sr = default_slab_config(coords.shape[0], gx=gx)
    plan = plan_slabs(coords, parked, d_gx if gx is None else gx,
                      d_cc if col_capacity is None else col_capacity,
                      d_sr if slab_rows is None else slab_rows)
    with tracing.span("ct.hetero.big"):
        mbb, tot_bb = _bb_mask(coords, radii, bidx, nb)
    if capacity == 0:
        cnt_s, r_ok, no_ovf = slab_count_dual(plan, split_ok=True, base=2)
        with tracing.span("ct.hetero.big"):
            tot_bs, ovf_bs = bigpass.big_count_only(bigs, plan.stream)
        pairs, total = None, cnt_s + tot_bs + tot_bb
        gx_ok, other_ok = plan.ok & r_ok, no_ovf & ovf_bs
    else:
        sa, sb, tot_s, gx_ok, s_other = slab_fill_from_plan(
            plan, capacity, dual_base=2, split_ok=True)
        with tracing.span("ct.hetero.big"):
            bsa, bsb, tot_bs, ovf_bs = bigpass.big_pairs(bigs, plan.stream,
                                                           capacity)
            bba, bbb, bb_cap = _bb_extract(mbb, bidx, nb, capacity)
            pairs, total = _assemble(sa, sb, tot_s, bsa, bsb, tot_bs, bba,
                                     bbb, bb_cap, tot_bb, capacity)
        other_ok = s_other & ovf_bs
    if with_flags:
        return pairs, total, gx_ok & other_ok, (gx_ok, other_ok)
    return pairs, total, gx_ok & other_ok
