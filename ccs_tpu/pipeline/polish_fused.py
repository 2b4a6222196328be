"""Fused exhaustive polish loop (C8/C10) — the production device hot path.

Round-1 verdict: the candidate-gather polish loop (pipeline.polish) spent its
time in XLA gathers over huge column tensors and recompiled per shape. This
module replaces it with a static-shape formulation:

- **Exhaustive enumeration**: every polish iteration scores ALL single-point
  mutations of every window via the alpha/beta column-bridging trick
  (ops.hmm_cols), so the mutation grid is static — no per-lane top-k gathers,
  no data-dependent starts. The scorer is plain XLA: the forward/backward
  columns live in device memory between the column build and the bridge.
- **Multi-apply**: all improving mutations that are >=3 template positions
  apart are applied in one iteration (the reference's engine applies batches
  of spaced mutations per round as well; convergence is still judged on the
  exact re-scored likelihood each iteration, so the loop terminates exactly
  when no single mutation improves — /root/reference/docs/
  how-does-ccs-work.md:96-101).
- **Free QV**: the final iteration's mutation scores describe the converged
  template, which is exactly the LL-ratio set QV needs
  (how-does-ccs-work.md:103-106) — no extra scan.

Mutation enumeration (absolute-base; differs from pipeline.polish's
relative-base one): m = 9*p + k for template position p in 0..T-1 with
  k 0..3  substitute base k at p   (k == tpl[p] is invalid — it is a no-op)
  k 4     delete position p
  k 5..8  insert base k-5 after p
plus 4 trailing mutations: prepend base b before position 0.
M = 9*T + 4.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

NEG = -1e30
KINDS = 9  # 4 sub + 1 del + 4 ins per position

# Mean dense-scored p_err at NON-candidate CORE positions by (snr_bin,
# coverage) — fit by tools/fit_clean_qv.py (simulator, dense scoring, the
# production candidate rule; measured cells + log-linear interpolation).
# Used by clean_perr() in sparse mode (C7). Rows = 8 snr bins, cols =
# coverage 0..40 (clipped). E.g. snr bin 4: QV 15/32/46/72 at coverage
# 4/10/16/22 — the conditional MEAN, so rq stays calibrated in expectation
# (the tail is real: rare missed-candidate sites carry most of the mass).
import numpy as _np
import os as _os

def _clean_perr_default():
    path = _os.path.join(_os.path.dirname(__file__), "..", "models",
                         "data", "clean_perr_v0.npy")
    try:
        return _np.load(path).astype(_np.float32)
    except OSError:
        # fallback: log-linear in coverage, close to the snr-bin-4 fit
        cov = _np.arange(41, dtype=_np.float64)
        return _np.asarray(
            [_np.minimum(10.0 ** -(1.0 + 0.22 * cov), 0.25)] * 8,
            dtype=_np.float32)

CLEAN_PERR_V0 = _clean_perr_default()


# ---------------------------------------------------------------------------
# scoring: the hmm_cols column bridge
# ---------------------------------------------------------------------------

def score_all_xla(tpl, tlen, snr_bin, reads, rlens, tables,
                  m_chunk: int = 64):
    """Score every mutation of the 9-kind enumeration: (lls [B, M], ll0 [B]).

    Built on ops.hmm_cols (build_columns + mutation_ops_at +
    bridge_scores). Invalid mutations are NEG.
    """
    from ccs_tpu.ops.hmm_cols import (bridge_scores, build_columns,
                                      mutation_ops_at, prepend_ops)
    B, T = tpl.shape
    columns = build_columns(tpl, tlen, snr_bin, reads, rlens, tables)
    ll0 = columns.ll.sum(-1)

    p = jnp.repeat(jnp.arange(T), KINDS)[None, :]            # [1, 9T]
    k_new = jnp.tile(jnp.arange(KINDS), T)[None, :]
    p = jnp.broadcast_to(p, (B, KINDS * T))
    k_new = jnp.broadcast_to(k_new, (B, KINDS * T))
    cur = jnp.take_along_axis(tpl.astype(jnp.int32), p, axis=1)
    # map to pipeline.polish's relative-kind convention used by
    # mutation_ops_at: sub->(k-cur-1)%4 in 0..2, del->3, ins base k-5 -> k-1.
    old_kind = jnp.where(k_new <= 3, (k_new - cur - 1) % 4,
                         jnp.where(k_new == 4, 3, k_new - 1))
    reg = mutation_ops_at(tpl, tlen, snr_bin, tables, p, old_kind)
    pre = prepend_ops(tpl, tlen, snr_bin, tables)
    ops = tuple(jnp.concatenate([r, q], axis=1) for r, q in zip(reg, pre))
    lls = bridge_scores(reads, rlens, snr_bin, tables, columns, ops,
                        m_chunk=m_chunk)
    valid = mutation_valid_new(tpl, tlen)
    return jnp.where(valid, lls, NEG), ll0


def mutation_valid_new(tpl, tlen):
    """Validity mask of the 9-kind enumeration: [B, 9T+4] bool.

    All-static index structure: jnp.repeat with a static repeat count is a
    reshape, where a take_along_axis formulation lowers to a gather."""
    B, T = tpl.shape
    p = jnp.repeat(jnp.arange(T), KINDS)[None, :]
    k = jnp.tile(jnp.arange(KINDS), T)[None, :]
    cur = jnp.repeat(tpl.astype(jnp.int32), KINDS, axis=1)   # [B, 9T]
    tl = tlen[:, None]
    v = p < tl
    v &= jnp.where(k <= 3, k != cur, True)       # sub to self is a no-op
    v &= jnp.where(k == 4, tl > 1, True)         # keep >=1 base
    v &= jnp.where(k >= 5, tl < T, True)         # room to grow
    pre_v = jnp.broadcast_to((tlen < T)[:, None], (B, 4))
    return jnp.concatenate([v, pre_v], axis=1)


def expand_cand(cand):
    """[B, T] candidate mask -> [B, 9T+4] mutation-slot mask (prepends are
    always scored — selection needs them and they cost one bridge)."""
    B = cand.shape[0]
    reg = jnp.repeat(cand, KINDS, axis=1)
    return jnp.concatenate(
        [reg, jnp.ones((B, 4), dtype=cand.dtype)], axis=1)


def score_all(tpl, tlen, snr_bin, reads, rlens, tables, cand=None):
    """Score every mutation: (lls [B, 9T+4], ll0 [B]).

    ``cand`` [B, T] bool enables candidate-sparse scoring (C7,
    performance.md:90-93): only flagged positions carry mutation scores
    (others are NEG-invalid); ll0 stays exact. The bridge still runs over
    every position and the result is masked, so sparse mode saves
    selection work, not scoring work."""
    lls, ll0 = score_all_xla(tpl, tlen, snr_bin, reads, rlens, tables)
    if cand is None:
        return lls, ll0
    return jnp.where(expand_cand(cand), lls, NEG), ll0


# ---------------------------------------------------------------------------
# selection: improving, spaced (>=3 apart) mutation set per window
# ---------------------------------------------------------------------------

def _shift_val(x, off, fill):
    """x[..., j+off] with fill outside; off may be negative."""
    if off > 0:
        return jnp.concatenate(
            [x[..., off:], jnp.full_like(x[..., :off], fill)], axis=-1)
    if off < 0:
        return jnp.concatenate(
            [jnp.full_like(x[..., :(-off)], fill), x[..., :off]], axis=-1)
    return x


def select_mutations(lls, ll, priority, T: int, thresh: float = 1e-3):
    """Pick the improving mutation set to apply this iteration.

    Per position, the best of its 9 kinds; then a local-argmax filter with
    radius 2 (leftmost wins ties) guarantees selected edits are >=3 apart, so
    their operator changes never overlap. The prepend mutation competes with
    positions 0..2. Returns (sel [B,T] bool, pkind [B,T], pre_sel [B],
    pre_base [B], pbest [B,T] delta)."""
    B = lls.shape[0]
    reg = lls[:, :KINDS * T].reshape(B, T, KINDS)
    delta = reg - ll[:, None, None]
    pbest = delta.max(-1)
    pkind = delta.argmax(-1).astype(jnp.int32)
    imp = pbest > thresh
    if priority is not None:
        imp &= priority > 0.0                     # C7 candidate mask
    val = jnp.where(imp, pbest, NEG)
    sel = imp
    for off in (1, 2):
        sel &= val > _shift_val(val, -off, NEG)   # strictly beat left
        sel &= val >= _shift_val(val, off, NEG)   # ties: left (this j) wins

    pre_delta = lls[:, KINDS * T:] - ll[:, None]              # [B, 4]
    pre_best = pre_delta.max(-1)
    pre_base = pre_delta.argmax(-1).astype(jnp.int32)
    head = jnp.max(val[:, :3], axis=-1)
    pre_sel = (pre_best > thresh) & (pre_best >= head)
    sel = sel.at[:, :3].set(jnp.where(pre_sel[:, None], False, sel[:, :3]))
    return sel, pkind, pre_sel, pre_base, pbest


# ---------------------------------------------------------------------------
# apply: build the multi-edited template with core-offset bookkeeping
# ---------------------------------------------------------------------------

def apply_mutations(tpl, tlen, cs, ce, priority, sel, pkind, pre_sel,
                    pre_base, is_first, single=None):
    """Apply the selected spaced mutation set to each window.

    Falls back to the single best edit when insertions would overflow the
    template buffer, or when ``single`` [B] bool is set (careful mode: the
    multi-apply's combined LL change is only approximately the sum of the
    individual deltas, so a pathological window can cycle; applying one
    mutation at a time makes the exact LL strictly increase, guaranteeing
    convergence). Core offsets follow pipeline.polish.apply_mutation's
    junction convention (insert at core_start grows the left margin; insert
    at core_end stays in-core). Priority is remapped to the new coordinates
    with edited neighborhoods re-flagged."""
    B, T = tpl.shape
    j = jnp.arange(T)[None, :]
    in_tpl = j < tlen[:, None]

    op_sub = sel & (pkind <= 3)
    op_del = sel & (pkind == 4)
    op_ins = sel & (pkind >= 5)

    # single-edit fallback (any deterministic pick is valid — a single
    # insertion always fits because ins validity requires tlen < T); the
    # rest is re-discovered next iteration
    n_new = (tlen + op_ins.sum(-1) - op_del.sum(-1)
             + pre_sel.astype(jnp.int32))
    ovf = n_new > T
    if single is not None:
        ovf |= single
    first_sel = jnp.argmax(sel, axis=-1)
    sel_single = sel & (j == first_sel[:, None]) & sel.any(-1, keepdims=True)
    sel = jnp.where(ovf[:, None], jnp.where(pre_sel[:, None], False,
                                            sel_single), sel)
    pre_applied = pre_sel  # prepend alone never overflows (needs tlen < T)
    op_sub = sel & (pkind <= 3)
    op_del = sel & (pkind == 4)
    op_ins = sel & (pkind >= 5)

    base1 = jnp.where(op_sub, pkind.astype(jnp.int8), tpl)
    emit1 = in_tpl & ~op_del
    emit2 = in_tpl & op_ins
    ec = emit1.astype(jnp.int32) + emit2.astype(jnp.int32)
    start = pre_applied[:, None].astype(jnp.int32) + jnp.cumsum(ec, -1) - ec
    newlen = (pre_applied.astype(jnp.int32) + ec.sum(-1)).astype(jnp.int32)

    # One-hot contractions instead of scatters: a [B, T, T] masked reduction
    # (a few MB at [B, T] shapes) that XLA fuses, with no index scatter.
    pos1 = jnp.where(emit1, start, -1)
    pos2 = jnp.where(emit2, start + 1, -1)
    tgt = jnp.arange(T)[None, None, :]                   # [1, 1, T]
    oh1 = pos1[:, :, None] == tgt                        # [B, T, T]
    oh2 = pos2[:, :, None] == tgt
    val1 = (base1.astype(jnp.int32)[:, :, None] * oh1).sum(1)
    val2 = ((pkind - 5)[:, :, None] * oh2).sum(1)
    cov1 = oh1.any(1)
    cov2 = oh2.any(1)
    out = jnp.where(cov1, val1, jnp.where(cov2, val2, -1)).astype(jnp.int8)
    out = jnp.where(pre_applied[:, None] & (j == 0),
                    pre_base[:, None].astype(jnp.int8), out)
    out = jnp.where(j < newlen[:, None], out, jnp.int8(-1))

    # core offsets (all deltas in ORIGINAL coordinates, then summed)
    csn = cs[:, None]
    cen = ce[:, None]
    d_cs = ((op_ins & (j + 1 <= csn)).sum(-1)
            - (op_del & (j < csn)).sum(-1)
            + (pre_applied & ~(is_first & (cs == 0))).astype(jnp.int32))
    d_ce = ((op_ins & (j + 1 <= cen)).sum(-1)
            - (op_del & (j < cen)).sum(-1)
            + pre_applied.astype(jnp.int32))
    ncs = cs + d_cs
    nce = ce + d_ce

    # priority remap: re-flag edited neighborhoods, carried through the same
    # one-hot contraction (scatter-free)
    if priority is not None:
        nbh = sel
        for off in (1, 2):
            nbh |= _shift_val(sel, off, False) | _shift_val(sel, -off, False)
        nbh |= pre_applied[:, None] & (j <= 2)
        pri = jnp.maximum(priority, jnp.where(nbh, 1.0, 0.0))
        npri = (jnp.where(emit1, pri, 0.0)[:, :, None] * oh1).sum(1) \
            + (oh2.any(1)).astype(jnp.float32)
        npri = jnp.where(pre_applied[:, None] & (j == 0), 1.0, npri)
        npri = jnp.where(j < newlen[:, None], npri, 0.0)
    else:
        npri = None
    return out, newlen, ncs, nce, npri, sel.any(-1) | pre_applied


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

class FusedPolishState(NamedTuple):
    tpl: jnp.ndarray         # [B, T] int8
    tlen: jnp.ndarray        # [B] int32
    core_start: jnp.ndarray  # [B] int32
    core_end: jnp.ndarray    # [B] int32
    ll: jnp.ndarray          # [B] f32 exact LL of tpl (from the scorer)
    lls: jnp.ndarray         # [B, M] mutation scores OF tpl
    active: jnp.ndarray      # [B] bool
    n_iter: jnp.ndarray      # [B] int32
    priority: jnp.ndarray    # [B, T] f32 candidate mask (all-ones = exhaustive)


def _qv_from_lls(lls, ll, tpl, tlen):
    """QV per template position from the final mutation scores: error mass
    of every DISTINCT counterpart template touching the position
    (how-does-ccs-work.md:103-106); the k == tpl[p] slot is the no-op and is
    excluded.

    Equivalence classes are counted once (the round-2 miscalibration counted
    homopolymer deletions at every run position, multiplying their error
    mass by the run length):
    - deleting any base of a homopolymer run yields the same template ->
      the delete kind counts only at the LAST position of its run;
    - inserting base b after p and after p+1 coincide when tpl[p+1] == b ->
      an insertion counts only where the inserted base differs from the next
      template base (the rightmost junction of its class).
    Insertion mass (the consensus-is-missing-a-base error mode) is assigned
    to the base it follows; omitting it (round 2) made QVs underconfident
    ~2x against the simulator's empirical error."""
    B, T = tpl.shape
    reg = lls[:, :KINDS * T].reshape(B, T, KINDS)
    sub_del = reg[..., :5]
    k = jnp.arange(5)[None, None, :]
    is_self = k == jnp.clip(tpl, 0, 3)[..., None].astype(jnp.int32)
    nxt = jnp.concatenate([tpl[:, 1:], jnp.full((B, 1), -1, tpl.dtype)],
                          axis=1)
    j = jnp.arange(T)[None, :]
    in_tpl = j < tlen[:, None]
    run_last = (nxt != tpl) | (j + 1 >= tlen[:, None])       # [B, T]
    dup_del = (k == 4) & ~run_last[..., None]
    delta = jnp.where(is_self | dup_del, NEG, sub_del - ll[:, None, None])
    alt = jnp.where(delta > NEG / 2, delta, NEG)
    s = jnp.exp(jnp.minimum(alt, 30.0)).sum(-1)
    # insertion kinds 5..8: base b after position p, deduped rightmost
    ins = reg[..., 5:] - ll[:, None, None]
    b = jnp.arange(4)[None, None, :]
    dup_ins = (b == nxt[..., None].astype(jnp.int32)) & \
        (j + 1 < tlen[:, None])[..., None]
    ins = jnp.where(dup_ins | ~in_tpl[..., None], NEG, ins)
    s = s + jnp.where(ins > NEG / 2,
                      jnp.exp(jnp.minimum(ins, 30.0)), 0.0).sum(-1)
    p_err = s / (1.0 + s)
    qv = -10.0 * jnp.log10(jnp.maximum(p_err, 1e-9))
    return jnp.clip(qv, 0.0, 93.0), p_err


def clean_perr(tables, cov, snr_bin):
    """Calibrated error probability of a CLEAN (non-candidate) position.

    In sparse mode (C7) unflagged positions carry no mutation scores; their
    per-base p_err comes from this table — mean dense-scored p_err at
    non-candidate positions, fit per (snr_bin, coverage) on the simulator
    (tools/fit_clean_qv.py). Keyed by the same evidence the candidate rule
    used to clear the position: coverage and SNR. rq stays calibrated in
    expectation because the table IS the conditional mean; per-base QVs at
    these positions land in the top QV bins regardless (qv-binning.md).
    """
    tab = tables.get("clean_perr")
    if tab is None:
        tab = jnp.asarray(CLEAN_PERR_V0)
    c = jnp.clip(cov.astype(jnp.int32), 0, tab.shape[1] - 1)
    s = jnp.clip(snr_bin.astype(jnp.int32), 0, tab.shape[0] - 1)
    return tab[s, c]


def polish_windows_fused_impl(tpl, tlen, core_start, core_end, snr_bin,
                              reads, rlens, tables, max_iters: int = 40,
                              is_first=None, priority=None,
                              thresh: float = 0.02,
                              careful_after: int = 6,
                              sparse: bool = False):
    """Exhaustive multi-apply polish until no mutation improves.

    Same contract as pipeline.polish.polish_windows: returns
    (state, qv [B,T], p_err [B,T]). ``priority`` (C7) acts as a selection
    mask; None = exhaustive."""
    B, T = tpl.shape
    if is_first is None:
        is_first = jnp.zeros(B, dtype=bool)
    tlen = tlen.astype(jnp.int32)
    if priority is None:
        priority = jnp.ones((B, T), jnp.float32)
    j = jnp.arange(T)[None, :]
    priority = jnp.where(j < tlen[:, None], priority.astype(jnp.float32), 0.0)

    def score(t, tl, pri):
        return score_all(t, tl, snr_bin, reads, rlens, tables,
                         cand=(pri > 0.0) if sparse else None)

    def body(s):
        sel, pkind, pre_sel, pre_base, _ = select_mutations(
            s.lls, s.ll, s.priority, T, thresh=thresh)
        sel &= s.active[:, None]
        pre_sel &= s.active
        ntpl, nlen, ncs, nce, npri, improved = apply_mutations(
            s.tpl, s.tlen, s.core_start, s.core_end, s.priority, sel,
            pkind, pre_sel, pre_base, is_first,
            single=s.n_iter >= careful_after)
        m = improved[:, None]
        tpl2 = jnp.where(m, ntpl, s.tpl)
        tlen2 = jnp.where(improved, nlen, s.tlen)
        pri2 = jnp.where(m, npri, s.priority)
        # every row is re-scored, converged ones included: the scorer has
        # static shapes, so skipping rows would save no device work
        lls2, ll2 = score(tpl2, tlen2, pri2)
        return FusedPolishState(
            tpl=tpl2, tlen=tlen2,
            core_start=jnp.where(improved, ncs, s.core_start),
            core_end=jnp.where(improved, nce, s.core_end),
            ll=ll2, lls=lls2, active=improved,
            n_iter=s.n_iter + s.active.astype(jnp.int32),
            priority=pri2)

    lls0, ll0 = score(tpl, tlen, priority)
    has_cov = (rlens >= 0).any(-1)
    # a row enters the loop only if the initial scores contain an improving
    # mutation it would actually select — rows already at a local optimum
    # (the common case at production error rates) pay exactly ONE score call
    sel0, _pk0, pre0, _pb0, _ = select_mutations(lls0, ll0, priority, T,
                                                 thresh=thresh)
    state = FusedPolishState(
        tpl=tpl, tlen=tlen, core_start=core_start.astype(jnp.int32),
        core_end=core_end.astype(jnp.int32), ll=ll0, lls=lls0,
        active=has_cov & (sel0.any(-1) | pre0),
        n_iter=jnp.zeros(B, jnp.int32), priority=priority)

    def cond(s):
        it = jnp.max(jnp.where(s.active, s.n_iter, 0))
        return s.active.any() & (it < max_iters)

    state = jax.lax.while_loop(cond, body, state)
    qv, p_err = _qv_from_lls(state.lls, state.ll, state.tpl, state.tlen)
    if sparse:
        # clean (non-candidate) positions carry no mutation scores; their
        # p_err comes from the calibrated table (see clean_perr)
        cov = (rlens >= 0).sum(-1)
        pc = clean_perr(tables, cov, snr_bin)                  # [B]
        j2 = jnp.arange(T)[None, :]
        ncm = (state.priority <= 0.0) & (j2 < state.tlen[:, None])
        p_err = jnp.where(ncm, pc[:, None], p_err)
        qv_c = jnp.clip(-10.0 * jnp.log10(jnp.maximum(pc, 1e-9)), 0.0, 93.0)
        qv = jnp.where(ncm, qv_c[:, None], qv)
    return state, qv, p_err


polish_windows_fused = jax.jit(
    polish_windows_fused_impl,
    static_argnames=("max_iters", "thresh",
                     "careful_after", "sparse"))
