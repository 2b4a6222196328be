"""TEST ORACLE — the round-1 dense Arrow polishing loop, kept ONLY as an
independent implementation for cross-checking the fused product path
(pipeline.polish_fused); no product code imports this module (the engine and
mesh wire polish_fused exclusively since round 3).

/root/reference/docs/how-does-ccs-work.md:96-101: for every candidate
position, test whether the summed subread log-likelihood improves by
substituting one of the other three nucleotides, inserting one of four after
the position, or deleting the position; apply the best improvement; repeat
until no beneficial mutation remains.

Batched device formulation: all windows (across ZMWs) advance in lock-step
inside one ``lax.while_loop``; converged windows become no-ops via an active
mask (SURVEY.md §7 design principles). Mutation scoring is a dense re-forward
over [window × mutation × subread] lanes, chunked over mutations to bound
memory. QVs fall out of the same mutation scores at convergence
(how-does-ccs-work.md:103-106).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ccs_tpu.ops.hmm_jax import forward_batch

MUTS_PER_POS = 8  # 3 substitutions, 1 deletion, 4 insertions (after pos)
NEG = -1e30


class PolishState(NamedTuple):
    tpl: jnp.ndarray         # [B, T] int8
    tlen: jnp.ndarray        # [B] int32
    core_start: jnp.ndarray  # [B] int32
    core_end: jnp.ndarray    # [B] int32
    ll: jnp.ndarray          # [B] f32 current summed log-likelihood
    active: jnp.ndarray      # [B] bool still improving
    n_iter: jnp.ndarray      # [B] int32 iterations executed
    mut_lls: jnp.ndarray     # [B, M] f32 mutation scores of the last-scored
                             # template (== final template at convergence;
                             # reused for QV so the scoring graph exists once)


def make_mutants(tpl: jnp.ndarray, tlen: jnp.ndarray):
    """All single-edit mutants of each template.

    tpl [B, T] -> mut_tpl [B, M, T], mut_tlen [B, M], valid [B, M]
    with M = MUTS_PER_POS * T + 4. Mutation m < 8T: pos = m // 8,
    kind = m % 8: kind 0-2 substitute (tpl[pos]+1+kind)%4, kind 3 delete
    pos, kind 4-7 insert base (kind-4) after pos. The trailing 4 mutations
    prepend base (m - 8T) before position 0 (only the globally-first window
    of a ZMW emits that region; how-does-ccs-work.md:98 only lists
    insert-after, but without this the first template base can never gain a
    predecessor).
    """
    B, T = tpl.shape
    M = MUTS_PER_POS * T
    m = jnp.arange(M)
    pos = (m // MUTS_PER_POS)[None, :, None]          # [1, M, 1]
    kind = (m % MUTS_PER_POS)[None, :, None]
    j = jnp.arange(T)[None, None, :]                  # [1, 1, T]
    t = tpl[:, None, :]                               # [B, 1, T]
    base_at = jnp.take_along_axis(
        jnp.broadcast_to(t, (B, M, T)),
        jnp.broadcast_to(pos, (B, M, 1)).astype(jnp.int32), axis=2)  # [B, M, 1]

    sub_base = ((base_at + 1 + kind) % 4).astype(jnp.int8)
    sub_tpl = jnp.where((j == pos) & (kind <= 2), sub_base, t)

    # delete: shift left at pos
    del_idx = jnp.clip(j + (j >= pos), 0, T - 1).astype(jnp.int32)
    del_tpl = jnp.take_along_axis(jnp.broadcast_to(t, (B, M, T)),
                                  jnp.broadcast_to(del_idx, (B, M, T)), axis=2)
    del_tpl = jnp.where(j == T - 1, jnp.int8(-1), del_tpl)  # tail is padding

    # insert after pos: new base at index pos+1, suffix shifts right
    ins_base = (kind - 4).astype(jnp.int8)
    prev_idx = jnp.clip(j - 1, 0, T - 1).astype(jnp.int32)
    shifted = jnp.take_along_axis(jnp.broadcast_to(t, (B, M, T)),
                                  jnp.broadcast_to(prev_idx, (B, M, T)), axis=2)
    ins_tpl = jnp.where(j <= pos, t, jnp.where(j == pos + 1, ins_base, shifted))

    is_sub = kind <= 2
    is_del = kind == 3
    mut_tpl = jnp.where(is_sub, sub_tpl, jnp.where(is_del, del_tpl, ins_tpl))
    mut_tpl = mut_tpl.astype(jnp.int8)

    tl = tlen[:, None]                                # [B, 1]
    kind1 = kind[..., 0]
    pos1 = pos[..., 0]
    mut_tlen = (tl + jnp.where(kind1 == 3, -1, jnp.where(kind1 >= 4, 1, 0))
                ).astype(jnp.int32)
    valid = (pos1 < tl)
    valid &= jnp.where(kind1 == 3, tl > 1, True)
    valid &= jnp.where(kind1 >= 4, tl < T, True)
    # mask pad positions beyond each mutant's tlen
    mut_tpl = jnp.where(j < mut_tlen[..., None], mut_tpl, jnp.int8(-1))

    # 4 prepend mutations: base b at index 0, everything shifts right
    jp = jnp.arange(T)[None, None, :]
    bases = jnp.arange(4, dtype=jnp.int8)[None, :, None]
    pre = jnp.where(jp == 0, bases,
                    jnp.take_along_axis(
                        jnp.broadcast_to(t, (B, 4, T)),
                        jnp.broadcast_to(jnp.clip(jp - 1, 0, T - 1), (B, 4, T)).astype(jnp.int32),
                        axis=2)).astype(jnp.int8)
    pre_tlen = jnp.broadcast_to(tlen[:, None] + 1, (B, 4)).astype(jnp.int32)
    pre = jnp.where(jp < pre_tlen[..., None], pre, jnp.int8(-1))
    pre_valid = jnp.broadcast_to(tlen[:, None] < T, (B, 4))
    return (jnp.concatenate([mut_tpl, pre], axis=1),
            jnp.concatenate([mut_tlen, pre_tlen], axis=1),
            jnp.concatenate([valid, pre_valid], axis=1))


def score_mutants(mut_tpl, mut_tlen, valid, snr_bin, reads, rlens, tables,
                  m_chunk: int = 32):
    """Summed-over-subreads LL for every mutant: [B, M].

    Chunked over the mutation axis to bound live DP state
    ([B, m_chunk, C, T+1] f32 at a time).
    """
    B, M, T = mut_tpl.shape
    _, C, R = reads.shape
    n_chunks = (M + m_chunk - 1) // m_chunk
    Mp = n_chunks * m_chunk
    if Mp != M:
        pad = Mp - M
        mut_tpl = jnp.pad(mut_tpl, ((0, 0), (0, pad), (0, 0)), constant_values=-1)
        mut_tlen = jnp.pad(mut_tlen, ((0, 0), (0, pad)), constant_values=1)
    mut_tpl = mut_tpl.reshape(B, n_chunks, m_chunk, T).swapaxes(0, 1)
    mut_tlen = mut_tlen.reshape(B, n_chunks, m_chunk).swapaxes(0, 1)

    def one_chunk(args):
        mt, ml = args                                  # [B, mc, T], [B, mc]
        flat_t = mt.reshape(B * m_chunk, T)
        flat_l = ml.reshape(B * m_chunk)
        sb = jnp.repeat(snr_bin, m_chunk)
        rd = jnp.broadcast_to(reads[:, None], (B, m_chunk, C, R)).reshape(-1, C, R)
        rl = jnp.broadcast_to(rlens[:, None], (B, m_chunk, C)).reshape(-1, C)
        ll = forward_batch(flat_t, flat_l, sb, rd, rl, tables)  # [B*mc, C]
        return ll.sum(-1).reshape(B, m_chunk)

    lls = jax.lax.map(one_chunk, (mut_tpl, mut_tlen))  # [n_chunks, B, mc]
    lls = lls.swapaxes(0, 1).reshape(B, Mp)[:, :M]
    return jnp.where(valid, lls, NEG)


def mutation_valid(tlen, T: int):
    """Validity mask of make_mutants' enumeration without building mutants."""
    m = jnp.arange(MUTS_PER_POS * T)
    pos, kind = m // MUTS_PER_POS, m % MUTS_PER_POS
    tl = tlen[:, None]
    valid = pos[None, :] < tl
    valid &= jnp.where(kind[None, :] == 3, tl > 1, True)
    valid &= jnp.where(kind[None, :] >= 4, tl < T, True)
    pre_valid = jnp.broadcast_to((tlen < T)[:, None], (tlen.shape[0], 4))
    return jnp.concatenate([valid, pre_valid], axis=1)


def apply_mutation(tpl, tlen, core_start, core_end, mut_id, is_first=None):
    """Apply mutation ``mut_id`` (per row) to each template; updates core
    offsets so stitching (C11) stays exact. ``is_first`` marks the globally
    first window of each ZMW (a prepended base belongs to its core)."""
    B, T = tpl.shape
    if is_first is None:
        is_first = jnp.zeros(B, dtype=bool)
    is_pre = mut_id >= MUTS_PER_POS * T
    reg_id = jnp.where(is_pre, 0, mut_id)
    pos = (reg_id // MUTS_PER_POS).astype(jnp.int32)
    kind = (reg_id % MUTS_PER_POS).astype(jnp.int32)
    j = jnp.arange(T)[None, :]
    p = pos[:, None]
    k = kind[:, None]
    base_at = jnp.take_along_axis(tpl, p, axis=1)
    sub_base = ((base_at + 1 + k) % 4).astype(jnp.int8)
    sub_tpl = jnp.where(j == p, sub_base, tpl)
    del_idx = jnp.clip(j + (j >= p), 0, T - 1)
    del_tpl = jnp.take_along_axis(tpl, del_idx, axis=1)
    ins_base = (k - 4).astype(jnp.int8)
    prev_idx = jnp.clip(j - 1, 0, T - 1)
    shifted = jnp.take_along_axis(tpl, prev_idx, axis=1)
    ins_tpl = jnp.where(j <= p, tpl, jnp.where(j == p + 1, ins_base, shifted))
    out = jnp.where(k <= 2, sub_tpl, jnp.where(k == 3, del_tpl, ins_tpl)).astype(jnp.int8)

    delta = jnp.where(kind == 3, -1, jnp.where(kind >= 4, 1, 0)).astype(jnp.int32)
    new_tlen = tlen + delta
    out = jnp.where(j < new_tlen[:, None], out, jnp.int8(-1))
    # core-offset bookkeeping: edit index = pos (sub/del) or pos+1 (ins)
    edit_idx = jnp.where(kind >= 4, pos + 1, pos)
    # Junction convention: an insertion landing exactly at core_start is
    # pushed OUT (grows the left margin) while one landing exactly at
    # core_end is kept IN — so a base inserted at the junction between two
    # windows' cores is emitted by exactly one of them (the left window).
    shift_start = jnp.where(kind == 3, -(edit_idx < core_start).astype(jnp.int32),
                            jnp.where(kind >= 4, (edit_idx <= core_start).astype(jnp.int32), 0))
    shift_end = jnp.where(kind == 3, -(edit_idx < core_end).astype(jnp.int32),
                          jnp.where(kind >= 4, (edit_idx <= core_end).astype(jnp.int32), 0))

    # prepend mutation: base (mut_id - 8T) inserted before index 0
    pre_base = jnp.clip(mut_id - MUTS_PER_POS * T, 0, 3).astype(jnp.int8)
    j1 = jnp.arange(T)[None, :]
    pre_tpl = jnp.where(j1 == 0, pre_base[:, None],
                        jnp.take_along_axis(tpl, jnp.clip(j1 - 1, 0, T - 1), axis=1)
                        ).astype(jnp.int8)
    pre_tlen = tlen + 1
    pre_tpl = jnp.where(j1 < pre_tlen[:, None], pre_tpl, jnp.int8(-1))
    # first window with core_start==0 keeps the prepended base in-core
    pre_cs = jnp.where(is_first & (core_start == 0), core_start, core_start + 1)
    pre_ce = core_end + 1

    out = jnp.where(is_pre[:, None], pre_tpl, out)
    new_tlen = jnp.where(is_pre, pre_tlen, new_tlen)
    new_cs = jnp.where(is_pre, pre_cs, core_start + shift_start)
    new_ce = jnp.where(is_pre, pre_ce, core_end + shift_end)
    return out, new_tlen, new_cs, new_ce


def _qv_from_deltas(delta):
    """QV per template position from sub+del score deltas [B, T, 4]
    (how-does-ccs-work.md:103-106): p_err from the LL-ratio of the best
    template vs its mutated counterparts."""
    alt = jnp.where(jnp.isfinite(delta) & (delta > NEG / 2), delta, NEG)
    s = jnp.exp(jnp.minimum(alt, 30.0)).sum(-1)
    p_err = s / (1.0 + s)
    qv = -10.0 * jnp.log10(jnp.maximum(p_err, 1e-9))
    return jnp.clip(qv, 0.0, 93.0), p_err


class CandPolishState(NamedTuple):
    tpl: jnp.ndarray         # [B, T] int8
    tlen: jnp.ndarray        # [B] int32
    core_start: jnp.ndarray  # [B] int32
    core_end: jnp.ndarray    # [B] int32
    ll: jnp.ndarray          # [B] f32
    active: jnp.ndarray      # [B] bool
    n_iter: jnp.ndarray      # [B] int32
    priority: jnp.ndarray    # [B, T] f32 candidate priority (0 = skip)


def _polish_candidates(tpl, tlen, core_start, core_end, snr_bin, reads, rlens,
                       tables, priority, max_iters: int, m_chunk: int,
                       k_cand: int, is_first):
    """Candidate-filtered polish (component C7, performance.md:90-93).

    Each iteration gathers the K highest-priority template positions per
    window and scores only their 8 mutations (+4 prepends) by column
    bridging. Tried positions drop to priority 0; an accepted edit re-flags
    its ±2 neighborhood (the only operators the edit changed), so every
    flagged candidate is eventually scored and convergence means no flagged
    mutation improves — the documented "skipping unambiguous positions"
    heuristic with its >=2x speedup. QVs come from a final sub+del scan of
    every position of the converged template.
    """
    from ccs_tpu.ops.hmm_cols import (bridge_scores, build_columns,
                                      mutation_ops_at, prepend_ops)

    B, T = tpl.shape
    K = min(k_cand, T)
    ll0 = forward_batch(tpl, tlen, snr_bin, reads, rlens, tables).sum(-1)
    has_cov = (rlens >= 0).any(-1)
    j_t = jnp.arange(T)[None, :]
    if priority is None:
        priority = jnp.ones((B, T), jnp.float32)
    priority = jnp.where((j_t < tlen[:, None]) & has_cov[:, None],
                         priority.astype(jnp.float32), 0.0)
    state = CandPolishState(
        tpl, tlen.astype(jnp.int32), core_start.astype(jnp.int32),
        core_end.astype(jnp.int32), ll0,
        active=has_cov & (priority > 0).any(-1),
        n_iter=jnp.zeros(B, jnp.int32), priority=priority)

    kind_pat = jnp.tile(jnp.arange(MUTS_PER_POS), K)
    rows = jnp.arange(B)[:, None]

    def cond(s):
        return s.active.any() & (s.n_iter.max() < max_iters)

    def body(s):
        columns = build_columns(s.tpl, s.tlen, snr_bin, reads, rlens, tables)
        vals, idx = jax.lax.top_k(s.priority, K)             # [B, K]
        pos8 = jnp.repeat(idx, MUTS_PER_POS, axis=1)         # [B, 8K]
        kind8 = jnp.broadcast_to(kind_pat[None], (B, MUTS_PER_POS * K))
        reg = mutation_ops_at(s.tpl, s.tlen, snr_bin, tables, pos8, kind8)
        pre = prepend_ops(s.tpl, s.tlen, snr_bin, tables)
        ops = tuple(jnp.concatenate([r, p], axis=1) for r, p in zip(reg, pre))
        lls = bridge_scores(reads, rlens, snr_bin, tables, columns, ops,
                            m_chunk=m_chunk)
        tl = s.tlen[:, None]
        v = (pos8 < tl) & (jnp.repeat(vals, MUTS_PER_POS, axis=1) > 0)
        v &= jnp.where(kind8 == 3, tl > 1, True)
        v &= jnp.where(kind8 >= 4, tl < T, True)
        v_pre = jnp.broadcast_to((s.tlen < T)[:, None], (B, 4))
        lls = jnp.where(jnp.concatenate([v, v_pre], axis=1), lls, NEG)

        best = jnp.argmax(lls, axis=-1)
        best_ll = jnp.take_along_axis(lls, best[:, None], axis=1)[:, 0]
        improved = (best_ll > s.ll + 1e-3) & s.active
        n_reg = MUTS_PER_POS * K
        reg_best = jnp.minimum(best, n_reg - 1)[:, None]
        sel_pos = jnp.take_along_axis(pos8, reg_best, axis=1)[:, 0]
        sel_kind = jnp.take_along_axis(kind8, reg_best, axis=1)[:, 0]
        is_pre = best >= n_reg
        mut_id = jnp.where(is_pre, MUTS_PER_POS * T + (best - n_reg),
                           sel_pos * MUTS_PER_POS + sel_kind)
        new_tpl, new_tlen, cs, ce = apply_mutation(
            s.tpl, s.tlen, s.core_start, s.core_end, mut_id, is_first)

        # --- priority bookkeeping ---
        # tried positions drop to 0 — EXCEPT positions that still carry an
        # improving mutation (only the global best is applied per iteration;
        # runners-up must stay flagged or their improvements are lost)
        pos_ll = jnp.max(lls[:, :n_reg].reshape(B, K, MUTS_PER_POS), axis=-1)
        pos_imp = pos_ll > s.ll[:, None] + 1e-3
        pri = s.priority.at[rows, idx].set(jnp.where(pos_imp, vals, 0.0))
        # indel edits shift positions: remap priorities to new coordinates
        p = sel_pos[:, None]
        del_src = jnp.clip(j_t + (j_t >= p), 0, T - 1)
        ins_src = jnp.clip(jnp.where(j_t <= p, j_t, j_t - 1), 0, T - 1)
        pre_src = jnp.clip(j_t - 1, 0, T - 1)
        src = jnp.where(is_pre[:, None], pre_src,
                        jnp.where((sel_kind == 3)[:, None], del_src,
                                  jnp.where((sel_kind >= 4)[:, None],
                                            ins_src, j_t)))
        shifted = jnp.take_along_axis(pri, src, axis=1)
        # re-flag the edited neighborhood (its bridge operators changed)
        e = jnp.where(is_pre, 0,
                      jnp.where(sel_kind >= 4, sel_pos + 1, sel_pos))[:, None]
        nb = (j_t >= e - 2) & (j_t <= e + 2)
        pri_new = jnp.where(improved[:, None],
                            jnp.where(nb, 1.0, shifted), pri)
        eff_tlen = jnp.where(improved, new_tlen, s.tlen)
        pri_new = jnp.where(j_t < eff_tlen[:, None], pri_new, 0.0)

        sel = improved[:, None]
        return CandPolishState(
            tpl=jnp.where(sel, new_tpl, s.tpl),
            tlen=jnp.where(improved, new_tlen, s.tlen),
            core_start=jnp.where(improved, cs, s.core_start),
            core_end=jnp.where(improved, ce, s.core_end),
            ll=jnp.where(improved, best_ll, s.ll),
            active=(pri_new > 0).any(-1) & has_cov,
            n_iter=s.n_iter + s.active.astype(jnp.int32),
            priority=pri_new)

    state = jax.lax.while_loop(cond, body, state)

    # --- final QV scan: sub+del of every position of the final template ---
    columns = build_columns(state.tpl, state.tlen, snr_bin, reads, rlens,
                            tables)
    posq = jnp.broadcast_to(jnp.repeat(jnp.arange(T), 4)[None], (B, 4 * T))
    kindq = jnp.broadcast_to(jnp.tile(jnp.arange(4), T)[None], (B, 4 * T))
    opsq = mutation_ops_at(state.tpl, state.tlen, snr_bin, tables, posq, kindq)
    llq = bridge_scores(reads, rlens, snr_bin, tables, columns, opsq,
                        m_chunk=m_chunk)
    vq = posq < state.tlen[:, None]
    vq &= jnp.where(kindq == 3, state.tlen[:, None] > 1, True)
    delta = jnp.where(vq, llq - state.ll[:, None], NEG).reshape(B, T, 4)
    qv, p_err = _qv_from_deltas(delta)
    return state, qv, p_err


def polish_windows_impl(tpl, tlen, core_start, core_end, snr_bin, reads, rlens,
                        tables, max_iters: int = 40, m_chunk: int = 32,
                        is_first=None, scoring: str = "cols",
                        heuristics: bool = False, k_cand: int = 12,
                        priority=None):
    """Iterate best-mutation steps until convergence (all windows, lock-step).

    ``is_first``: bool [B], True for the globally-first window of each ZMW.
    ``scoring``: "cols" scores mutants by alpha/beta column bridging
    (O(R) per mutant, ops.hmm_cols — the unanimity-style trick,
    how-does-ccs-work.md:96-101); "dense" re-runs a full forward per mutant
    (the brute-force oracle the bridged path is tested against).
    ``heuristics``: candidate-filtered loop (C7) — only positions with
    positive ``priority`` [B, T] are polished; see _polish_candidates.
    Returns the polish state plus per-position QV of the final template.
    """
    from ccs_tpu.ops.hmm_cols import build_columns, score_mutants_cols

    if is_first is None and heuristics:
        is_first = jnp.zeros(tpl.shape[0], dtype=bool)
    if heuristics:
        return _polish_candidates(tpl, tlen, core_start, core_end, snr_bin,
                                  reads, rlens, tables, priority, max_iters,
                                  m_chunk, k_cand, is_first)
    if is_first is None:
        is_first = jnp.zeros(tpl.shape[0], dtype=bool)
    ll0 = forward_batch(tpl, tlen, snr_bin, reads, rlens, tables).sum(-1)
    has_cov = (rlens >= 0).any(-1)
    B, T = tpl.shape
    M = MUTS_PER_POS * T + 4
    state = PolishState(tpl, tlen.astype(jnp.int32), core_start.astype(jnp.int32),
                        core_end.astype(jnp.int32), ll0,
                        active=has_cov, n_iter=jnp.zeros(B, jnp.int32),
                        mut_lls=jnp.full((B, M), NEG, jnp.float32))

    def cond(state):
        return state.active.any() & (state.n_iter.max() < max_iters)

    def body(state):
        if scoring == "cols":
            columns = build_columns(state.tpl, state.tlen, snr_bin, reads,
                                    rlens, tables)
            valid = mutation_valid(state.tlen, T)
            lls = score_mutants_cols(state.tpl, state.tlen, snr_bin, reads,
                                     rlens, tables, columns, valid,
                                     m_chunk=m_chunk)
        else:
            mut_tpl, mut_tlen, valid = make_mutants(state.tpl, state.tlen)
            lls = score_mutants(mut_tpl, mut_tlen, valid, snr_bin, reads,
                                rlens, tables, m_chunk=m_chunk)
        best = jnp.argmax(lls, axis=-1)
        best_ll = jnp.take_along_axis(lls, best[:, None], axis=1)[:, 0]
        improved = (best_ll > state.ll + 1e-3) & state.active
        new_tpl, new_tlen, cs, ce = apply_mutation(
            state.tpl, state.tlen, state.core_start, state.core_end, best,
            is_first)
        sel = improved[:, None]
        return PolishState(
            tpl=jnp.where(sel, new_tpl, state.tpl),
            tlen=jnp.where(improved, new_tlen, state.tlen),
            core_start=jnp.where(improved, cs, state.core_start),
            core_end=jnp.where(improved, ce, state.core_end),
            ll=jnp.where(improved, best_ll, state.ll),
            active=improved,
            n_iter=state.n_iter + state.active.astype(jnp.int32),
            # keep the scores of the template they were computed FOR: on the
            # final (non-improving) iteration these describe the final
            # template, which is exactly what QV needs
            mut_lls=jnp.where(sel, state.mut_lls, lls),
        )

    state = jax.lax.while_loop(cond, body, state)

    # --- QV from the last-scored mutation set (sub + del, kinds 0..3) ---
    delta = (state.mut_lls[:, :MUTS_PER_POS * T]
             - state.ll[:, None]).reshape(B, T, MUTS_PER_POS)
    # per-base alternatives: 3 subs + deletion (kinds 0..3)
    qv, p_err = _qv_from_deltas(delta[..., :4])
    return state, qv, p_err


polish_windows = jax.jit(polish_windows_impl,
                         static_argnames=("max_iters", "m_chunk", "scoring",
                                          "heuristics", "k_cand"))
