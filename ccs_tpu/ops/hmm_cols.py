"""Column-form pair-HMM: forward/backward columns + O(R) mutation scoring.

The brute-force mutation scorer (pipeline.polish.score_mutants) re-runs a
full O(R*T) forward pass for every single-point mutant — the dominant cost
of polishing. This module implements the classical alpha/beta trick the
reference's closed-source engine uses (mutation testing against stored
forward/backward matrices, /root/reference/docs/how-does-ccs-work.md:96-101):

- ``forward_cols``/``backward_cols`` run the DP **by template columns** and
  store every column (boundary) vector over read positions, O(R*T) once per
  template.
- a single-point mutation at template position p only changes the column
  transfer operators A_p..A_{p+2} (a base edit alters the dinucleotide
  context of positions p and p+1). So
      LL(mutant) = beta_q . A'_{...} A'_{...} A'_{...} . col_s
  with s/q just outside the edited span — three O(R) operator applications
  per mutant instead of a full forward: ~25x less compute per polish
  iteration.

Column algebra (indices: i = read prefix length 0..R, j = template boundary
0..T; params me/ie/dp from hmm_jax.position_tables):

    col_j = SolveIns_{ie[j]}( dp[j-1] * col_{j-1} + me[j-1][r_i] * shift(col_{j-1}) )

with virtual col_{-1} = e_0, dp[-1] = 1, me[-1] = 0, and **identity padding**
dp[j] = 1, me[j] = ie[j] = 0 for j >= tlen, so operators beyond the template
end are no-ops and beta_j = e_rl for j >= tlen — this makes every
template-end edge case uniform. SolveIns resolves the within-column
insertion chain w[i] = y[i] + ie[r_i] * w[i-1] exactly by doubling.

The only deliberate deviation from hmm_jax._forward_batch_scan is that the
delete chain here is exact (one dp factor per column step) while the scan
path truncates runs at depth 8 — a <1e-7 relative difference.

Shapes follow hmm_jax.forward_batch:
  tpl [B,T] int8, tlen [B], snr_bin [B], reads [B,C,R] int8, rlens [B,C].
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ccs_tpu.ops.hmm_jax import position_tables

TINY = 1e-30
NEG = -1e30
MUTS_PER_POS = 8


class HmmColumns(NamedTuple):
    cols: jnp.ndarray      # [B, C, T+2, R+1]  colarr[k] = col_{k-1}; [0]=e_0
    ls_col: jnp.ndarray    # [B, C, T+2]       log-scale of each column
    betas: jnp.ndarray     # [B, C, T+1, R+1]  beta_j, j = 0..T
    ls_beta: jnp.ndarray   # [B, C, T+1]
    ll: jnp.ndarray        # [B, C]            log P(read | template); 0 if absent


def _onehot_reads(reads: jnp.ndarray) -> jnp.ndarray:
    """[B,C,R] int8 (packed base + 4*pw codes) -> [B,C,R,4] f32 one-hot of
    the BASE; PAD (-1) rows are all-zero."""
    r = reads.astype(jnp.int32)
    oh = jax.nn.one_hot(jnp.clip(r, 0, 15) % 4, 4, dtype=jnp.float32)
    return jnp.where((r >= 0)[..., None], oh, 0.0)


def _oh_pw(reads: jnp.ndarray, snr_bin: jnp.ndarray, tables: dict):
    """Pulse-width-conditioned emission planes (how-does-ccs-work.md:88-95).

    Returns (ohm, ohi) [B,C,R,4]: one-hot of the read base scaled by the
    per-base pw likelihood factor for Match (ohm) and Branch/Stick (ohi)
    emissions. Plain-base reads (codes 0..3) are pw bin 0, factor 1, so the
    pw-agnostic path is the special case."""
    r = reads.astype(jnp.int32)
    c = jnp.clip(r, 0, 15)
    oh = jax.nn.one_hot(c % 4, 4, dtype=jnp.float32)
    oh = jnp.where((r >= 0)[..., None], oh, 0.0)
    w = c // 4
    fm = tables["pw_match"][snr_bin[:, None, None], w]
    fi = tables["pw_ins"][snr_bin[:, None, None], w]
    return oh * fm[..., None], oh * fi[..., None]


def contract4(oh: jnp.ndarray, vec4: jnp.ndarray) -> jnp.ndarray:
    """sum_x oh[..., x] * vec4[..., x] over the 4 bases, as an elementwise
    multiply-sum rather than an einsum.

    ``oh`` is a scaled one-hot, so each sum has one nonzero term and the
    result is the exact float32 product whatever the backend's matmul
    precision (a float32 einsum may run as TF32 on a GPU, which would shift
    every log-likelihood). XLA fuses it into the solve that consumes it."""
    return jnp.sum(oh * vec4, axis=-1)


def _solve_fwd(y: jnp.ndarray, a: jnp.ndarray) -> jnp.ndarray:
    """Exact prefix recurrence w[i] = y[i] + a[i]*w[i-1] along the last axis
    (length R+1) via doubling."""
    n = y.shape[-1]
    x, c = y, a
    d = 1
    while d < n:
        zx = jnp.zeros_like(x[..., :d])
        x = x + c * jnp.concatenate([zx, x[..., :-d]], axis=-1)
        c = c * jnp.concatenate([zx, c[..., :-d]], axis=-1)
        d *= 2
    return x


def _solve_bwd(y: jnp.ndarray, a: jnp.ndarray) -> jnp.ndarray:
    """Exact suffix recurrence w[i] = y[i] + a[i]*w[i+1] along the last axis."""
    n = y.shape[-1]
    x, c = y, a
    d = 1
    while d < n:
        zx = jnp.zeros_like(x[..., :d])
        x = x + c * jnp.concatenate([x[..., d:], zx], axis=-1)
        c = c * jnp.concatenate([c[..., d:], zx], axis=-1)
        d *= 2
    return x


def _shift1(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([jnp.zeros_like(v[..., :1]), v[..., :-1]], axis=-1)


def _padded_tables(tpl, tlen, snr_bin, tables):
    """position_tables with identity padding beyond tlen (dp=1)."""
    me, ie, dp = position_tables(tpl, snr_bin, tables)
    T = tpl.shape[-1]
    in_tpl = jnp.arange(T)[None, :] < tlen[:, None]
    dp = jnp.where(in_tpl, dp, 1.0)
    ie = jnp.where(in_tpl[..., None], ie, 0.0)
    me = jnp.where(in_tpl[..., None], me, 0.0)
    return me, ie, dp


@functools.partial(jax.jit, static_argnames=())
def build_columns(tpl, tlen, snr_bin, reads, rlens, tables) -> HmmColumns:
    """Forward + backward column matrices and the total log-likelihood."""
    B, T = tpl.shape
    _, C, R = reads.shape
    me, ie, dp = _padded_tables(tpl, tlen, snr_bin, tables)
    ohm, ohi = _oh_pw(reads, snr_bin, tables)              # [B,C,R,4]
    rl = rlens.astype(jnp.int32)

    def emit_r(ohx, vec4):
        """[B,4] -> [B,C,R+1] with entry i = f_i * vec4[base_i], 0 at i=0."""
        v = contract4(ohx, vec4[:, None, None, :])
        return jnp.concatenate(
            [jnp.zeros_like(v[..., :1]), v], axis=-1)

    e0 = jnp.zeros((B, C, R + 1), jnp.float32).at[..., 0].set(1.0)

    # ---- forward: col_j for j = 0..T (T+1 scan steps) ----
    def fwd_step(carry, j):
        col, ls = carry
        dpj = jnp.where(j > 0, dp[jnp.arange(B), jnp.maximum(j - 1, 0)], 1.0)
        me4 = jnp.where((j > 0), me[jnp.arange(B), jnp.maximum(j - 1, 0)], 0.0)
        ie4 = jnp.where((j < T), ie[jnp.arange(B), jnp.minimum(j, T - 1)], 0.0)
        me_r = emit_r(ohm, me4)
        ie_r = emit_r(ohi, ie4)
        y = dpj[:, None, None] * col + me_r * _shift1(col)
        new = _solve_fwd(y, ie_r)
        s = jnp.maximum(jnp.max(new, axis=-1, keepdims=True), TINY)
        new = new / s
        ls = ls + jnp.log(s[..., 0])
        return (new, ls), (new, ls)

    init = (e0, jnp.zeros((B, C), jnp.float32))
    _, (cols_sc, ls_sc) = jax.lax.scan(fwd_step, init, jnp.arange(T + 1))
    cols = jnp.concatenate([e0[None], cols_sc], axis=0)     # [T+2, B, C, R+1]
    ls_col = jnp.concatenate(
        [jnp.zeros((1, B, C), jnp.float32), ls_sc], axis=0)  # [T+2, B, C]

    # total LL: col_T[rl]  (identity padding ==> boundary T carries the end)
    colT = cols_sc[-1]
    lsT = ls_sc[-1]
    idx = jnp.clip(rl, 0, R)
    final = jnp.take_along_axis(colT, idx[..., None], axis=-1)[..., 0]
    ll = jnp.log(jnp.maximum(final, TINY)) + lsT
    ll = jnp.where(rl < 0, 0.0, ll)

    # ---- backward: u_j for j = T..0 ----
    # Two flavors per boundary: the full sensitivity beta_j (carried through
    # the scan) and the PRE-insertion-solve vector u_j = B_{j+1}^T beta_{j+1}
    # (stored). u_j is the correct pairing for a post-solve forward column:
    # LL = sum_i col_j[i] * u_j[i]. Pairing col_j with the full beta_j would
    # double-count paths that revisit column j through its insertion chain.
    i_idx = jnp.arange(R + 1)[None, None, :]
    betaT = (i_idx == jnp.clip(rl, 0, R)[..., None]).astype(jnp.float32)

    def bwd_step(carry, j):
        beta, ls = carry                                   # beta_{j+1}
        dpj = dp[jnp.arange(B), j]                         # [B]
        me4 = me[jnp.arange(B), j]
        ie4 = ie[jnp.arange(B), j]
        me_r = emit_r(ohm, me4)                            # entry i = me4[r_i]
        # backward uses r_{i+1}: shift left
        me_rs = jnp.concatenate([me_r[..., 1:], jnp.zeros_like(me_r[..., :1])],
                                axis=-1)
        ie_rf = emit_r(ohi, ie4)
        ie_rs = jnp.concatenate([ie_rf[..., 1:], jnp.zeros_like(ie_rf[..., :1])],
                                axis=-1)
        up = jnp.concatenate([beta[..., 1:], jnp.zeros_like(beta[..., :1])],
                             axis=-1)
        u = dpj[:, None, None] * beta + me_rs * up         # u_j (pre-solve)
        su = jnp.maximum(jnp.max(u, axis=-1, keepdims=True), TINY)
        u_out = (u / su, ls + jnp.log(su[..., 0]))
        new = _solve_bwd(u, ie_rs)                         # beta_j (sens.)
        s = jnp.maximum(jnp.max(new, axis=-1, keepdims=True), TINY)
        new = new / s
        ls = ls + jnp.log(s[..., 0])
        return (new, ls), u_out

    init_b = (betaT, jnp.zeros((B, C), jnp.float32))
    _, (betas_sc, lsb_sc) = jax.lax.scan(
        bwd_step, init_b, jnp.arange(T - 1, -1, -1))
    # betas_sc[k] = u_{T-1-k}; assemble u_0..u_{T-1}, u_T = e_rl
    betas = jnp.concatenate([betas_sc[::-1], betaT[None]], axis=0)  # [T+1,...]
    ls_beta = jnp.concatenate(
        [lsb_sc[::-1], jnp.zeros((1, B, C), jnp.float32)], axis=0)

    return HmmColumns(
        cols=jnp.moveaxis(cols, 0, 2),
        ls_col=jnp.moveaxis(ls_col, 0, 2),
        betas=jnp.moveaxis(betas, 0, 2),
        ls_beta=jnp.moveaxis(ls_beta, 0, 2),
        ll=ll,
    )


def _ctx_params(prev, cur, snr_bin, tables):
    """Arrow params for arbitrary (prev, cur) base pairs.

    prev, cur: int32 [...], snr_bin broadcastable. Returns (me4, ie4, dp)
    with trailing 4-axis on me4/ie4; mirrors hmm_jax.position_tables.
    """
    ctx = 4 * jnp.clip(prev, 0, 3) + jnp.clip(cur, 0, 3)
    trans = tables["trans"][snr_bin, ctx]                   # [..., 4]
    em = tables["emit_match"][snr_bin, ctx]
    es = tables["emit_stick"][snr_bin, ctx]
    onehot = jax.nn.one_hot(jnp.clip(cur, 0, 3), 4, dtype=trans.dtype)
    me4 = trans[..., 0:1] * em
    ie4 = trans[..., 1:2] * onehot + trans[..., 2:3] * es
    return me4, ie4, trans[..., 3]


def mutation_ops_at(tpl, tlen, snr_bin, tables, posb, kindb):
    """Bridge operators for an arbitrary mutation set (position, kind).

    posb/kindb: int32 [B, P] — per-row template position and mutation kind
    (0-2 substitution (tpl[pos]+1+kind)%4, 3 deletion, 4-7 insert base
    kind-4 after pos). Returns (me4 [B,P,3,4], ie4 [B,P,3,4], dp [B,P,3],
    start [B,P], qidx [B,P]) where the three operators map col_{start-1}
    (cols array index ``start``) to the boundary scored against
    beta_{qidx}. The candidate-filtered polish loop (C7,
    /root/reference/docs/faq/performance.md:90-93) scores only gathered
    candidate positions through this.
    """
    B, T = tpl.shape
    me_o, ie_o, dp_o = _padded_tables(tpl, tlen, snr_bin, tables)

    bi = jnp.arange(B)[:, None]
    kind = kindb.astype(jnp.int32)
    posb = posb.astype(jnp.int32)
    t_at = lambda i: tpl[bi, jnp.clip(i, 0, T - 1)].astype(jnp.int32)  # noqa: E731
    tl = tlen[:, None]
    sb = snr_bin[:, None]

    t_p = t_at(posb)
    t_prev = jnp.where(posb > 0, t_at(posb - 1), -1)       # -1: use cur as prev
    t_next = t_at(posb + 1)
    has_next = (posb + 1) < tl

    is_sub = kind <= 2
    is_del = kind == 3
    is_ins = kind >= 4
    x = jnp.where(is_sub, (t_p + 1 + kind) % 4, kind - 4)

    zero4 = jnp.zeros((B, posb.shape[1], 4), jnp.float32)

    def P(prev, cur):
        prev = jnp.where(prev < 0, cur, prev)
        return _ctx_params(prev, cur, sb, tables)

    # original per-position params, gathered with identity fallback
    def orig_me_dp(p):
        ok = (p >= 0) & (p < tl)
        pc = jnp.clip(p, 0, T - 1)
        me = jnp.where(ok[..., None], me_o[bi, pc], 0.0)
        dp = jnp.where(ok, dp_o[bi, pc], 1.0)
        return me, dp

    def orig_ie(p):
        ok = (p >= 0) & (p < tl)
        pc = jnp.clip(p, 0, T - 1)
        return jnp.where(ok[..., None], ie_o[bi, pc], 0.0)

    # --- substitution ops (cur base at pos becomes x) ---
    me_px, ie_px, dp_px = P(t_prev, x)                     # new pos p params
    me_xn, ie_xn, dp_xn = P(x, t_next)                     # new pos p+1 params
    hn4 = has_next[..., None]
    me_pm1, dp_pm1 = orig_me_dp(posb - 1)
    sub_ops = (
        (me_pm1, ie_px, dp_pm1),
        (me_px, jnp.where(hn4, ie_xn, 0.0), dp_px),
        (jnp.where(hn4, me_xn, 0.0), orig_ie(posb + 2),
         jnp.where(has_next, dp_xn, 1.0)),
    )

    # --- deletion ops (pos removed; new pos p = old p+1 with new prev) ---
    me_dn, ie_dn, dp_dn = P(t_prev, t_next)                # old p+1, new ctx
    del_ops = (
        (me_pm1, jnp.where(hn4, ie_dn, 0.0), dp_pm1),
        (jnp.where(hn4, me_dn, 0.0), orig_ie(posb + 2),
         jnp.where(has_next, dp_dn, 1.0)),
        (zero4, zero4, jnp.ones_like(dp_pm1)),
    )

    # --- insertion-after ops (x between pos and pos+1) ---
    me_tx, ie_tx, dp_tx = P(t_p, x)                        # new base x params
    me_p, dp_p = orig_me_dp(posb)
    ins_ops = (
        (me_p, ie_tx, dp_p),
        (me_tx, jnp.where(hn4, ie_xn, 0.0), dp_tx),
        (jnp.where(hn4, me_xn, 0.0), orig_ie(posb + 2),
         jnp.where(has_next, dp_xn, 1.0)),
    )

    def pick(o):
        su, de, im = sub_ops[o], del_ops[o], ins_ops[o]
        me4 = jnp.where(is_sub[..., None], su[0],
                        jnp.where(is_del[..., None], de[0], im[0]))
        ie4 = jnp.where(is_sub[..., None], su[1],
                        jnp.where(is_del[..., None], de[1], im[1]))
        dp = jnp.where(is_sub, su[2], jnp.where(is_del, de[2], im[2]))
        return me4, ie4, dp

    ops = [pick(o) for o in range(3)]
    start = jnp.where(is_ins, posb + 1, posb)              # cols array index
    qidx = jnp.minimum(posb + 2, tlen[:, None])            # beta index
    me4 = jnp.stack([o[0] for o in ops], axis=2)           # [B,P,3,4]
    ie4 = jnp.stack([o[1] for o in ops], axis=2)
    dp4 = jnp.stack([o[2] for o in ops], axis=2)           # [B,P,3]
    return me4, ie4, dp4, start.astype(jnp.int32), qidx.astype(jnp.int32)


def prepend_ops(tpl, tlen, snr_bin, tables):
    """Bridge operators for the 4 prepend mutations (base b before index 0).

    Returns (me4 [B,4,3,4], ie4 [B,4,3,4], dp [B,4,3], start [B,4],
    qidx [B,4]).
    """
    B, T = tpl.shape
    bi = jnp.arange(B)[:, None]

    def orig_ie(p):
        me_o, ie_o, dp_o = _padded_tables(tpl, tlen, snr_bin, tables)
        tl = tlen[:, None]
        ok = (p >= 0) & (p < tl)
        pc = jnp.clip(p, 0, T - 1)
        return jnp.where(ok[..., None], ie_o[bi, pc], 0.0)

    # --- prepend mutations (4): new base x0 at index 0 ---
    x0 = jnp.arange(4, dtype=jnp.int32)[None, :]           # [1,4] -> [B,4]
    x0 = jnp.broadcast_to(x0, (B, 4))
    sb4 = snr_bin[:, None]
    t0 = jnp.broadcast_to(tpl[:, 0].astype(jnp.int32)[:, None], (B, 4))
    me_xx, ie_xx, dp_xx = _ctx_params(x0, x0, sb4, tables)
    me_x0, ie_x0, dp_x0 = _ctx_params(x0, t0, sb4, tables)
    one4 = jnp.ones((B, 4), jnp.float32)
    z44 = jnp.zeros((B, 4, 4), jnp.float32)
    pre_ops = [
        (z44, ie_xx, one4),
        (me_xx, ie_x0, dp_xx),
        (me_x0, jnp.broadcast_to(orig_ie(jnp.ones((B, 1), jnp.int32)),
                                 (B, 4, 4)), dp_x0),
    ]
    pre_start = jnp.zeros((B, 4), jnp.int32)
    pre_q = jnp.minimum(jnp.ones((B, 4), jnp.int32), tlen[:, None])
    me4 = jnp.stack([o[0] for o in pre_ops], axis=2)       # [B,4,3,4]
    ie4 = jnp.stack([o[1] for o in pre_ops], axis=2)
    dp4 = jnp.stack([o[2] for o in pre_ops], axis=2)       # [B,4,3]
    return me4, ie4, dp4, pre_start, pre_q


def mutation_ops(tpl, tlen, snr_bin, tables):
    """Bridge operators for every mutant of make_mutants' enumeration.

    Returns (me4 [B,M,3,4], ie4 [B,M,3,4], dp [B,M,3], start [B,M],
    qidx [B,M]). Enumeration matches pipeline.polish.make_mutants:
    m < 8T — pos=m//8, kind=m%8; m >= 8T — prepend base m-8T.
    """
    B, T = tpl.shape
    m = jnp.arange(MUTS_PER_POS * T)
    posb = jnp.broadcast_to((m // MUTS_PER_POS)[None], (B, m.shape[0]))
    kindb = jnp.broadcast_to((m % MUTS_PER_POS)[None], (B, m.shape[0]))
    reg = mutation_ops_at(tpl, tlen, snr_bin, tables, posb, kindb)
    pre = prepend_ops(tpl, tlen, snr_bin, tables)
    return tuple(jnp.concatenate([r, p], axis=1) for r, p in zip(reg, pre))


def bridge_scores(reads, rlens, snr_bin, tables, columns: HmmColumns, ops,
                  m_chunk: int = 28):
    """Summed-over-subreads LL of each mutation in ``ops`` via column
    bridging: [B, M]. ``ops`` = (me4, ie4, dp4, start, qidx) from
    mutation_ops / mutation_ops_at / prepend_ops (concatenable on axis 1)."""
    me4, ie4, dp4, start, qidx = ops
    B, M = start.shape
    _, C, R = reads.shape
    ohm, ohi = _oh_pw(reads, snr_bin, tables)              # [B,C,R,4]
    rl = rlens.astype(jnp.int32)

    n_chunks = -(-M // m_chunk)
    Mp = n_chunks * m_chunk
    if Mp != M:
        padm = Mp - M
        me4 = jnp.pad(me4, ((0, 0), (0, padm), (0, 0), (0, 0)))
        ie4 = jnp.pad(ie4, ((0, 0), (0, padm), (0, 0), (0, 0)))
        dp4 = jnp.pad(dp4, ((0, 0), (0, padm), (0, 0)), constant_values=1.0)
        start = jnp.pad(start, ((0, 0), (0, padm)))
        qidx = jnp.pad(qidx, ((0, 0), (0, padm)))

    def chunk(args):
        me_c, ie_c, dp_c, s_c, q_c = args                  # [B,mc,...]
        mc = s_c.shape[1]
        # v: starting column per mutant  [B,C,mc,R+1]
        sidx = jnp.broadcast_to(s_c[:, None, :, None], (B, C, mc, R + 1))
        v = jnp.take_along_axis(columns.cols, sidx, axis=2)
        ls_v = jnp.take_along_axis(
            columns.ls_col, jnp.broadcast_to(s_c[:, None], (B, C, mc)), axis=2)
        for o in range(3):
            # per-read emission rows: [B,C,mc,R] then pad i=0
            me_r = contract4(ohm[:, :, None], me_c[:, None, :, o, None])
            ie_r = contract4(ohi[:, :, None], ie_c[:, None, :, o, None])
            z = jnp.zeros_like(me_r[..., :1])
            me_r = jnp.concatenate([z, me_r], axis=-1)
            ie_r = jnp.concatenate([z, ie_r], axis=-1)
            y = dp_c[:, None, :, o, None] * v + me_r * _shift1(v)
            v = _solve_fwd(y, ie_r)
        qix = jnp.broadcast_to(q_c[:, None, :, None], (B, C, mc, R + 1))
        beta = jnp.take_along_axis(columns.betas, qix, axis=2)
        ls_b = jnp.take_along_axis(
            columns.ls_beta, jnp.broadcast_to(q_c[:, None], (B, C, mc)), axis=2)
        dot = jnp.sum(v * beta, axis=-1)
        ll = jnp.log(jnp.maximum(dot, TINY)) + ls_v + ls_b  # [B,C,mc]
        ll = jnp.where((rl >= 0)[:, :, None], ll, 0.0)
        return ll.sum(axis=1)                               # [B,mc]

    resh = lambda a: jnp.moveaxis(  # noqa: E731
        a.reshape((B, n_chunks, m_chunk) + a.shape[2:]), 1, 0)
    lls = jax.lax.map(chunk, (resh(me4), resh(ie4), resh(dp4),
                              resh(start), resh(qidx)))     # [nc,B,mc]
    return jnp.moveaxis(lls, 0, 1).reshape(B, Mp)[:, :M]


@functools.partial(jax.jit, static_argnames=("m_chunk",))
def score_mutants_cols(tpl, tlen, snr_bin, reads, rlens, tables,
                       columns: HmmColumns, valid, m_chunk: int = 28):
    """Summed-over-subreads LL of every mutant via column bridging: [B, M].

    Matches pipeline.polish.score_mutants to ~1e-3 (fp-order + the scan
    path's depth-8 delete truncation).
    """
    ops = mutation_ops(tpl, tlen, snr_bin, tables)
    lls = bridge_scores(reads, rlens, snr_bin, tables, columns, ops,
                        m_chunk=m_chunk)
    return jnp.where(valid, lls, NEG)
