"""Batched Arrow pair-HMM forward pass in JAX (the device compute path).

Batched design (SURVEY.md §7 hard-part 1): thousands of (window, subread)
lanes run the same small DP in lock-step. The scan is over read positions;
within a read row the template axis is fully vectorized — the delete chain
(``alpha[i,j]`` depends on ``alpha[i,j-1]``) is a first-order linear
recurrence solved exactly with ``jax.lax.associative_scan`` in log2(T) steps.

Arithmetic is scaled-probability f32 (per-row renormalization with an
accumulated log scale), which keeps the inner loop on cheap elementwise ops
instead of transcendental-heavy log-sum-exp. Validated against the log-space NumPy oracle
(tests/test_hmm.py).

Shapes (static; host batcher pads):
  tpl      [B, T]      int8 template codes (PAD beyond tlen)
  tlen     [B]         int32
  reads    [B, C, R]   int8 read codes (PAD beyond rlen)
  rlens    [B, C]      int32 (<=0 marks an absent lane)
  -> ll    [B, C]      f32 log P(read | tpl); 0 for absent lanes
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ccs_tpu.models.chemistry import ArrowParams

NEG_INF = -1e30
TINY = 1e-30


def params_to_device(params: ArrowParams) -> dict[str, jnp.ndarray]:
    """Replicated device copies of the parameter tables."""
    return {
        "trans": jnp.asarray(params.trans, dtype=jnp.float32),
        "emit_match": jnp.asarray(params.emit_match, dtype=jnp.float32),
        "emit_stick": jnp.asarray(params.emit_stick, dtype=jnp.float32),
        "snr_edges": jnp.asarray(params.snr_edges, dtype=jnp.float32),
        "pw_match": jnp.asarray(params.pw_match, dtype=jnp.float32),
        "pw_ins": jnp.asarray(params.pw_ins, dtype=jnp.float32),
    }


def decode_reads(reads: jnp.ndarray):
    """Split packed read codes (chemistry.pack_read_pw) into base codes and
    pw bins; pads (< 0) keep base/pw 0 — callers mask by rlens."""
    c = jnp.clip(reads.astype(jnp.int32), 0, 15)
    return c % 4, c // 4


def position_tables(tpl: jnp.ndarray, snr_bin: jnp.ndarray, tables: dict):
    """Vectorized per-position probability tables.

    tpl [..., T] int8, snr_bin [...] int32 (broadcast over positions)
    -> match_emit [..., T, 4], ins_emit [..., T, 4], del_p [..., T]
    Mirrors ccs_tpu.ops.hmm_oracle.position_tables.
    """
    t = jnp.clip(tpl, 0, 3).astype(jnp.int32)
    prev = jnp.concatenate([t[..., :1], t[..., :-1]], axis=-1)
    ctx = 4 * prev + t
    b = snr_bin[..., None]
    trans = tables["trans"][b, ctx]            # [..., T, 4]
    em = tables["emit_match"][b, ctx]          # [..., T, 4]
    es = tables["emit_stick"][b, ctx]          # [..., T, 4]
    onehot = jax.nn.one_hot(t, 4, dtype=trans.dtype)
    match_emit = trans[..., 0:1] * em
    ins_emit = trans[..., 1:2] * onehot + trans[..., 2:3] * es
    del_p = trans[..., 3]
    # zero out padded positions
    valid = (tpl >= 0)[..., None]
    return (jnp.where(valid, match_emit, 0.0),
            jnp.where(valid, ins_emit, 0.0),
            jnp.where(valid[..., 0], del_p, 0.0))


DELETE_CHAIN_DEPTH = 8  # max modeled run of consecutive deletions per row


def _linrec_scan(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve x[j] = a[j] * x[j-1] + b[j] (x[-1]=0) along the last axis.

    Expanded to depth ``DELETE_CHAIN_DEPTH``: x[j] = sum_d b[j-d] *
    prod(a[j-d+1..j]). Deletion probabilities are <~0.1, so truncating runs
    beyond 8 changes the likelihood by <1e-8 relative — far below the f32
    noise floor — while lowering to a handful of shifted FMAs instead of an
    associative-scan tree (large XLA-CPU compile-time win)."""
    x = b
    coef = a
    for d in range(1, DELETE_CHAIN_DEPTH + 1):
        # shift b right by d along the last axis, weight by running product
        shifted = jnp.concatenate(
            [jnp.zeros_like(b[..., :d]), b[..., :-d]], axis=-1)
        x = x + coef * shifted
        if d < DELETE_CHAIN_DEPTH:
            a_shift = jnp.concatenate(
                [jnp.zeros_like(a[..., :d]), a[..., :-d]], axis=-1)
            coef = coef * a_shift
    return x


def forward_batch(tpl: jnp.ndarray, tlen: jnp.ndarray, snr_bin: jnp.ndarray,
                  reads: jnp.ndarray, rlens: jnp.ndarray,
                  tables: dict) -> jnp.ndarray:
    """Batched forward log-likelihoods; see module docstring for shapes.

    Scan formulation — the plain float32 reference behind pipeline.polish
    and the brute-force check of the product scorer (the alpha/beta column
    bridge of ops.hmm_cols, which scores the template AND all its
    mutations in one call).
    """
    return _forward_batch_scan(tpl, tlen, snr_bin, reads, rlens, tables)


def _forward_batch_scan(tpl: jnp.ndarray, tlen: jnp.ndarray,
                        snr_bin: jnp.ndarray, reads: jnp.ndarray,
                        rlens: jnp.ndarray, tables: dict) -> jnp.ndarray:
    B, T = tpl.shape
    _, C, R = reads.shape

    match_emit, ins_emit, del_p = position_tables(tpl, snr_bin, tables)
    # Broadcast per-window tables across the C subread lanes -> flat L lanes.
    L = B * C
    me = jnp.broadcast_to(match_emit[:, None], (B, C, T, 4)).reshape(L, T, 4)
    ie = jnp.broadcast_to(ins_emit[:, None], (B, C, T, 4)).reshape(L, T, 4)
    dp = jnp.broadcast_to(del_p[:, None], (B, C, T)).reshape(L, T)
    tl = jnp.broadcast_to(tlen[:, None], (B, C)).reshape(L)
    rd = reads.reshape(L, R)
    rl = rlens.reshape(L)
    # per-lane pulse-width factor LUTs (bin 0 = unknown, factor 1)
    gm = jnp.broadcast_to(tables["pw_match"][snr_bin][:, None],
                          (B, C, 4)).reshape(L, 4)
    gi = jnp.broadcast_to(tables["pw_ins"][snr_bin][:, None],
                          (B, C, 4)).reshape(L, 4)

    # ins_emit must be 0 at j == tlen (no insertions past the end); padded
    # positions are already 0. del chain past tlen is 0 as well.
    jpos = jnp.arange(T)[None, :]
    ie = jnp.where((jpos < tl[:, None])[..., None], ie, 0.0)
    dp = jnp.where(jpos < tl[:, None], dp, 0.0)

    # alpha over template axis 0..T (T+1 entries per lane)
    # row 0: delete chain from origin
    alpha0 = jnp.concatenate(
        [jnp.ones((L, 1), jnp.float32),
         jnp.cumprod(dp, axis=-1)], axis=-1)  # [L, T+1]

    def step(carry, i):
        alpha, log_scale, ll = carry
        code = jnp.clip(rd[:, i].astype(jnp.int32), 0, 15)  # [L]
        bc = code % 4
        w = code // 4
        fm = jnp.take_along_axis(gm, w[:, None], axis=-1)   # [L, 1] pw factor
        fi = jnp.take_along_axis(gi, w[:, None], axis=-1)
        me_i = jnp.take_along_axis(me, bc[:, None, None], axis=-1)[..., 0] * fm
        ie_i = jnp.take_along_axis(ie, bc[:, None, None], axis=-1)[..., 0] * fi
        # diag + vertical contributions into positions 0..T
        diag = alpha[:, :-1] * me_i                  # into j = 1..T
        vert = jnp.concatenate(
            [alpha[:, :-1] * ie_i, jnp.zeros((L, 1), jnp.float32)], axis=-1)
        base = vert.at[:, 1:].add(diag)              # [L, T+1]
        # delete chain within the row: x[j] = dp[j-1]*x[j-1] + base[j]
        a = jnp.concatenate([jnp.zeros((L, 1), jnp.float32), dp], axis=-1)
        new_alpha = _linrec_scan(a, base)
        # renormalize
        scale = jnp.maximum(jnp.max(new_alpha, axis=-1, keepdims=True), TINY)
        new_alpha = new_alpha / scale
        new_log = log_scale + jnp.log(scale[:, 0])
        # lanes whose read ends at i+1 record their final LL
        active = i < rl
        alpha = jnp.where(active[:, None], new_alpha, alpha)
        log_scale = jnp.where(active, new_log, log_scale)
        done_now = (i + 1) == rl
        final = jnp.take_along_axis(alpha, tl[:, None], axis=-1)[:, 0]
        ll = jnp.where(done_now,
                       jnp.log(jnp.maximum(final, TINY)) + log_scale, ll)
        return (alpha, log_scale, ll), None

    # rl == 0 lanes: LL from row 0 directly
    final0 = jnp.take_along_axis(alpha0, tl[:, None], axis=-1)[:, 0]
    ll0 = jnp.where(rl == 0, jnp.log(jnp.maximum(final0, TINY)), 0.0)
    init = (alpha0, jnp.zeros(L, jnp.float32), ll0)
    (alpha, log_scale, ll), _ = jax.lax.scan(step, init, jnp.arange(R))
    ll = jnp.where(rl < 0, 0.0, ll)
    return ll.reshape(B, C)


def snr_bin_for(snr_mean: jnp.ndarray, tables: dict) -> jnp.ndarray:
    """Device-side SNR binning matching ArrowParams.snr_bin."""
    return jnp.searchsorted(tables["snr_edges"], snr_mean).astype(jnp.int32)
