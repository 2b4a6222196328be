"""Tests for the fused exhaustive polish path (pipeline.polish_fused over
ops.hmm_cols): enumeration correctness vs brute-force forwards, sparse vs
dense scoring, loop equivalence with the round-1 dense loop, and
multi-apply bookkeeping."""

import numpy as np
import jax.numpy as jnp

from ccs_tpu.models.chemistry import default_params
from ccs_tpu.ops.hmm_jax import _forward_batch_scan, params_to_device
from ccs_tpu.pipeline.polish import apply_mutation, polish_windows
from ccs_tpu.pipeline.polish_fused import (KINDS, apply_mutations,
                                           polish_windows_fused,
                                           score_all_xla, select_mutations)
from ccs_tpu.sim.simulator import simulate_read

PARAMS = default_params()
TABLES = params_to_device(PARAMS)


def _simulate_batch(rng, B, C, t_cap, r_cap, tl_range=(12, 22), n_err=(0, 3)):
    tpl = np.full((B, t_cap), -1, np.int8)
    tlen = np.zeros(B, np.int32)
    reads = np.full((B, C, r_cap), -1, np.int8)
    rlens = np.full((B, C), -1, np.int32)
    snr = rng.integers(0, 8, B).astype(np.int32)
    true = []
    for b in range(B):
        tl = int(rng.integers(*tl_range))
        t = rng.integers(0, 4, tl).astype(np.int8)
        true.append(t)
        corrupt = t.copy()
        for _ in range(int(rng.integers(*n_err))):
            p = int(rng.integers(0, tl))
            corrupt[p] = (corrupt[p] + 1) % 4
        tpl[b, :tl] = corrupt
        tlen[b] = tl
        for c in range(C):
            r = simulate_read(t, PARAMS, int(snr[b]), rng)[:r_cap]
            reads[b, c, :len(r)] = r
            rlens[b, c] = len(r)
    return ([jnp.asarray(x) for x in (tpl, tlen, snr, reads, rlens)], true)


def _apply_new_enum(t0, p, k):
    """NumPy application of the 9-kind enumeration."""
    if k <= 3:
        mt = t0.copy()
        mt[p] = k
        return mt
    if k == 4:
        return np.delete(t0, p)
    return np.insert(t0, p + 1, k - 5)


def test_score_all_xla_matches_bruteforce():
    rng = np.random.default_rng(0)
    (args, _) = _simulate_batch(rng, 6, 4, 24, 32)
    tpl, tlen, snr, reads, rlens = args
    lls, ll0 = score_all_xla(tpl, tlen, snr, reads, rlens, TABLES)
    ll_direct = _forward_batch_scan(tpl, tlen, snr, reads, rlens,
                                    TABLES).sum(-1)
    np.testing.assert_allclose(np.asarray(ll0), np.asarray(ll_direct),
                               atol=2e-3)
    tpl_np = np.asarray(tpl)
    tlen_np = np.asarray(tlen)
    checked = 0
    for _ in range(40):
        b = int(rng.integers(0, tpl_np.shape[0]))
        p = int(rng.integers(0, tlen_np[b]))
        k = int(rng.integers(0, KINDS))
        t0 = tpl_np[b, :tlen_np[b]]
        if k <= 3 and k == t0[p]:
            continue  # invalid no-op slot
        if k == 4 and tlen_np[b] <= 1:
            continue
        mt = _apply_new_enum(t0, p, k)
        if len(mt) > tpl_np.shape[1]:
            continue
        mt_pad = np.full((1, tpl_np.shape[1]), -1, np.int8)
        mt_pad[0, :len(mt)] = mt
        ref = _forward_batch_scan(
            jnp.asarray(mt_pad), jnp.asarray([len(mt)], np.int32),
            snr[b:b + 1], reads[b:b + 1], rlens[b:b + 1], TABLES).sum(-1)
        got = float(lls[b, KINDS * p + k])
        assert abs(float(ref[0]) - got) < 5e-3, (b, p, k)
        checked += 1
    assert checked > 20


def test_prepend_scores_match_bruteforce():
    rng = np.random.default_rng(1)
    (args, _) = _simulate_batch(rng, 4, 3, 20, 28, tl_range=(5, 15))
    tpl, tlen, snr, reads, rlens = args
    lls, _ = score_all_xla(tpl, tlen, snr, reads, rlens, TABLES)
    tpl_np, tlen_np = np.asarray(tpl), np.asarray(tlen)
    T = tpl_np.shape[1]
    for b in range(tpl_np.shape[0]):
        for x in range(4):
            mt = np.insert(tpl_np[b, :tlen_np[b]], 0, x)
            mt_pad = np.full((1, T), -1, np.int8)
            mt_pad[0, :len(mt)] = mt
            ref = _forward_batch_scan(
                jnp.asarray(mt_pad), jnp.asarray([len(mt)], np.int32),
                snr[b:b + 1], reads[b:b + 1], rlens[b:b + 1], TABLES).sum(-1)
            got = float(lls[b, KINDS * T + x])
            assert abs(float(ref[0]) - got) < 5e-3, (b, x)


def test_fused_loop_matches_dense_loop():
    rng = np.random.default_rng(3)
    (args, true) = _simulate_batch(rng, 10, 8, 28, 36, tl_range=(16, 23))
    tpl, tlen, snr, reads, rlens = args
    cs = jnp.full(tpl.shape[0], 2, jnp.int32)
    ce = tlen - 2
    st_old, qv_old, _ = polish_windows(tpl, tlen, cs, ce, snr, reads, rlens,
                                       TABLES, max_iters=20, scoring="cols",
                                       heuristics=False)
    st_new, qv_new, _ = polish_windows_fused(tpl, tlen, cs, ce, snr, reads,
                                             rlens, TABLES, max_iters=20)
    assert not bool(np.asarray(st_new.active).any())
    same = 0
    for b in range(tpl.shape[0]):
        a = np.asarray(st_old.tpl[b][:int(st_old.tlen[b])])
        c = np.asarray(st_new.tpl[b][:int(st_new.tlen[b])])
        same += int(len(a) == len(c) and np.all(a == c))
    assert same >= tpl.shape[0] - 1  # rare tie-order differences allowed
    # (QVs are NOT compared: the fused path prices equivalence classes of
    # mutations once and includes insertion mass — the calibrated product
    # semantics, covered by TestEngine.test_qv_calibration — while the
    # oracle keeps the naive per-operation QV.)


def test_multi_apply_matches_sequential_singles():
    """One multi-apply of spaced edits == the same edits applied one at a
    time through the round-1 apply_mutation (template AND core offsets)."""
    rng = np.random.default_rng(4)
    T = 24
    tpl = rng.integers(0, 4, (1, T)).astype(np.int8)
    tlen = np.array([20], np.int32)
    tpl[0, 20:] = -1
    cs = np.array([3], np.int32)
    ce = np.array([17], np.int32)
    # edits: sub base 2 at 4, del at 9, ins base 1 after 14 (all >=3 apart)
    sel = np.zeros((1, T), bool)
    pkind = np.zeros((1, T), np.int32)
    sel[0, 4] = True
    pkind[0, 4] = 2 if tpl[0, 4] != 2 else 3
    sel[0, 9] = True
    pkind[0, 9] = 4
    sel[0, 14] = True
    pkind[0, 14] = 6
    out, nlen, ncs, nce, _, improved = apply_mutations(
        jnp.asarray(tpl), jnp.asarray(tlen), jnp.asarray(cs),
        jnp.asarray(ce), None, jnp.asarray(sel), jnp.asarray(pkind),
        jnp.zeros(1, bool), jnp.zeros(1, jnp.int32), jnp.zeros(1, bool))
    assert bool(improved[0])
    # sequential reference: right-to-left so earlier coordinates stay valid
    t, tl, c0, c1 = jnp.asarray(tpl), jnp.asarray(tlen), jnp.asarray(
        cs), jnp.asarray(ce)
    sub_base = int(pkind[0, 4])
    rel = (sub_base - int(tpl[0, 4]) - 1) % 4      # old rel-sub convention
    for pos, old_kind in ((14, 4 + 1), (9, 3), (4, rel)):
        mut_id = jnp.asarray([pos * 8 + old_kind])
        t, tl, c0, c1 = apply_mutation(t, tl, c0, c1, mut_id)
    assert int(nlen[0]) == int(tl[0])
    np.testing.assert_array_equal(np.asarray(out[0, :int(nlen[0])]),
                                  np.asarray(t[0, :int(tl[0])]))
    assert int(ncs[0]) == int(c0[0])
    assert int(nce[0]) == int(c1[0])


def test_selection_spacing():
    """Selected mutations are always >= 3 positions apart."""
    rng = np.random.default_rng(5)
    B, T = 32, 30
    lls = jnp.asarray(rng.normal(0, 5, (B, KINDS * T + 4)).astype(np.float32))
    ll = jnp.zeros(B, jnp.float32)
    sel, _, pre_sel, _, _ = select_mutations(lls, ll, None, T)
    sel_np = np.asarray(sel)
    for b in range(B):
        js = np.nonzero(sel_np[b])[0]
        assert np.all(np.diff(js) >= 3), js
        if bool(pre_sel[b]):
            assert not sel_np[b, :3].any()


def test_fused_loop_recovers_template():
    rng = np.random.default_rng(6)
    (args, true) = _simulate_batch(rng, 8, 10, 26, 36, tl_range=(15, 21),
                                   n_err=(1, 3))
    tpl, tlen, snr, reads, rlens = args
    cs = jnp.zeros(tpl.shape[0], jnp.int32)
    ce = tlen
    st, qv, _ = polish_windows_fused(tpl, tlen, cs, ce, snr, reads, rlens,
                                     TABLES, max_iters=25)
    ok = 0
    for b, t in enumerate(true):
        got = np.asarray(st.tpl[b][:int(st.tlen[b])])
        ok += int(len(got) == len(t) and np.all(got == t))
    assert ok >= len(true) - 1
    assert not bool(np.asarray(st.active).any())


def test_sparse_scoring_matches_dense_at_flagged_slots():
    """Candidate-sparse scoring (C7) on the XLA scorer: flagged positions
    (and the prepends) carry exactly the dense scores, every other
    per-position slot is NEG, and ll0 is the dense ll0."""
    from ccs_tpu.pipeline.polish_fused import NEG, score_all
    rng = np.random.default_rng(7)
    (args, _) = _simulate_batch(rng, 5, 3, 18, 24, tl_range=(3, 15))
    tpl, tlen, snr, reads, rlens = args
    T = tpl.shape[1]
    cand = rng.random(tpl.shape) < 0.5
    lls_d, ll0_d = score_all(tpl, tlen, snr, reads, rlens, TABLES)
    lls_s, ll0_s = score_all(tpl, tlen, snr, reads, rlens, TABLES,
                             cand=jnp.asarray(cand))
    lls_d, lls_s = np.asarray(lls_d), np.asarray(lls_s)
    np.testing.assert_array_equal(np.asarray(ll0_s), np.asarray(ll0_d))
    flagged = np.concatenate([np.repeat(cand, KINDS, axis=1),
                              np.ones((cand.shape[0], 4), bool)], axis=1)
    np.testing.assert_array_equal(lls_s[flagged], lls_d[flagged])
    assert np.all(lls_s[~flagged] == NEG)
    assert (lls_s[:, :KINDS * T] > NEG / 2).sum() < (
        lls_d[:, :KINDS * T] > NEG / 2).sum()


def test_score_all_xla_production_width_matches_bruteforce():
    """The scorer at the engine's production caps (template 44, read 39)
    against a brute-force forward pass of each mutated template."""
    rng = np.random.default_rng(12)
    (args, _) = _simulate_batch(rng, 3, 4, 44, 39, tl_range=(26, 33))
    tpl, tlen, snr, reads, rlens = args
    lls, ll0 = score_all_xla(tpl, tlen, snr, reads, rlens, TABLES)
    ll_direct = _forward_batch_scan(tpl, tlen, snr, reads, rlens,
                                    TABLES).sum(-1)
    np.testing.assert_allclose(np.asarray(ll0), np.asarray(ll_direct),
                               atol=2e-3)
    tpl_np, tlen_np, lls_np = np.asarray(tpl), np.asarray(tlen), \
        np.asarray(lls)
    T = tpl_np.shape[1]
    rows, muts, mlen = [], [], []
    for b in range(tpl_np.shape[0]):
        t0 = tpl_np[b, :tlen_np[b]]
        for m in rng.choice(KINDS * T, 60, replace=False):
            if lls_np[b, m] < -1e29:
                continue                      # invalid slot
            p, k = divmod(int(m), KINDS)
            mt = _apply_new_enum(t0, p, k)
            pad = np.full(T, -1, np.int8)
            pad[:len(mt)] = mt
            rows.append((b, int(m)))
            muts.append(pad)
            mlen.append(len(mt))
    bi = np.asarray([b for b, _ in rows])
    ref = np.asarray(_forward_batch_scan(
        jnp.asarray(np.stack(muts)), jnp.asarray(mlen, np.int32),
        snr[bi], reads[bi], rlens[bi], TABLES).sum(-1))
    got = np.asarray([lls_np[b, m] for b, m in rows])
    assert len(rows) > 60
    assert np.abs(ref - got).max() < 5e-3
