"""Column-bridged mutation scoring (ops.hmm_cols) vs the dense oracle.

The bridged scorer re-derives only the 3 column operators a point mutation
touches (how-does-ccs-work.md:96-101: per-candidate LL over all subreads),
so it must agree with pipeline.polish.score_mutants — which re-runs a full
forward pass per mutant — to fp tolerance, and produce identical polish
trajectories.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ccs_tpu.models.chemistry import default_params
from ccs_tpu.ops import hmm_jax
from ccs_tpu.ops.hmm_cols import build_columns, score_mutants_cols
from ccs_tpu.pipeline import polish
from ccs_tpu.sim.simulator import simulate_read


@pytest.fixture(scope="module")
def params():
    return default_params()


@pytest.fixture(scope="module")
def tables(params):
    return hmm_jax.params_to_device(params)


def _batch(params, rng, B=4, T_CAP=24, R_CAP=36, C=5, tmin=8, tmax=18):
    tpl = np.full((B, T_CAP), -1, np.int8)
    tlen = np.zeros(B, np.int32)
    reads = np.full((B, C, R_CAP), -1, np.int8)
    rlens = np.full((B, C), -1, np.int32)
    for b in range(B):
        tl = int(rng.integers(tmin, tmax + 1))
        t = rng.integers(0, 4, tl).astype(np.int8)
        tpl[b, :tl] = t
        tlen[b] = tl
        ncov = int(rng.integers(1, C + 1))
        for c in range(ncov):
            r = simulate_read(t, params, 4, rng)[:R_CAP]
            reads[b, c, :len(r)] = r
            rlens[b, c] = len(r)
    return tuple(jnp.asarray(x) for x in (tpl, tlen, reads, rlens))


class TestColumns:
    def test_total_ll_matches_forward(self, params, tables):
        rng = np.random.default_rng(11)
        tpl, tlen, reads, rlens = _batch(params, rng)
        snr = jnp.full(tpl.shape[0], 4, jnp.int32)
        cols = build_columns(tpl, tlen, snr, reads, rlens, tables)
        ref = hmm_jax.forward_batch(tpl, tlen, snr, reads, rlens, tables)
        np.testing.assert_allclose(np.asarray(cols.ll), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)

    def test_bridged_scores_match_dense(self, params, tables):
        """Every mutant LL from column bridging == dense re-forward."""
        rng = np.random.default_rng(3)
        tpl, tlen, reads, rlens = _batch(params, rng, B=5)
        B, T = tpl.shape
        snr = jnp.full(B, 4, jnp.int32)
        cols = build_columns(tpl, tlen, snr, reads, rlens, tables)
        valid = polish.mutation_valid(tlen, T)
        got = score_mutants_cols(tpl, tlen, snr, reads, rlens, tables,
                                 cols, valid, m_chunk=16)
        mt, ml, valid_d = polish.make_mutants(tpl, tlen)
        want = polish.score_mutants(mt, ml, valid_d, snr, reads, rlens,
                                    tables, m_chunk=16)
        got, want = np.asarray(got), np.asarray(want)
        vd = np.asarray(valid_d)
        np.testing.assert_array_equal(np.asarray(valid), vd)
        np.testing.assert_allclose(got[vd], want[vd], rtol=2e-4, atol=2e-4)

    def test_polish_trajectories_identical(self, params, tables):
        """cols vs dense scoring yield the same accepted-mutation sequence."""
        rng = np.random.default_rng(21)
        B, T_CAP, R_CAP, C = 4, 28, 44, 8
        tpl = np.full((B, T_CAP), -1, np.int8)
        tlen = np.zeros(B, np.int32)
        reads = np.full((B, C, R_CAP), -1, np.int8)
        rlens = np.full((B, C), -1, np.int32)
        for b in range(B):
            truth = rng.integers(0, 4, 20).astype(np.int8)
            corrupt = truth.copy()
            p = int(rng.integers(0, 20))
            corrupt[p] = (corrupt[p] + 1) % 4
            tpl[b, :20] = corrupt
            tlen[b] = 20
            for c in range(C):
                r = simulate_read(truth, params, 4, rng)[:R_CAP]
                reads[b, c, :len(r)] = r
                rlens[b, c] = len(r)
        args = (jnp.asarray(tpl), jnp.asarray(tlen),
                jnp.zeros(B, jnp.int32), jnp.asarray(tlen, jnp.int32),
                jnp.full(B, 4, jnp.int32),
                jnp.asarray(reads), jnp.asarray(rlens), tables)
        s_cols, qv_c, _ = polish.polish_windows(*args, max_iters=8,
                                                scoring="cols")
        s_dense, qv_d, _ = polish.polish_windows(*args, max_iters=8,
                                                 scoring="dense")
        np.testing.assert_array_equal(np.asarray(s_cols.tlen),
                                      np.asarray(s_dense.tlen))
        np.testing.assert_array_equal(np.asarray(s_cols.tpl),
                                      np.asarray(s_dense.tpl))
        np.testing.assert_array_equal(np.asarray(s_cols.n_iter),
                                      np.asarray(s_dense.n_iter))
        np.testing.assert_allclose(np.asarray(qv_c), np.asarray(qv_d),
                                   rtol=1e-3, atol=0.2)


@pytest.mark.parametrize("shape", ["column", "bridge"])
def test_contract4_matches_highest_einsum(shape):
    """The elementwise 4-base contraction equals a HIGHEST-precision einsum
    for both of its call shapes (column emissions, bridge emissions)."""
    import jax
    from ccs_tpu.ops.hmm_cols import contract4
    rng = np.random.default_rng(3)
    B, C, R, M = 3, 4, 9, 5
    base = rng.integers(-1, 4, (B, C, R))
    oh = np.where(base[..., None] == np.arange(4), 1.0, 0.0)
    oh = jnp.asarray((oh * rng.uniform(0.5, 1.5, (B, C, R, 1)))
                     .astype(np.float32))
    hi = jax.lax.Precision.HIGHEST
    if shape == "column":
        vec = jnp.asarray(rng.uniform(0, 1, (B, 4)).astype(np.float32))
        got = contract4(oh, vec[:, None, None, :])
        want = jnp.einsum("bcrx,bx->bcr", oh, vec, precision=hi)
    else:
        vec = jnp.asarray(rng.uniform(0, 1, (B, M, 4)).astype(np.float32))
        got = contract4(oh[:, :, None], vec[:, None, :, None, :])
        want = jnp.einsum("bcrx,bmx->bcmr", oh, vec, precision=hi)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-7, atol=0)
