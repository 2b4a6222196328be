"""DeepConsensus-style learned window refinement (P3 stretch;
/root/reference/docs/faq/revio.md:29-53).

The model's value proposition is CHEMISTRY MISMATCH: on reads generated by
the exact scoring HMM, Arrow's decisions are already maximum-likelihood and
cannot be beaten; under a perturbed true chemistry, Arrow leaves systematic
residual errors the model learns to fix (the same reason the real
DeepConsensus beats arrow on real instrument data)."""

import dataclasses

import numpy as np
import pytest

from ccs_tpu.models.chemistry import default_params
from ccs_tpu.models import dc_polisher as dc


def perturbed_params(scale_del: float = 2.2, scale_ins: float = 1.8):
    """A 'true' chemistry whose indel rates differ from the stock tables."""
    p = default_params()
    trans = p.trans.copy()
    trans[..., 1] *= scale_ins          # branch
    trans[..., 2] *= scale_ins          # stick
    trans[..., 3] *= scale_del          # delete
    trans /= trans.sum(-1, keepdims=True)
    return dataclasses.replace(p, trans=trans)


_residual_errors = dc.residual_errors


class TestDcPolisher:
    def test_model_roundtrip(self, tmp_path):
        rng = np.random.default_rng(0)
        m = dc.init_model(rng, hidden=8, ctx=1)
        path = str(tmp_path / "dc.npz")
        m.save(path)
        m2 = dc.DcModel.load(path)
        assert m2.ctx == 1
        np.testing.assert_array_equal(m.w1, m2.w1)

    def test_dc_forward_matches_numpy(self):
        """The model forward (HIGHEST-precision matmuls) equals a float64
        NumPy evaluation of the same MLP to float32 rounding."""
        import jax.numpy as jnp
        rng = np.random.default_rng(5)
        m = dc.init_model(rng, hidden=16, ctx=2)
        B, T = 3, 12
        feats = rng.normal(0, 1, (B, T, dc.N_BASE_FEATS)).astype(np.float32)
        cls, err = dc.dc_forward(m.tree(), jnp.asarray(feats), 2)
        tr = {k: np.asarray(v, np.float64) for k, v in m.tree().items()}
        f = feats.astype(np.float64)
        x = np.concatenate(
            [np.pad(f, ((0, 0), (max(-o, 0), max(o, 0)), (0, 0)))[
                :, max(o, 0):max(o, 0) + T] for o in range(-2, 3)], axis=-1)
        h = np.tanh(x @ tr["w1"] + tr["b1"])
        h = np.tanh(h @ tr["w2"] + tr["b2"])
        np.testing.assert_allclose(np.asarray(cls),
                                   h @ tr["w_cls"] + tr["b_cls"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(err),
                                   (h @ tr["w_err"] + tr["b_err"])[..., 0],
                                   rtol=1e-4, atol=1e-5)

    def test_feature_shapes(self):
        import jax.numpy as jnp
        B, T = 4, 20
        rng = np.random.default_rng(1)
        tpl = jnp.asarray(rng.integers(0, 4, (B, T)).astype(np.int8))
        tlen = jnp.asarray(np.full(B, T - 4, np.int32))
        lls = jnp.asarray(rng.normal(-50, 5, (B, 9 * T + 4)).astype(
            np.float32))
        ll = jnp.asarray(np.full(B, -40.0, np.float32))
        qv = jnp.asarray(np.full((B, T), 30.0, np.float32))
        cov = jnp.asarray(np.full(B, 8, np.int32))
        feats = dc.window_features(tpl, tlen, lls, ll, qv, cov)
        assert feats.shape == (B, T, dc.N_BASE_FEATS)
        # positions beyond tlen carry no features
        assert float(jnp.abs(feats[:, T - 4:]).max()) == 0.0
        m = dc.init_model(np.random.default_rng(0), hidden=8, ctx=2)
        cls, err = dc.dc_forward(m.tree(), feats, 2)
        assert cls.shape == (B, T, dc.N_CLASSES)
        assert err.shape == (B, T)

    @pytest.mark.slow
    def test_mismatch_training_never_hurts_and_flags_errors(self):
        """The honest DC contract (round-4 measurement): the EDIT head's
        precision never beat break-even at any confidence on held-out data,
        so calibration must GATE it (conf=inf -> no edits, never the
        round-3 error doubling); the ERROR head must strongly separate
        Arrow's residual errors from clean positions — Arrow's own QV is
        anti-correlated with them under mismatch — and its de-biased mass
        must track the actual error count (the rq-recalibration role of
        the Revio DC stage, revio.md:41-44)."""
        import jax.numpy as jnp
        true_chem = perturbed_params()
        score_chem = default_params()
        model = dc.train(true_chem, score_chem, steps=400, n_windows=192,
                         hidden=48, ctx=2, batches=4, seed=3)
        # fresh evaluation batch, same mismatch
        rng = np.random.default_rng(99)
        state, qv, cov, feats, labels, weights, truths = \
            dc.make_training_batch(192, true_chem, score_chem, rng)
        base_err = _residual_errors(np.asarray(state.tpl),
                                    np.asarray(state.tlen), truths)
        assert base_err > 0
        cls, _err = dc.dc_forward(model.tree(), feats, model.ctx)
        ntpl, nlen, _cs, _ce, applied = dc.apply_corrections(
            state.tpl, state.tlen, state.core_start, state.core_end,
            cls, jnp.ones(len(truths), bool), conf_thresh=model.conf,
            allow_sub=bool(model.sub_ok))
        dc_err = _residual_errors(np.asarray(ntpl), np.asarray(nlen), truths)
        # calibrated edits NEVER hurt: either they strictly help (finite
        # conf that survived held-out calibration) or they are gated off
        if np.isfinite(model.conf):
            assert dc_err < base_err, (base_err, dc_err, model.conf)
        else:
            assert dc_err == base_err, (base_err, dc_err)
        # the error head's value: >=5x separation, mass within [0.3, 3]x
        disc, mass_ratio = dc.err_head_quality(model, state, feats, labels)
        assert disc >= 5.0, disc
        assert 0.3 <= mass_ratio <= 3.0, mass_ratio


@pytest.mark.slow
def test_dc_flag_e2e_recalibrates_rq():
    """--tpu-dc-polish end to end with the SHIPPED model: under chemistry
    mismatch the DC rq stream (model QVs on processed windows,
    revio.md:41-44) must track the true error rate more closely than
    Arrow's own rq, which is systematically overconfident there (its QV is
    computed under the same wrong model that made the errors)."""
    import dataclasses as _dc

    from ccs_tpu.config import CcsConfig
    from ccs_tpu.ops import dna
    from ccs_tpu.ops.align import guided_align
    from ccs_tpu.pipeline.engine import CcsEngine
    from ccs_tpu.pipeline.zmw import Subread, ZmwInput
    from ccs_tpu.sim.simulator import simulate_zmw
    from ccs_tpu.statuses import ZmwStatus

    model = dc.builtin_model()
    assert model is not None, "shipped dc_v0.npz missing"

    true_chem = perturbed_params(scale_del=2.2, scale_ins=1.8)
    sims = [simulate_zmw(700 + h, 300, 6, params=true_chem, snr=9.0)
            for h in range(10)]

    def _zin(z):
        subs, qpos = [], 0
        for read, cx in zip(z.subreads, z.cx):
            subs.append(Subread(seq=read, cx=cx, qs=qpos,
                                qe=qpos + len(read)))
            qpos += len(read) + 40
        return ZmwInput(hole=z.hole, movie="m_dc", subreads=subs, snr=z.snr)

    def true_err_rate(seq, truth):
        best = None
        for t in (truth, dna.revcomp(truth)):
            aln = guided_align(np.asarray(seq), t, band=48)
            if aln is None:
                continue
            i = j = d = 0
            for ln, op in aln.cigar:
                if op == "M":
                    d += int((np.asarray(seq[i:i + ln]) != t[j:j + ln]).sum())
                    i += ln
                    j += ln
                elif op == "I":
                    d += ln
                    i += ln
                else:
                    d += ln
                    j += ln
            best = d if best is None else min(best, d)
        return (best if best is not None else len(truth)) / len(truth)

    def rq_gap(dc_on: bool):
        eng = CcsEngine(CcsConfig(batch_size=16, tpu_mesh_shape=(1,),
                                  min_rq=0.0, tpu_dc_polish=dc_on))
        res = eng.process_batch([_zin(z) for z in sims])
        gaps = []
        for r, z in zip(res, sims):
            if r.status != ZmwStatus.SUCCESS or r.seq is None:
                continue
            gaps.append(abs((1.0 - r.rq) - true_err_rate(r.seq, z.insert)))
        assert len(gaps) >= 8, len(gaps)
        return float(np.mean(gaps))

    gap_off = rq_gap(False)
    gap_on = rq_gap(True)
    # the recalibrated stream must be strictly closer to the truth
    assert gap_on < gap_off, (gap_on, gap_off)
