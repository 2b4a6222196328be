#!/usr/bin/env python3
"""Fit the clean-position p_err table (polish_fused.CLEAN_PERR_V0).

In candidate-sparse mode (C7, performance.md:90-93) unflagged positions
carry no mutation scores; their per-base p_err comes from a table keyed by
(snr_bin, coverage). This tool measures it: simulate windows across the
SNR x pass-count grid, polish them with DENSE scoring and the production
candidate priorities, and average the dense-scored p_err at NON-candidate
positions per (snr_bin, coverage) cell. A log-linear fit in coverage
interpolates the cells the sample leaves empty, and the result is printed
as the literal numpy constant to paste into pipeline/polish_fused.py.

Run: JAX_PLATFORMS=cpu python tools/fit_clean_qv.py [--fast]
(--fast for a smoke run).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def measure(fast: bool = False):
    import jax.numpy as jnp
    from ccs_tpu.config import CcsConfig
    from ccs_tpu.models.chemistry import default_params
    from ccs_tpu.ops import hmm_jax
    from ccs_tpu.pipeline.polish_fused import polish_windows_fused_impl
    from ccs_tpu.pipeline.zmw import Subread, ZmwInput, prepare_zmw
    from ccs_tpu.sim.simulator import simulate_zmw

    def _zin(z):
        subs, qpos = [], 0
        for read, cx in zip(z.subreads, z.cx):
            subs.append(Subread(seq=read, cx=cx, qs=qpos, qe=qpos + len(read)))
            qpos += len(read) + 40
        return ZmwInput(hole=z.hole, movie="m", subreads=subs, snr=z.snr)

    cfg = CcsConfig()
    params = default_params()
    tables = hmm_jax.params_to_device(params)
    BP, CP = (64, 24) if fast else (256, 24)
    TC, RC = cfg.tpu_window_tpl_cap, cfg.tpu_window_read_cap
    snrs = (7.0, 9.0) if fast else (7.0, 9.0, 11.0)
    passes = (6, 10) if fast else (4, 6, 10, 16, 22)
    rows: dict = {}
    for snr in snrs:
        for P in passes:
            wins = []
            for h in range(4):
                z = _zin(simulate_zmw(hole=h + int(snr * 100) + P * 7,
                                      insert_len=700, n_passes=P, snr=snr))
                item = prepare_zmw(z, cfg, params.snr_edges, params=params)
                if item.terminal:
                    continue
                b = item.batch
                for w in range(len(b.windows)):
                    wins.append((b.tpl[w], b.tlen[w], item.snr_bin,
                                 b.reads[w], b.rlens[w], b.core_start[w],
                                 b.core_end[w], b.priority[w]))
            wins = wins[:BP]
            if not wins:
                continue
            tpl = np.full((BP, TC), -1, np.int8)
            tlen = np.ones(BP, np.int32)
            sb = np.zeros(BP, np.int32)
            reads = np.full((BP, CP, RC), -1, np.int8)
            rl = np.full((BP, CP), -1, np.int32)
            cs = np.zeros(BP, np.int32)
            ce = np.zeros(BP, np.int32)
            pri = np.zeros((BP, TC), np.float32)
            for i, w in enumerate(wins):
                tpl[i], tlen[i], sb[i] = w[0], w[1], w[2]
                c = min(w[3].shape[0], CP)
                reads[i, :c] = w[3][:c]
                rl[i, :c] = w[4][:c]
                cs[i], ce[i], pri[i] = w[5], w[6], w[7]
            state, _qv, p_err = polish_windows_fused_impl(
                jnp.asarray(tpl), jnp.asarray(tlen), jnp.asarray(cs),
                jnp.asarray(ce), jnp.asarray(sb), jnp.asarray(reads),
                jnp.asarray(rl), tables, max_iters=30,
                priority=jnp.asarray(pri))
            p_err = np.asarray(p_err)
            fpri = np.asarray(state.priority)
            fcs = np.asarray(state.core_start)
            fce = np.asarray(state.core_end)
            cov = (rl >= 0).sum(1)
            # CORE-ONLY: window margins accumulate boundary artifacts with
            # p_err ~ 1 that never reach the stitched consensus (measured:
            # all-positions mean 2e-2 vs core-only 7e-4 at cov 10) — the
            # table must price what is actually emitted
            for i in range(len(wins)):
                a, b2 = int(fcs[i]), int(fce[i])
                mask = fpri[i, a:b2] == 0
                rows.setdefault((int(sb[i]), int(cov[i])), []).append(
                    p_err[i, a:b2][mask])
            print(f"# snr={snr} P={P}: {len(wins)} windows", flush=True)
    return {k: np.concatenate(v) for k, v in rows.items()}


def fit_table(rows: dict, cov_cap: int = 40) -> np.ndarray:
    """Per-snr log-linear fit log10(p) = a + b*cov through the measured
    cell means (>= 80 samples), evaluated on the full grid and floored by
    the measurements where present."""
    out = np.zeros((8, cov_cap + 1), np.float32)
    for s in range(8):
        pts = [(c, v.mean()) for (sb, c), v in rows.items()
               if sb == s and len(v) >= 80]
        if len(pts) < 2:
            # no data at this snr bin: borrow the nearest measured bin
            near = min({sb for sb, _ in rows}, key=lambda x: abs(x - s),
                       default=None)
            pts = [(c, v.mean()) for (sb, c), v in rows.items()
                   if sb == near and len(v) >= 80]
        cv = np.asarray([p[0] for p in pts], np.float64)
        lp = np.log10(np.maximum([p[1] for p in pts], 1e-12))
        b, a = np.polyfit(cv, lp, 1)
        grid = np.arange(cov_cap + 1, dtype=np.float64)
        out[s] = np.minimum(10.0 ** (a + b * grid), 0.25)
        for c, m in pts:  # measured cells override the fit
            if c <= cov_cap:
                out[s, c] = min(m, 0.25)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    args = ap.parse_args()
    rows = measure(fast=args.fast)
    for (s, c), v in sorted(rows.items()):
        if len(v) >= 80:
            print(f"# snr_bin={s} cov={c}: n={len(v)} mean={v.mean():.3e} "
                  f"QV={-10*np.log10(max(v.mean(), 1e-9)):.1f}")
    tab = fit_table(rows)
    np.set_printoptions(threshold=10_000)
    print("# paste into ccs_tpu/pipeline/polish_fused.py:")
    print("CLEAN_PERR_V0 = _np.array(")
    print(repr(tab.tolist()))
    print(", dtype=_np.float32)")
    np.save("clean_perr_v0.npy", tab)
    print("# saved clean_perr_v0.npy")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
