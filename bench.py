"""Benchmark: production-path CCS throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Three measurements (bench the real thing):

1. **Polish phase** through the engine's sharded fused step at production
   shapes (W=2048 windows x C=16 lanes, simulator reads, ~0.5 injected
   errors/window) — the component PacBio moved to GPUs on Revio
   (/root/reference/docs/faq/revio.md:14-27).
2. **End-to-end CLI path**: simulated 2 kb/10-pass ZMWs (BASELINE config 2)
   through prepare -> polish -> stitch via the threaded orchestrator.
3. **15 kb e2e** (BASELINE config 3), 10 passes so it shares the compiled
   coverage-bucket programs with (2).

Baseline: ccs v6.2.0 HG002 15kb = 2,832,543 HiFi reads in 4h49m on a
256-thread node (docs/faq/performance.md:48-54) ~= 163 ZMW/s ~= 2.45
Mbases consensus/s per *node*. vs_baseline = our polish-phase consensus
bases/s on ONE GPU over the reference's bases/s per 256-thread node.

It runs only on a GPU: with no GPU it exits non-zero before measuring.
Device timings wait with ``block_until_ready``. The record names the device
(platform, device_kind, count) and the card's name and power limit.

Robustness:
- the persistent JAX compilation cache (ccs_tpu.compile_cache) makes warm
  runs fast; cold compile is bounded by warming exactly the two (W, C)
  bucket programs the run uses;
- stages run on a worker thread against a wall-clock deadline
  (CCS_BENCH_DEADLINE, default 480 s); if the deadline passes or SIGTERM
  arrives, the main thread prints the JSON line with every stage completed
  so far and exits 0 — a partial record beats a null one. A stage that
  raises makes the run exit non-zero;
- per-stage progress lines go to stderr as each stage lands;
- ZMW failures are never silent: status counts are logged per e2e stage.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

from ccs_tpu.compile_cache import configure_compile_cache

W, C, T_CAP, R_CAP = 2048, 16, 44, 39
WINDOW_CORE = 22
E2E_ZMWS = 400
E2E_INSERT = 2000
E2E_PASSES = 10
E2E15_ZMWS = 96          # BASELINE config 3: 15 kb library; x2 seeds
E2E15_INSERT = 15_000
E2E15_SEEDS = 2          # two independent samples -> stability check
BASELINE_BASES_PER_S = 2_832_543 * 15_000 / (4 * 3600 + 49 * 60)  # ≈2.45e6
DEADLINE = float(os.environ.get("CCS_BENCH_DEADLINE", "480"))
T_START = time.time()

# Published peaks by jax device_kind, from NVIDIA's H100 data sheet (SXM
# part, dense rates, 700 W): float32 outside the tensor cores, and HBM
# bandwidth. The scorer is elementwise float32 work, so these are its two
# roofs. A device that is not listed is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flop_per_s": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}

RESULT: dict = {
    "metric": "Arrow-polish ZMWs/sec/GPU (1kb-insert units, production "
              "shapes W=2048xC=16) vs per-node baseline",
    "value": 0.0,
    "unit": "zmw/s",
    "vs_baseline": 0.0,
    "stages_done": [],
}
_PRINTED = threading.Lock()
_printed = False


def log(msg):
    print(f"# [{time.time()-T_START:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def emit_json_once():
    global _printed
    with _PRINTED:
        if _printed:
            return
        _printed = True
        print(json.dumps(RESULT), flush=True)


def remaining() -> float:
    return DEADLINE - (time.time() - T_START)


def device_peaks(device_kind: str) -> dict:
    """PEAKS entry for a device; an unknown device is an error."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {device_kind!r};"
                       f" known: {sorted(PEAKS)}")
    return PEAKS[device_kind]


# Operation model of one score call of the column-bridge scorer
# (ops.hmm_cols), per window and subread lane, in [R+1]-element vector ops
# (1 flop/element): fwd+bwd columns ~39 vec-ops each over 2T+1 columns; the
# mutation bridge ~580 vec-ops per template position (insertion-chain
# solves, emission contractions, y-builds, dots); prepends ~200. An
# estimate of the algorithm's elementwise work, not a hardware counter.
def score_call_flops(n_windows: float, c: int, t: float, r: float,
                     bridge_frac: float = 1.0) -> float:
    s = int(r) + 1
    per_window = c * s * ((2 * t + 1) * 39 + bridge_frac * t * 580 + 200)
    return float(n_windows) * per_window


def _status_report(out, label):
    """Log the per-status breakdown; failures must be attributable
    (reports-aux-files.md:10-11)."""
    from collections import Counter
    counts = Counter(r.status.name for r in out)
    n_ok = counts.get("SUCCESS", 0)
    fails = {k: v for k, v in counts.items() if k != "SUCCESS"}
    if fails:
        log(f"{label}: {n_ok}/{len(out)} SUCCESS; failures: {fails}")
    else:
        log(f"{label}: {n_ok}/{len(out)} SUCCESS")
    return n_ok


def polish_phase_bench(eng, params, peaks: dict):
    """Windows/s of the engine's fused polish step on device-resident
    inputs. The e2e stages below keep the full host->device path."""
    import jax
    from ccs_tpu.sim.simulator import simulate_window_batch
    rng = np.random.default_rng(0)
    args = jax.device_put(simulate_window_batch(W, C, rng, params,
                                                t_cap=T_CAP, r_cap=R_CAP))
    jax.block_until_ready(args)

    def call():
        state, qv, _stats = eng._polish_step(*args)
        return state

    t0 = time.time()
    state = jax.block_until_ready(call())
    log(f"polish warmup W={W} (compile + first exec): {time.time()-t0:.1f}s;"
        f" iters={int(np.asarray(state.n_iter).max())}")
    # warm the small-bucket program too (e2e remainder chunks use it); one
    # tiny call so a cold run never compiles mid-measurement
    t0 = time.time()
    small = eng.w_buckets[0]
    if small < W:
        sargs = tuple(a[:small] for a in args)
        jax.block_until_ready(eng._polish_step(*sargs))
        log(f"polish warmup W={small}: {time.time()-t0:.1f}s")
    # pipelined measurement: the engine dispatches chunks asynchronously,
    # so steady-state throughput is back-to-back device execution
    n_rep = 6
    t0 = time.time()
    states = [call() for _ in range(n_rep)]
    jax.block_until_ready(states)
    dt = (time.time() - t0) / n_rep
    win_per_s = W / dt
    # operations: the initial score call plus one re-score per iteration;
    # the scorer bridges every position (sparse mode masks afterwards)
    n_iter = np.asarray(state.n_iter)
    window_scores = float(W + n_iter.sum())
    t_mean = float(np.asarray(args[1]).mean())
    cand_frac = float(((np.asarray(args[8]) > 0).sum(1) / np.maximum(
        np.asarray(args[1]), 1)).mean())
    flops = score_call_flops(window_scores, C, t_mean, t_mean + 4)
    gflops = flops / dt / 1e9
    fp32_share = gflops * 1e9 / peaks["fp32_flop_per_s"]
    log(f"polish steady: {dt*1000:.1f} ms / {W} windows x {C} lanes "
        f"= {win_per_s:.0f} windows/s (candidate-sparse, "
        f"{100*cand_frac:.0f}% positions flagged); ~{gflops:.0f} GFLOP/s "
        f"(~{100*fp32_share:.1f}% of the published fp32 peak, estimated "
        f"from the operation model)")
    polish_bases_per_s = win_per_s * WINDOW_CORE
    RESULT.update({
        "value": round(polish_bases_per_s / 1000.0, 1),
        "vs_baseline": round(polish_bases_per_s / BASELINE_BASES_PER_S, 4),
        "polish_windows_per_s": round(win_per_s, 0),
        "polish_step_ms": round(dt * 1000, 3),
        "score_gflops_est": round(gflops, 0),
        "fp32_peak_share_est": round(fp32_share, 4),
    })
    RESULT["stages_done"].append("polish")
    log(f"polish phase: {polish_bases_per_s/1000:.0f} 1kb-ZMW/s/GPU "
        f"({polish_bases_per_s/15000:.1f} 15kb-ZMW/s/GPU), "
        f"vs_baseline={RESULT['vs_baseline']}")


def e2e_bench(eng):
    """End-to-end ZMWs/s through the threaded orchestrator."""
    from ccs_tpu.pipeline.orchestrator import run_pipeline
    from ccs_tpu.sim.simulator import simulate_zmw, zmw_input

    t0 = time.time()
    zmws = [zmw_input(simulate_zmw(hole=h, insert_len=E2E_INSERT,
                                   n_passes=E2E_PASSES, snr=9.0), "m_bench")
            for h in range(E2E_ZMWS)]
    log(f"simulated {E2E_ZMWS} x {E2E_INSERT//1000} kb ZMWs "
        f"in {time.time()-t0:.0f}s")

    # warmup: push a small slice through so every bucket program is compiled
    out: list = []
    run_pipeline(eng, iter(zmws[:16]), lambda r, n: out.extend(r),
                 batch_size=128, num_threads=0, input_buffer=4)

    out = []
    eng.t_prepare = eng.t_device = eng.t_finalize = eng.t_busy = 0.0
    t0 = time.time()
    # batch 64: the pipeline's first-fill edge (reader+prepare of batch 1
    # with the device idle) halves vs 128; steady-state overlap unchanged
    run_pipeline(eng, iter(zmws), lambda r, n: out.extend(r),
                 batch_size=64, num_threads=0, input_buffer=4)
    dt = time.time() - t0
    n_ok = _status_report(out, "e2e 2kb statuses")
    bases = sum(len(r.seq) for r in out if r.seq is not None)
    log(f"e2e steady: {dt:.1f}s for {E2E_ZMWS} ZMWs -> {n_ok} HiFi reads, "
        f"{bases/1e6:.2f} Mbases")
    log(f"e2e wall split: prepare {eng.t_prepare:.1f} thread-s "
        f"({1000*eng.t_prepare/E2E_ZMWS:.1f} ms/ZMW), "
        f"device pipeline busy {eng.t_busy:.1f}s "
        f"({100*eng.t_busy/dt:.0f}% of wall; collect-block "
        f"{eng.t_device:.1f}s), finalize {eng.t_finalize:.1f}s; "
        f"host cpus {os.cpu_count()}")
    RESULT.update({
        "e2e_zmw_per_s_2kb": round(E2E_ZMWS / dt, 2),
        "e2e_mbases_per_s": round(bases / dt / 1e6, 3),
        "e2e_vs_baseline": round(bases / dt / BASELINE_BASES_PER_S, 4),
        "e2e_n_ok": n_ok,
        "prepare_thread_s": round(eng.t_prepare, 1),
        "prepare_ms_per_zmw": round(1000 * eng.t_prepare / E2E_ZMWS, 1),
        "device_s": round(eng.t_busy, 1),
        "collect_block_s": round(eng.t_device, 1),
        "finalize_s": round(eng.t_finalize, 1),
        # union of in-flight intervals / wall: the fraction of the run the
        # device pipeline (H2D + execute + D2H) has work outstanding
        "device_busy_frac": round(eng.t_busy / dt, 3),
    })
    if n_ok < 0.9 * E2E_ZMWS:
        # mass ZMW failure: throughput on broken output must not read as
        # healthy (zmw/s counts failed ZMWs; bases/s already drops)
        RESULT["degraded"] = True
    RESULT["stages_done"].append("e2e_2kb")


def e2e_15kb_bench(eng):
    """BASELINE config 3: 15 kb inserts (performance.md:13-15,27-31).
    10 passes — same coverage bucket as the 2kb stage, so no new compile.
    Two independent seeds, each sized so the stage is a real measurement;
    the per-seed rates are reported so the stability is auditable."""
    from ccs_tpu.pipeline.orchestrator import run_pipeline
    from ccs_tpu.sim.simulator import simulate_zmw, zmw_input
    rates, total_n, total_ok, total_bases, total_dt = [], 0, 0, 0, 0.0
    for seed in range(E2E15_SEEDS):
        if remaining() < 60:
            log(f"e2e 15kb: stopping after {seed} seeds "
                f"({remaining():.0f}s left)")
            break
        t0 = time.time()
        zmws = [zmw_input(simulate_zmw(hole=seed * 100_000 + h,
                                       insert_len=E2E15_INSERT, n_passes=10,
                                       snr=9.0), "m_bench")
                for h in range(E2E15_ZMWS)]
        log(f"seed {seed}: simulated {E2E15_ZMWS} x 15 kb ZMWs "
            f"in {time.time()-t0:.0f}s")
        out: list = []
        t0 = time.time()
        run_pipeline(eng, iter(zmws), lambda r, n: out.extend(r),
                     batch_size=8, num_threads=0, input_buffer=4)
        dt = time.time() - t0
        n_ok = _status_report(out, f"e2e 15kb seed {seed} statuses")
        bases = sum(len(r.seq) for r in out if r.seq is not None)
        rates.append(E2E15_ZMWS / dt)
        total_n += E2E15_ZMWS
        total_ok += n_ok
        total_bases += bases
        total_dt += dt
        log(f"e2e 15kb seed {seed}: {dt:.1f}s for {E2E15_ZMWS} ZMWs -> "
            f"{n_ok} HiFi = {E2E15_ZMWS/dt:.2f} 15kb-ZMW/s")
    if not rates:
        return
    spread = (max(rates) - min(rates)) / max(np.mean(rates), 1e-9)
    log(f"e2e 15kb combined: {total_n/total_dt:.2f} 15kb-ZMW/s; per-seed "
        f"{[round(r, 2) for r in rates]} (spread {100*spread:.1f}%)")
    RESULT.update({
        "e2e_15kb_zmw_per_s": round(total_n / total_dt, 2),
        "e2e_15kb_vs_baseline": round(
            total_bases / total_dt / BASELINE_BASES_PER_S, 4),
        "e2e_15kb_n_ok": total_ok,
        "e2e_15kb_seed_rates": [round(r, 2) for r in rates],
        "e2e_15kb_seed_spread": round(spread, 3),
    })
    if total_ok < 0.9 * total_n:
        RESULT["degraded"] = True
    RESULT["stages_done"].append("e2e_15kb")


def device_record() -> dict:
    """The device the run measures; refuses anything but a GPU."""
    import jax
    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX runs on "
                         f"{d0.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs), "card": card[0] if card else ""}


def run_stages(device: dict):
    from ccs_tpu.config import CcsConfig
    from ccs_tpu.models.chemistry import default_params
    from ccs_tpu.pipeline.engine import CcsEngine

    peaks = device_peaks(device["kind"])
    log(f"device: {device}; deadline {DEADLINE:.0f}s")
    params = default_params()
    eng = CcsEngine(CcsConfig(), params)

    polish_phase_bench(eng, params, peaks)
    if remaining() > 150:
        e2e_bench(eng)
    else:
        log(f"skipping e2e 2kb stage: only {remaining():.0f}s left")
    if remaining() > 120:
        e2e_15kb_bench(eng)
    else:
        log(f"skipping e2e 15kb stage: only {remaining():.0f}s left")


def main() -> int:
    log(f"compile cache {configure_compile_cache()}")
    device = device_record()
    RESULT["device"] = device

    def on_term(signum, frame):
        log(f"signal {signum} received; emitting partial record")
        emit_json_once()
        os._exit(0)

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    worker_err: list = []

    def work():
        try:
            run_stages(device)
        except BaseException as e:  # noqa: BLE001 — record, then emit
            worker_err.append(e)

    th = threading.Thread(target=work, daemon=True)
    th.start()
    th.join(max(remaining(), 1.0))
    if th.is_alive():
        log("deadline reached with a stage still running; emitting what "
            "completed")
        emit_json_once()
        os._exit(0)
    if worker_err:
        import traceback
        log("stage raised: "
            + "".join(traceback.format_exception(worker_err[0]))[-2000:])
        RESULT["error"] = repr(worker_err[0])
    emit_json_once()
    return 1 if worker_err else 0


if __name__ == "__main__":
    sys.exit(main())
