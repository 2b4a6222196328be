#!/usr/bin/env python3
"""Smoke test of the HiFi pipeline on NVIDIA GPUs, through the entry points
a user calls.

Run it from the root of a checkout on a machine with a card:

    python chip_smoke.py                # one card (the default)
    python chip_smoke.py --four-cards   # only the four-card paths

One card, one process, three phases:

1. device: JAX must run on a GPU. Prints the device kind and count, the JAX
   version, the card's name and power limit (``nvidia-smi``) and the host
   CPU count, and requires the native host library.
2. scorer: the engine's candidate-sparse and dense polish steps at the
   production width (W=2048 windows x C=16 and C=32 read slices, template
   cap 44, read cap 39) on simulated windows. Prints each step's
   ``memory_analysis()`` and steady ms per step (``block_until_ready``).
   A 64-window slice of the card's final scores is held to the brute-force
   forward pass on the CPU device (ll0 within 2e-3, every scored mutation
   within 5e-3), and the polish loop is rerun on that slice on the CPU.
3. cli: ``ccs_tpu`` on a simulated subreads BAM of 256 x 2 kb + 16 x 15 kb
   ZMWs at 10 passes. Checks the report counts, >= 97% SUCCESS, that
   ``out.bam`` parses, that the first 16 ZMWs equal a CcsEngine run on the
   CPU device, and that no other process opens the card meanwhile.

``--four-cards`` runs (b) ``--tpu-num-hosts 4`` on this host, one process
per card (``CUDA_VISIBLE_DEVICES``) with a localhost coordinator, against
a one-process run, before this process touches a card; then (a) the engine
on a 4-card ('zmw',) mesh with the on-mesh psum against the same batch on
one card.

The last line of standard output is one JSON object, printed only when
every phase passed: {"ok": true, "device": {"platform", "kind", "count"}}.
Any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

from ccs_tpu.compile_cache import CHECKOUT, configure_compile_cache

W_PROD = 2048
LL0_TOL = 2e-3         # tests/test_polish_fused.py tolerances
MUT_TOL = 5e-3
NEAR_TIE = 0.1         # 5x the 0.02 accept threshold: a CPU/GPU template
                       # difference within this LL margin is a near-tie


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(*args: str) -> list[str]:
    out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                         text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device(want_platform: str = "gpu", want_count: int = 1,
                 card_info: bool = True):
    """Check the platform and print what runs the rest; returns devices."""
    import jax

    devs = jax.devices()
    d0 = devs[0]
    log(f"jax {jax.__version__}: platform={d0.platform} "
        f"device_kind={d0.device_kind} count={len(devs)}")
    check(d0.platform == want_platform,
          f"JAX runs on {d0.platform!r}, not {want_platform!r}")
    check(len(devs) >= want_count,
          f"{len(devs)} devices, {want_count} needed")
    if card_info:
        for line in nvidia_smi("--query-gpu=name,power.limit",
                               "--format=csv,noheader"):
            print(line, flush=True)
    log(f"host cpus: {os.cpu_count()}")
    from ccs_tpu import native
    check(native.load() is not None,
          "the native host library did not load (NumPy fallbacks would run)")
    return devs


# ---------------------------------------------------------------------------
# phase 2: scorer at production width
# ---------------------------------------------------------------------------

def _apply_mutation(t: np.ndarray, m: int) -> np.ndarray:
    """Template after per-position mutation slot m < 9T of polish_fused's
    9-kind enumeration (substitute, delete, insert after)."""
    p, k = divmod(m, 9)
    if k <= 3:
        out = t.copy()
        out[p] = k
        return out
    if k == 4:
        return np.delete(t, p)
    return np.insert(t, p + 1, k - 5)


def brute_force_lls(tpl, tlen, snr, reads, rlens, slots, tables, cpu,
                    chunk: int = 1024):
    """Brute-force forward LL (summed over reads) of each window's template
    and of every mutation slot listed in ``slots`` [(b, m)], on ``cpu``.
    Returns (ll0 [B], {(b, m): ll})."""
    import jax
    from ccs_tpu.ops.hmm_jax import _forward_batch_scan

    B, T = tpl.shape
    rows = [(b, -1) for b in range(B)] + list(slots)
    mut = np.full((len(rows), T), -1, np.int8)
    mlen = np.zeros(len(rows), np.int32)
    for i, (b, m) in enumerate(rows):
        t0 = tpl[b, :tlen[b]]
        if m < 0:
            t = t0
        elif m >= 9 * T:
            t = np.insert(t0, 0, m - 9 * T)
        else:
            t = _apply_mutation(t0, m)
        mut[i, :len(t)] = t
        mlen[i] = len(t)
    fwd = jax.jit(_forward_batch_scan)
    bi = np.asarray([b for b, _ in rows])
    out = np.zeros(len(rows), np.float64)
    for s in range(0, len(rows), chunk):
        sl = slice(s, s + chunk)
        n = len(bi[sl])
        pad = chunk - n
        idx = np.concatenate([bi[sl], np.zeros(pad, int)])
        mt = np.concatenate([mut[sl], np.zeros((pad, T), np.int8)])
        ml = np.concatenate([mlen[sl], np.ones(pad, np.int32)])
        ll = fwd(*jax.device_put((mt, ml, snr[idx], reads[idx], rlens[idx]),
                                 cpu), tables)
        out[s:s + n] = np.asarray(ll).sum(-1)[:n]
    return out[:B], {r: float(v) for r, v in zip(rows[B:], out[B:])}


def _fmt_mem(ma) -> str:
    if ma is None:
        return "not available"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return ", ".join(f"{k.replace('_size_in_bytes', '')}="
                     f"{getattr(ma, k) / 2**20:.1f} MiB"
                     for k in keys if hasattr(ma, k))


def check_slice(args, state, mode: str, idx, cpu, tables_cpu, cfg) -> None:
    """Hold a window slice of a step's output to the CPU reference."""
    import jax
    from ccs_tpu.pipeline.polish_fused import NEG, polish_windows_fused

    tpl = np.asarray(state.tpl)[idx]
    tlen = np.asarray(state.tlen)[idx]
    ll = np.asarray(state.ll)[idx]
    lls = np.asarray(state.lls)[idx]
    snr, reads, rlens = (np.asarray(a)[idx] for a in (args[4], args[5],
                                                      args[6]))
    slots = [(b, int(m)) for b, m in zip(*np.nonzero(lls > NEG / 2))]
    ref0, ref = brute_force_lls(tpl, tlen, snr, reads, rlens, slots,
                                tables_cpu, cpu)
    d0 = float(np.abs(ll - ref0).max())
    dm = max((abs(float(lls[b, m]) - v) for (b, m), v in ref.items()),
             default=0.0)
    log(f"  {len(idx)}-window slice vs brute force on CPU (float32; the "
        f"scorer has no matmul): max |ll0 diff| {d0:.2e} (limit {LL0_TOL}),"
        f" max |mutation LL diff| {dm:.2e} over {len(slots)} scored "
        f"mutations (limit {MUT_TOL})")
    check(d0 <= LL0_TOL, f"{mode}: ll0 off by {d0}")
    check(dm <= MUT_TOL, f"{mode}: mutation LL off by {dm}")

    # the same polish loop on the CPU device, from the same inputs
    cin = [jax.device_put(np.asarray(a)[idx], cpu) for a in args]
    st_c, _qv, _pe = polish_windows_fused(
        *cin[:7], tables_cpu, max_iters=cfg.max_polish_iterations,
        is_first=cin[7], priority=cin[8], thresh=cfg.tpu_polish_thresh,
        sparse=mode == "sparse")
    ctpl, clen = np.asarray(st_c.tpl), np.asarray(st_c.tlen)
    diff = [b for b in range(len(idx))
            if tlen[b] != clen[b]
            or not np.array_equal(tpl[b, :tlen[b]], ctpl[b, :clen[b]])]
    if diff:
        both = np.concatenate([tpl[diff], ctpl[diff]])
        blen = np.concatenate([tlen[diff], clen[diff]])
        two = np.concatenate([np.asarray(diff)] * 2)
        lld, _ = brute_force_lls(both, blen, snr[two], reads[two],
                                 rlens[two], [], tables_cpu, cpu)
        n = len(diff)
        for i, b in enumerate(diff):
            margin = lld[i] - lld[n + i]
            log(f"  window {idx[b]}: card and CPU templates differ; "
                f"LL(card) - LL(cpu) = {margin:+.4f}")
            check(abs(margin) <= NEAR_TIE,
                  f"{mode}: window {idx[b]} differs by LL {margin}")
    log(f"  CPU polish loop on the slice: {len(idx) - len(diff)}/{len(idx)}"
        f" templates identical")


def phase_scorer(dev, cpu, n_windows: int = W_PROD, covs=(16, 32),
                 modes=("sparse", "dense"), n_slice: int = 64,
                 n_rep: int = 5, seed: int = 0) -> dict:
    """Compile, time and check the engine's polish steps; returns
    {(mode, cov): median seconds per step}."""
    import jax
    from ccs_tpu.config import CcsConfig
    from ccs_tpu.models.chemistry import default_params
    from ccs_tpu.ops.hmm_jax import params_to_device
    from ccs_tpu.pipeline.engine import CcsEngine
    from ccs_tpu.sim.simulator import simulate_window_batch

    cfg = CcsConfig()
    params = default_params()
    eng = CcsEngine(cfg, params, devices=[dev])
    with jax.default_device(cpu):
        tables_cpu = params_to_device(params)
    rng = np.random.default_rng(seed)
    idx = np.linspace(0, n_windows - 1, min(n_slice, n_windows)).astype(int)
    times = {}
    for cov in covs:
        args = simulate_window_batch(n_windows, cov, rng, params,
                                     t_cap=cfg.tpu_window_tpl_cap,
                                     r_cap=cfg.tpu_window_read_cap)
        dargs = jax.device_put(args, dev)
        for mode in modes:
            step = eng._polish_step if mode == "sparse" \
                else eng._polish_step_dense
            t0 = time.perf_counter()
            compiled = step._jitted.lower(step.tables, *dargs).compile()
            log(f"[scorer {mode} W={n_windows} C={cov}] compile "
                f"{time.perf_counter() - t0:.1f} s")
            log(f"  memory_analysis: {_fmt_mem(compiled.memory_analysis())}")
            out = jax.block_until_ready(compiled(step.tables, *dargs))
            dts = []
            for _ in range(n_rep):
                t0 = time.perf_counter()
                out = jax.block_until_ready(compiled(step.tables, *dargs))
                dts.append(time.perf_counter() - t0)
            state, _qv, stats = out
            n_iter = np.asarray(state.n_iter)
            times[(mode, cov)] = float(np.median(dts))
            log(f"  steady {1e3 * np.median(dts):.2f} ms/step (median of "
                f"{n_rep}; min {1e3 * min(dts):.2f}, max {1e3 * max(dts):.2f})"
                f"; iterations max {n_iter.max()} mean {n_iter.mean():.2f}; "
                f"stats {np.asarray(stats).tolist()}")
            check_slice(args, state, mode, idx, cpu, tables_cpu, cfg)
    return times


# ---------------------------------------------------------------------------
# phase 3: the CLI end to end
# ---------------------------------------------------------------------------

def _card_fds(pid: int) -> bool:
    """Whether process ``pid`` holds a GPU device file open."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


def _children(pid: int) -> list[int]:
    kids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            kids.append(int(name))
    return kids


class CardWatcher(threading.Thread):
    """Samples, off JAX, which processes use the card: the pids that
    ``nvidia-smi --query-compute-apps=pid`` lists, and this process's
    children that hold a GPU device file open."""

    def __init__(self, period: float = 2.0):
        super().__init__(daemon=True, name="card-watcher")
        self.period = period
        self.smi_pids: set[int] = set()
        self.card_children: set[int] = set()
        self.n_children = 0
        self._halt = threading.Event()

    def run(self):
        while not self._halt.is_set():
            try:
                self.smi_pids.update(
                    int(p) for p in nvidia_smi(
                        "--query-compute-apps=pid", "--format=csv,noheader")
                    if p.isdigit())
            except (OSError, subprocess.SubprocessError):
                pass
            kids = _children(os.getpid())
            self.n_children = max(self.n_children, len(kids))
            self.card_children.update(k for k in kids if _card_fds(k))
            self._halt.wait(self.period)

    def stop(self):
        self._halt.set()
        self.join(timeout=30)


def _report_counts(path: str) -> dict:
    counts = {}
    with open(path) as fh:
        for line in fh:
            m = re.match(r"ZMWs (input|pass filters|fail filters|"
                         r"shortcut filters)\s*:\s*(\d+)", line)
            if m:
                counts[m.group(1)] = int(m.group(2))
    return counts


def _bam_records(path: str) -> list[tuple]:
    from ccs_tpu.io.bam import BamReader
    with BamReader(path) as r:
        return [(rec.name, rec.seq.tobytes(), rec.qual.tobytes(),
                 rec.tag("rq"), rec.tag("np")) for rec in r]


def phase_cli(workdir: str, cpu, n_short: int = 256, short_len: int = 2000,
              n_long: int = 16, long_len: int = 15000, passes: int = 10,
              n_compare: int = 16, min_success: float = 0.97,
              watch_card: bool = True) -> None:
    """Simulate a subreads BAM, run the CLI on it in this process, and
    check its outputs."""
    from ccs_tpu import cli
    from ccs_tpu.config import CcsConfig
    from ccs_tpu.io.bam import BamReader
    from ccs_tpu.models.chemistry import load_model
    from ccs_tpu.pipeline.engine import CcsEngine
    from ccs_tpu.pipeline.orchestrator import shutdown_prepare_pool
    from ccs_tpu.sim.simulator import simulate_zmw, write_subreads_bam
    from ccs_tpu.statuses import ZmwStatus

    t0 = time.perf_counter()
    zmws = [simulate_zmw(hole=h, insert_len=short_len, n_passes=passes,
                         snr=9.0) for h in range(n_short)]
    zmws += [simulate_zmw(hole=n_short + h, insert_len=long_len,
                          n_passes=passes, snr=9.0) for h in range(n_long)]
    in_bam = os.path.join(workdir, "in.subreads.bam")
    write_subreads_bam(in_bam, zmws)
    log(f"[cli] simulated {n_short} x {short_len} bp + {n_long} x {long_len}"
        f" bp ZMWs at {passes} passes in {time.perf_counter() - t0:.1f} s")

    out_bam = os.path.join(workdir, "out.bam")
    watcher = CardWatcher() if watch_card else None
    if watcher:
        watcher.start()
    t0 = time.perf_counter()
    try:
        rc = cli.run([in_bam, out_bam])
    finally:
        if watcher:
            watcher.stop()
        shutdown_prepare_pool()
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli returned {rc}")
    counts = _report_counts(os.path.join(workdir, "out.ccs_report.txt"))
    n_in = counts.get("input", -1)
    n_pass = counts.get("pass filters", 0)
    check(n_in == len(zmws), f"report input {n_in} != {len(zmws)}")
    check(n_pass + counts.get("fail filters", 0)
          + counts.get("shortcut filters", 0) == n_in,
          f"report counts do not sum to the input: {counts}")
    log(f"  cli rc 0 in {wall:.1f} s (compilation included): {n_pass}/{n_in}"
        f" SUCCESS ({100 * n_pass / n_in:.2f}%, limit "
        f"{100 * min_success:.0f}%); report {counts}")
    check(n_pass >= min_success * n_in, "too few SUCCESS ZMWs")
    records = _bam_records(out_bam)
    check(len(records) == n_pass,
          f"out.bam holds {len(records)} records, {n_pass} expected")
    check(all(len(r[1]) == len(r[2]) > 0 for r in records),
          "out.bam record without sequence or qualities")
    with gzip.open(out_bam) as fh:
        fh.read()
    log(f"  out.bam parses: {len(records)} records")

    # the first ZMWs again, through CcsEngine on the CPU device
    with BamReader(in_bam) as reader:
        movie = reader.header.movie_name()
        params = load_model(reader.header.chemistry())
        first = list(cli.iter_zmws(reader, movie,
                                   holes=set(range(n_compare))))
    cfg = CcsConfig(tpu_window_buckets=(256,))
    ref = CcsEngine(cfg, params, devices=[cpu]).process_batch(first)
    card = {int(r[0].split("/")[1]): r[1] for r in records}
    n_same = 0
    for res in ref:
        want = (res.seq.tobytes() if res.status == ZmwStatus.SUCCESS
                else None)
        got = card.get(res.hole)
        if want == got:
            n_same += 1
        else:
            log(f"  ZMW {res.hole}: card and CPU consensus differ "
                f"(cpu status {res.status.name})")
    log(f"  first {len(ref)} ZMWs: {n_same}/{len(ref)} consensus identical "
        f"to CcsEngine on the CPU device")
    check(n_same == len(ref), "card and CPU consensus differ")
    if watcher:
        log(f"  processes on the card during the run: nvidia-smi pids "
            f"{sorted(watcher.smi_pids)} (this process: {os.getpid()}); "
            f"{watcher.n_children} child processes, "
            f"{len(watcher.card_children)} with a card open")
        check(len(watcher.smi_pids) <= 1 and not watcher.card_children,
              "another process used the card during the CLI run")


# ---------------------------------------------------------------------------
# --four-cards
# ---------------------------------------------------------------------------

def phase_mesh(devs, n_zmws: int = 64, insert_len: int = 2000,
               passes: int = 10) -> None:
    """(a) the engine on an N-device mesh == the same batch on one."""
    from ccs_tpu.config import CcsConfig
    from ccs_tpu.models.chemistry import default_params
    from ccs_tpu.pipeline.engine import CcsEngine
    from ccs_tpu.sim.simulator import simulate_zmw, zmw_input
    from ccs_tpu.statuses import ZmwStatus

    params = default_params()
    zmws = [zmw_input(simulate_zmw(hole=h, insert_len=insert_len,
                                   n_passes=passes, snr=9.0))
            for h in range(n_zmws)]
    eng_n = CcsEngine(CcsConfig(), params, devices=devs)
    eng_1 = CcsEngine(CcsConfig(), params, devices=devs[:1])
    psum = not eng_n._polish_step.stats_sharded
    check(psum == (devs[0].platform != "cpu"),
          "on-mesh psum must be on exactly for non-CPU meshes")
    t0 = time.perf_counter()
    res_n = eng_n.process_batch(zmws)
    t_n = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_1 = eng_1.process_batch(zmws)
    t_1 = time.perf_counter() - t0
    n_ok = 0
    for a, b in zip(res_n, res_1):
        check(a.status == b.status, f"ZMW {a.hole}: {a.status} vs {b.status}")
        if a.seq is not None:
            check(np.array_equal(a.seq, b.seq), f"ZMW {a.hole}: seq differs")
            check(np.allclose(a.qv, b.qv, atol=1e-3),
                  f"ZMW {a.hole}: QVs differ")
        n_ok += a.status == ZmwStatus.SUCCESS
    check(np.array_equal(eng_n.polish_stats, eng_1.polish_stats),
          f"stats {eng_n.polish_stats} vs {eng_1.polish_stats}")
    log(f"[mesh] {len(devs)}-device mesh (psum {'on' if psum else 'off'}) =="
        f" 1 device on {n_zmws} ZMWs: {n_ok} SUCCESS, sequences identical, "
        f"QVs within 1e-3, stats {eng_n.polish_stats.tolist()} equal; "
        f"wall {t_n:.1f} s vs {t_1:.1f} s (compilation included)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_multihost(workdir: str, n_procs: int, child_env,
                    n_zmws: int = 64, insert_len: int = 2000,
                    passes: int = 10, timeout: float = 300.0) -> None:
    """(b) --tpu-num-hosts N as N processes with a localhost coordinator;
    the merged output must equal a one-process run record for record.
    ``child_env(i)`` gives the extra environment of process i."""
    from ccs_tpu.sim.simulator import simulate_zmw, write_subreads_bam

    in_bam = os.path.join(workdir, "mh.subreads.bam")
    write_subreads_bam(in_bam, [simulate_zmw(hole=h, insert_len=insert_len,
                                             n_passes=passes, snr=9.0)
                                for h in range(n_zmws)])
    base = dict(os.environ, PYTHONPATH=CHECKOUT)
    cli = [sys.executable, "-m", "ccs_tpu", in_bam]

    def start(out, extra, i):
        # output goes to files, not pipes: a child blocked on a full pipe
        # would hold up the others waiting on it
        log_path = f"{out}.{i}.log"
        with open(log_path, "w") as fh:
            p = subprocess.Popen(cli + [out, "--log-level", "INFO"] + extra,
                                 env=dict(base, **child_env(i)),
                                 cwd=CHECKOUT, stdout=fh,
                                 stderr=subprocess.STDOUT)
        return p, log_path

    def finish(procs, what):
        deadline = time.monotonic() + timeout
        try:
            for p, _ in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"{what} timed out")
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, (p, log_path) in enumerate(procs):
            with open(log_path) as fh:
                text = fh.read()
            for line in text.splitlines():
                if "devices:" in line or "jax.distributed" in line:
                    log(f"  {what} process {i}: {line.split(' INFO ')[-1]}")
            check(p.returncode == 0,
                  f"{what} process {i} rc {p.returncode}: {text[-3000:]}")

    single = os.path.join(workdir, "single.bam")
    t0 = time.perf_counter()
    finish([start(single, [], 0)], "one-process run")
    t_single = time.perf_counter() - t0
    merged = os.path.join(workdir, "merged.bam")
    coord = f"localhost:{_free_port()}"
    t0 = time.perf_counter()
    finish([start(merged, ["--tpu-num-hosts", str(n_procs), "--tpu-host-id",
                           str(i), "--tpu-coordinator", coord], i)
            for i in range(n_procs)], f"{n_procs}-process run")
    t_multi = time.perf_counter() - t0
    a, b = _bam_records(merged), _bam_records(single)
    check(a == b, f"merged output differs from the one-process run "
                  f"({len(a)} vs {len(b)} records)")
    log(f"[multihost] --tpu-num-hosts {n_procs} ({coord}) merged output == "
        f"one-process run: {len(a)} records identical; wall {t_multi:.1f} s "
        f"vs {t_single:.1f} s (process start and compilation included)")


# ---------------------------------------------------------------------------

def run_one_card(workdir: str) -> dict:
    import jax

    devs = phase_device()
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    phase_scorer(devs[0], cpu)
    log(f"[scorer] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_cli(workdir, cpu)
    log(f"[cli] done in {time.perf_counter() - t0:.1f} s")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def run_four_cards(workdir: str) -> dict:
    cards = nvidia_smi("--query-gpu=name,power.limit", "--format=csv,noheader")
    check(len(cards) >= 4, f"{len(cards)} cards, 4 needed")
    # (b) first: its processes each open one card while this one holds none
    phase_multihost(workdir, 4, lambda i: {"CUDA_VISIBLE_DEVICES": str(i)})
    devs = phase_device(want_count=4)
    phase_mesh(devs[:4])
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh and multihost paths")
    ap.add_argument("--workdir", default=None,
                    help="keep inputs and outputs here (default: a "
                         "temporary directory, removed afterwards)")
    args = ap.parse_args(argv)
    # the CPU device holds the reference; keep it beside a named platform
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    configure_compile_cache()
    workdir = args.workdir or tempfile.mkdtemp(prefix="chip_smoke_")
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    try:
        device = (run_four_cards if args.four_cards else run_one_card)(workdir)
    except Exception:  # noqa: BLE001 — any failed phase fails the smoke
        traceback.print_exc()
        log(f"chip_smoke: FAILED after {time.perf_counter() - t0:.1f} s")
        return 1
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
