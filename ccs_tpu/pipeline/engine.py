"""Batch engine: concatenate windows from many ZMWs into one device polish.

This is the L5→L3 coupling (SURVEY.md §1 re-layering): the host prepares
ZMWs (filters/draft/windows), windows across the batch are flattened into
fixed-shape [W_bucket, ...] device calls (window-level data parallelism —
the device analog of the reference's thread pool), sharded over the local
('zmw',) device mesh, and results scatter back per ZMW for stitching.

Shape discipline (SURVEY §7 hard-part 5): every device call uses a shape
from the closed (cfg.tpu_window_buckets × cfg.tpu_coverage_buckets) grid, so
a full run compiles a handful of programs regardless of input — round 1
padded per batch and recompiled constantly.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import jax
import numpy as np

from ccs_tpu.config import CcsConfig
from ccs_tpu.models.chemistry import ArrowParams, default_params
from ccs_tpu.ops import hmm_jax
from ccs_tpu.pipeline.prepare import prepare_many
from ccs_tpu.pipeline.zmw import (ConsensusResult, ZmwInput, ZmwWorkItem,
                                  finalize_zmw)
from ccs_tpu.statuses import ZmwStatus

logger = logging.getLogger("ccs_tpu")


def _load_control(cfg: CcsConfig):
    """Spike-in control reference: --tpu-control-fasta, or controls.fasta in
    the injected chemistry bundle (chemistry.md:32-41 mechanism)."""
    import os
    path = cfg.tpu_control_fasta
    if not path:
        bundle = os.environ.get("SMRT_CHEMISTRY_BUNDLE_DIR")
        if bundle and os.path.exists(os.path.join(bundle, "controls.fasta")):
            path = os.path.join(bundle, "controls.fasta")
    if not path:
        return None
    from ccs_tpu.io.fastq import read_fasta
    seqs = read_fasta(path)
    if not seqs:
        return None
    logger.info("Loaded spike-in control reference from %s", path)
    return next(iter(seqs.values()))


class CcsEngine:
    """Stateless-per-batch CCS engine over one set of Arrow parameters.

    Devices: all local devices form a 1-D ('zmw',) mesh
    (faq/parallelize.md:7-29 — ZMWs are embarrassingly parallel); window
    batches shard over it, parameter tables replicate.
    """

    def __init__(self, cfg: Optional[CcsConfig] = None,
                 params: Optional[ArrowParams] = None,
                 devices=None):
        from ccs_tpu.parallel.mesh import make_zmw_mesh, shard_fused_polish
        self.cfg = (cfg or CcsConfig()).resolve_mode_all()
        self.params = params or default_params()
        self.tables = hmm_jax.params_to_device(self.params)
        if devices is None:
            devices = jax.local_devices()
        if self.cfg.tpu_mesh_shape is not None:
            devices = devices[:int(np.prod(self.cfg.tpu_mesh_shape))]
        self.mesh = make_zmw_mesh(devices=devices)
        self.n_dev = len(devices)
        logger.info("devices: platform=%s kind=%s count=%d",
                    devices[0].platform, devices[0].device_kind, self.n_dev)
        import functools as _ft
        _mk = _ft.partial(
            shard_fused_polish, self.mesh, self.tables,
            max_iters=self.cfg.max_polish_iterations,
            thresh=self.cfg.tpu_polish_thresh)
        # candidate-sparse step (C7: only flagged positions may be
        # selected, performance.md:90-93) for default chunks; the dense
        # step serves --disable-heuristics / tandem-repeat ZMWs.
        # Both are lazy-compiled on first use.
        self._polish_step = _mk(sparse=True)
        self._polish_step_dense = _mk(sparse=False)
        self._dc_refine = None
        if self.cfg.tpu_dc_polish:
            import functools
            import os
            from ccs_tpu.models.dc_polisher import DcModel, builtin_model, \
                refine_chunk
            bundle = os.environ.get("SMRT_CHEMISTRY_BUNDLE_DIR")
            dc_path = bundle and os.path.join(bundle, "dc_model.npz")
            model = (DcModel.load(dc_path)
                     if dc_path and os.path.exists(dc_path)
                     else builtin_model())
            if model is None:
                # Loud failure (VERDICT r3 weak 8): a user asking for the
                # Revio-style refinement stage must not silently get
                # unrefined output (revio.md:29-53)
                raise RuntimeError(
                    "--tpu-dc-polish requested but no model is available: "
                    "no built-in models/data/dc_v0.npz and no dc_model.npz "
                    "in SMRT_CHEMISTRY_BUNDLE_DIR")
            logger.info("DC window refinement enabled (ctx=%d, conf=%.1f)",
                        model.ctx, model.conf)
            self._dc_refine = jax.jit(functools.partial(
                refine_chunk, model.tree(), model.ctx, self.tables,
                qv_thresh=self.cfg.tpu_dc_qv_thresh,
                conf_thresh=model.conf,
                allow_sub=bool(model.sub_ok)))
        self.control = _load_control(self.cfg)
        # device-side summary counters, psum-reduced across the mesh (P5)
        self.polish_stats = np.zeros(3, np.int64)
        # wall-time split (SURVEY §5 tracing row): prepare is summed across
        # the -j pool threads; device/finalize run on the main thread
        import threading as _th
        self._t_lock = _th.Lock()
        self.t_prepare = 0.0   # thread-seconds in prepare_batch
        self.t_device = 0.0    # seconds blocked on the device step
        self.t_finalize = 0.0  # seconds in host stitch/finalize
        # device-pipeline busy time: union of the wall intervals during
        # which >=1 chunk is in flight (dispatched, not yet collected) —
        # collect-block time alone undercounts overlapped execution.
        self._outstanding = 0
        self._busy_t0 = 0.0
        self.t_busy = 0.0
        # bucket grids (window counts rounded up to mesh divisibility)
        self.w_buckets = tuple(sorted(
            -(-w // self.n_dev) * self.n_dev
            for w in self.cfg.tpu_window_buckets))
        cap = self.cfg.tpu_window_coverage_cap
        self.c_buckets = tuple(
            c for c in sorted(self.cfg.tpu_coverage_buckets) if c <= cap)
        if not self.c_buckets or self.c_buckets[-1] < cap:
            self.c_buckets = self.c_buckets + (cap,)

    def process_batch(self, zmws: Sequence[ZmwInput]) -> list[ConsensusResult]:
        """Process a batch of ZMWs end to end. Order-preserving. In
        --by-strand mode each input ZMW yields up to two results
        (/fwd and /rev; mode-by-strand.md:7-23)."""
        return self.finalize_batch(self.prepare_batch(zmws))

    def prepare_batch(self, zmws: Sequence[ZmwInput]) -> list[ZmwWorkItem]:
        """Host phase: filters/draft/align/window for a batch (thread-safe —
        pure per-ZMW work, no engine state mutation). Runs on the prepare
        pool of the orchestrator (P4)."""
        import time as _time
        _t0 = _time.monotonic()
        try:
            return self._prepare_batch(zmws)
        finally:
            with self._t_lock:
                self.t_prepare += _time.monotonic() - _t0

    def _prepare_batch(self, zmws: Sequence[ZmwInput]) -> list[ZmwWorkItem]:
        return prepare_many(zmws, self.cfg, self.params, self.control)

    def finalize_batch(self, items: list[ZmwWorkItem]) -> list[ConsensusResult]:
        """Device phase + stitch: polish all live items, return results."""
        live = [it for it in items if not it.terminal]
        if live:
            self._polish_live(live)
        results = [it.result for it in items]
        for res in results:
            if res.is_control:
                # spike-in controls never count as HiFi yield
                # (fail-reads.md 0x2, reports-aux-files.md control rows)
                from ccs_tpu.pipeline.adapters import FF_CONTROL
                res.ff |= FF_CONTROL
                res.status = (ZmwStatus.CONTROL_SUCCESS
                              if res.status == ZmwStatus.SUCCESS
                              else ZmwStatus.CONTROL_FAILURE)
        return results

    # -- device phase --
    def _c_bucket(self, c: int) -> int:
        for cb in self.c_buckets:
            if c <= cb:
                return cb
        logger.warning(
            "window coverage %d exceeds tpu_window_coverage_cap %d; "
            "extra passes are dropped for polishing (raise the cap or "
            "--top-passes to keep them)", c, self.c_buckets[-1])
        return self.c_buckets[-1]

    def _polish_live(self, live: list[ZmwWorkItem]) -> None:
        """Flatten windows into fixed-shape bucketed chunks, polish on the
        mesh, scatter results back per ZMW, finalize."""
        cfg = self.cfg
        t_cap = cfg.tpu_window_tpl_cap

        # rows: (item, window index, n_cand) grouped by (coverage bucket,
        # exhaustive?) — exhaustive chunks run the dense kernel program,
        # default chunks the candidate-sparse one (C7)
        by_cb: dict[tuple[int, bool], list[tuple[ZmwWorkItem, int, int]]] = {}
        stage: dict[int, dict] = {}
        for it in live:
            b = it.batch
            exhaustive = (cfg.disable_heuristics
                          or it.result.has_tandem_repeat)
            cb = self._c_bucket(int(b.reads.shape[1]))
            rows = by_cb.setdefault((cb, exhaustive), [])
            ncand = (b.priority > 0).sum(axis=1)
            for w in range(len(b.windows)):
                rows.append((it, w, int(ncand[w])))
            n = len(b.windows)
            stage[id(it)] = {
                "tpl": np.full((n, t_cap), -1, np.int8),
                "tlen": np.ones(n, np.int32),
                "cs": np.zeros(n, np.int32),
                "ce": np.zeros(n, np.int32),
                "qv": np.zeros((n, t_cap), np.float32),
                "conv": np.ones(n, bool),
            }

        # dispatch pipelining: jax dispatch is async, so submitting chunk
        # k+1 before materializing chunk k overlaps device execution with
        # host scatter. A dedicated collector thread drains results, so the
        # blocking result pull does not serialize behind the submits on
        # this thread. The queue holds at most 3 submitted chunks.
        import queue as _queue
        import threading as _threading
        pend_q: _queue.Queue = _queue.Queue(maxsize=3)
        col_err: list[BaseException] = []
        _DONE = object()

        def _collector():
            while True:
                h = pend_q.get()
                if h is _DONE:
                    return
                try:
                    self._collect_chunk(h, stage)
                except BaseException as exc:  # noqa: BLE001
                    col_err.append(exc)
                    return

        col_t = _threading.Thread(target=_collector, daemon=True,
                                  name="ccs-collect")
        col_t.start()
        try:
            for (cb, exhaustive), rows in sorted(by_cb.items()):
                pos = 0
                while pos < len(rows) and not col_err:
                    take = min(len(rows) - pos, self.w_buckets[-1])
                    chunk = rows[pos:pos + take]
                    pos += take
                    pend_q.put(self._submit_chunk(chunk, cb, exhaustive))
        finally:
            # deliver the sentinel even if the collector died with the
            # queue full (drop queued work then — the run is failing)
            while True:
                try:
                    pend_q.put(_DONE, timeout=0.2)
                    break
                except _queue.Full:
                    if col_err:
                        try:
                            pend_q.get_nowait()
                        except _queue.Empty:
                            pass
            col_t.join()
        if col_err:
            raise col_err[0]

        import time as _time
        _t0 = _time.monotonic()
        for it in live:
            st = stage[id(it)]
            try:
                it.result = finalize_zmw(
                    it, st["tpl"], st["tlen"], st["cs"], st["ce"],
                    st["qv"], st["conv"], self.cfg,
                    qv_rq=st.get("qv_rq"))
            except Exception:  # noqa: BLE001
                logger.exception("finalize failed for ZMW %s", it.zmw.hole)
                it.result.status = ZmwStatus.EXCEPTION_THROWN
        self.t_finalize += _time.monotonic() - _t0

    def _submit_chunk(self, chunk, c_pad: int, exhaustive: bool = False):
        """Build the padded bucket arrays and dispatch the polish step
        asynchronously; returns a handle for _collect_chunk."""
        cfg = self.cfg
        t_cap = cfg.tpu_window_tpl_cap
        r_cap = cfg.tpu_window_read_cap
        W = next(wb for wb in self.w_buckets if wb >= len(chunk))

        tpl = np.full((W, t_cap), -1, np.int8)
        tlen = np.ones(W, np.int32)
        cs = np.zeros(W, np.int32)
        ce = np.zeros(W, np.int32)
        snr_bin = np.zeros(W, np.int32)
        reads = np.full((W, c_pad, r_cap), -1, np.int8)
        rlens = np.full((W, c_pad), -1, np.int32)
        is_first = np.zeros(W, dtype=bool)
        priority = np.zeros((W, t_cap), np.float32)

        # sort rows by (coverage, candidate count, template length).
        # Deterministic (stable sort) and order-safe: _collect_chunk
        # scatters back by the same list.
        chunk.sort(key=lambda row: (min(row[0].batch.reads.shape[1], c_pad),
                                    row[2],
                                    int(row[0].batch.tlen[row[1]])))
        # fill grouped by item with fancy indexing, not a per-window
        # Python pass on the main thread
        by_item: dict[int, list[int]] = {}
        for i, (it, w, _nc) in enumerate(chunk):
            by_item.setdefault(id(it), []).append(i)
            is_first[i] = (w == 0)
        for rows_l in by_item.values():
            rows = np.asarray(rows_l, np.intp)
            it = chunk[rows_l[0]][0]
            b = it.batch
            ws = np.asarray([chunk[i][1] for i in rows_l], np.intp)
            cc = min(b.reads.shape[1], c_pad)
            tpl[rows] = b.tpl[ws]
            tlen[rows] = b.tlen[ws]
            cs[rows] = b.core_start[ws]
            ce[rows] = b.core_end[ws]
            snr_bin[rows] = it.snr_bin
            reads[rows, :cc] = b.reads[ws, :cc]
            rlens[rows, :cc] = b.rlens[ws, :cc]
            if exhaustive:
                priority[rows] = 1.0
            else:
                priority[rows] = b.priority[ws]

        step = self._polish_step_dense if exhaustive else self._polish_step
        state, qv, stats = step(
            tpl, tlen, cs, ce, snr_bin, reads, rlens, is_first, priority)
        import time as _time
        with self._t_lock:
            if self._outstanding == 0:
                self._busy_t0 = _time.monotonic()
            self._outstanding += 1
        qv_rq = None
        if self._dc_refine is not None:
            # Revio-shaped learned refinement of low-QV windows
            # (revio.md:29-53); qv_rq carries the model's QVs for the rq
            # stream, qv the Arrow re-scores of the refined sequence
            ntpl, nlen, ncs, nce, qv, qv_rq, _proc = self._dc_refine(
                state, qv, reads, rlens, snr_bin)
            state = state._replace(tpl=ntpl, tlen=nlen,
                                   core_start=ncs, core_end=nce)
        return (chunk, state, qv, qv_rq, stats)

    def _collect_chunk(self, handle, stage: dict) -> None:
        chunk, state, qv, qv_rq, stats = handle
        import time as _time
        _t0 = _time.monotonic()
        # one batched device_get for all outputs of the chunk
        pulls = jax.device_get(
            (stats, state.tpl, state.tlen, state.core_start,
             state.core_end, qv, state.active)
            + ((qv_rq,) if qv_rq is not None else ()))
        s, out_tpl, out_tlen, out_cs, out_ce, out_qv, nonconv = pulls[:7]
        out_qv_rq = pulls[7] if qv_rq is not None else None
        if getattr(self._polish_step, "stats_sharded", False):
            s = np.asarray(s).reshape(-1, 3).sum(axis=0)
        _now = _time.monotonic()
        with self._t_lock:
            self.t_device += _now - _t0
            self._outstanding -= 1
            if self._outstanding == 0:
                self.t_busy += _now - self._busy_t0
            self.polish_stats += s  # [n_converged, total_iters, yield_bases]

        by_item: dict[int, list[int]] = {}
        for i, (it, _w, _nc) in enumerate(chunk):
            by_item.setdefault(id(it), []).append(i)
        for key, rows_l in by_item.items():
            st = stage[key]
            rows = np.asarray(rows_l, np.intp)
            ws = np.asarray([chunk[i][1] for i in rows_l], np.intp)
            st["tpl"][ws] = out_tpl[rows]
            st["tlen"][ws] = out_tlen[rows]
            st["cs"][ws] = out_cs[rows]
            st["ce"][ws] = out_ce[rows]
            st["qv"][ws] = out_qv[rows]
            if out_qv_rq is not None:
                st.setdefault("qv_rq",
                              np.zeros_like(st["qv"]))[ws] = out_qv_rq[rows]
            st["conv"][ws] = ~nonconv[rows]
