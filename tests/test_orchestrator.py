"""P4 host pipelining: -j / --input-buffer have observable effects and the
pipeline is order-deterministic (byte-identical output vs the serial path)."""

import os
import threading
import time

import numpy as np
import pytest

from ccs_tpu.config import CcsConfig
from ccs_tpu.pipeline.engine import CcsEngine
from ccs_tpu.pipeline.orchestrator import run_pipeline
from ccs_tpu.pipeline.zmw import Subread, ZmwInput
from ccs_tpu.sim.simulator import simulate_zmw


def _zin(z, movie="m_orch"):
    subs, qpos = [], 0
    for read, cx in zip(z.subreads, z.cx):
        subs.append(Subread(seq=read, cx=cx, qs=qpos, qe=qpos + len(read)))
        qpos += len(read) + 40
    return ZmwInput(hole=z.hole, movie=movie, subreads=subs, snr=z.snr)


@pytest.fixture(scope="module")
def zmws():
    return [_zin(simulate_zmw(hole=h, insert_len=120, n_passes=6, snr=9.0))
            for h in range(12)]


@pytest.fixture(scope="module")
def engine():
    return CcsEngine(CcsConfig(min_rq=0.0, tpu_window_buckets=(64,)))


def _collect(engine, zmws, **kw):
    out = []
    run_pipeline(engine, iter(zmws), lambda r, n: out.extend(r), **kw)
    return out


def test_pipeline_matches_serial(engine, zmws):
    serial = engine.process_batch(zmws)
    piped = _collect(engine, zmws, batch_size=4, num_threads=2,
                     input_buffer=2)
    assert len(piped) == len(serial)
    for a, b in zip(serial, piped):
        assert a.hole == b.hole
        assert a.status == b.status
        if a.seq is not None:
            np.testing.assert_array_equal(a.seq, b.seq)
            np.testing.assert_allclose(a.qv, b.qv, atol=1e-4)


def test_num_threads_used(engine, zmws):
    # thread-pool fallback path (tpu_prepare_processes=0): the spy can see
    # the worker threads. The default PROCESS pool cannot be monkeypatched
    # from here; its fan-out is covered by test_process_pool_used.
    seen = set()
    orig = engine.prepare_batch

    def spy(batch):
        seen.add(threading.current_thread().name)
        time.sleep(0.05)
        return orig(batch)

    engine.prepare_batch = spy
    engine.cfg.tpu_prepare_processes = False
    try:
        _collect(engine, zmws, batch_size=4, num_threads=3, input_buffer=4)
    finally:
        engine.prepare_batch = orig
        engine.cfg.tpu_prepare_processes = True
    assert len(seen) >= 2, seen  # -j fans prepare over worker threads


def test_process_pool_used(engine, zmws):
    # default path: prepare fans out over worker PROCESSES (the GIL
    # serializes the Python share of prepare under threads)
    from ccs_tpu.pipeline import orchestrator as orch
    assert engine.cfg.tpu_prepare_processes
    out = _collect(engine, zmws, batch_size=4, num_threads=2,
                   input_buffer=4)
    assert orch._PROC_POOL is not None and orch._PROC_POOL_SIZE == 2
    assert len(out) == len(zmws)


def test_input_buffer_bounds_readahead(engine, zmws):
    # a slow consumer with input_buffer=1 must keep the reader ~1 batch ahead
    produced = []

    def gen():
        for z in zmws:
            produced.append(z.hole)
            yield z

    high_water = []
    orig = engine.prepare_batch

    def slow(batch):
        high_water.append(len(produced))
        time.sleep(0.05)
        return orig(batch)

    engine.prepare_batch = slow
    try:
        _collect(engine, list(gen()) and [], batch_size=4, num_threads=1,
                 input_buffer=1)  # warm nothing; real call below
        produced.clear()
        out = []
        run_pipeline(engine, gen(), lambda r, n: out.extend(r),
                     batch_size=4, num_threads=1, input_buffer=1)
    finally:
        engine.prepare_batch = orig
    # with buffer=1 and batch=4, the reader never runs unboundedly ahead:
    # at the first prepare at most ~(buffer+2)*batch ZMWs are read
    assert high_water[0] <= 12, high_water


def test_pipeline_propagates_errors(engine):
    def bad_iter():
        yield _zin(simulate_zmw(hole=0, insert_len=80, n_passes=5, snr=9.0))
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        run_pipeline(engine, bad_iter(), lambda r, n: None, batch_size=2,
                     num_threads=1, input_buffer=1)


def test_prepare_workers_stay_off_jax():
    """The module the spawn prepare workers import (pipeline.prepare) and
    the task they run never import jax, so a worker cannot open the
    accelerator."""
    import subprocess
    import sys
    code = ("import sys, pickle\n"
            "from ccs_tpu.pipeline import prepare\n"
            "from ccs_tpu.pipeline.orchestrator import run_pipeline\n"
            "pickle.loads(pickle.dumps(prepare.prepare_task))\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr
