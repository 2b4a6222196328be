"""Device mesh + sharded polish step (components P1/P2/P5, SURVEY.md §2.2).

The reference's only parallelism is data parallelism over ZMWs (thread pool
in-node, ``--chunk`` across nodes; /root/reference/docs/faq/parallelize.md:7-29).
The device equivalent is a 1-D ``('zmw',)`` mesh: window batches shard
over it, Arrow parameter tables replicate, and the only collective is the
summary-stat psum at the end (NCCL on a GPU mesh). ZMWs never communicate,
so no point-to-point is needed.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def psum_on_mesh(devices) -> bool:
    """Whether the polish step reduces its stats with an on-mesh psum.

    Off only on CPU meshes: XLA:CPU aborts the whole process when the
    participants of a collective reach it more than 40 s apart (the
    rendezvous termination timeout), which long polish programs on
    oversubscribed host cores can always hit. There the stats come back
    per shard and the host sums them. GPU meshes carry the psum over NCCL.
    """
    return devices[0].platform != "cpu"


def make_zmw_mesh(n_devices: Optional[int] = None,
                  devices=None) -> Mesh:
    """1-D data-parallel mesh over ZMWs/windows."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), ("zmw",), devices=np.asarray(devices))


def shard_fused_polish(mesh: Mesh, tables: dict, max_iters: int = 40,
                       thresh: float = 0.02,
                       use_psum: Optional[bool] = None,
                       sparse: bool = False):
    """Sharded fused polish step over the ('zmw',) mesh — the PRODUCT path.

    Window batches shard on their leading axis across all mesh devices
    (P1/P2); parameter tables replicate (L1). Each shard iterates until its
    own windows converge — no cross-device lock-step; the only collective is
    the psum over the per-shard summary counters (P5 — the report
    all-reduce, the device analog of merging chunked ccs_report counts;
    parallelize.md:15-29). Returns a jitted
    fn(tpl, tlen, cs, ce, snr_bin, reads, rlens, is_first, priority) ->
    (state, qv, stats) with stats = [n_converged, total_iters, yield_bases]
    reduced across the mesh (psum_on_mesh decides when ``use_psum`` is
    None). Leading axes must be divisible by the mesh size.
    """
    from ccs_tpu.pipeline.polish_fused import polish_windows_fused_impl

    n_dev = int(np.prod(list(mesh.shape.values())))
    if use_psum is None:
        use_psum = psum_on_mesh(mesh.devices.flat)

    def step(tables_arg, tpl, tlen, cs, ce, snr_bin, reads, rlens, is_first,
             priority):
        state, qv, _p_err = polish_windows_fused_impl(
            tpl, tlen, cs, ce, snr_bin, reads, rlens, tables_arg,
            max_iters=max_iters, is_first=is_first, priority=priority,
            thresh=thresh, sparse=sparse)
        live = (rlens >= 0).any(-1)
        n_conv = jnp.sum((~state.active & live).astype(jnp.int32))
        total_iters = jnp.sum(state.n_iter)
        yield_bases = jnp.sum(jnp.where(
            live, jnp.maximum(state.core_end - state.core_start, 0), 0))
        stats = jnp.stack([n_conv, total_iters, yield_bases])
        if n_dev > 1 and use_psum:
            stats = jax.lax.psum(stats, "zmw")
        return state, qv, stats

    if n_dev == 1:
        # single device: plain jit — shard_map adds nothing but compile time
        jfn = jax.jit(step)
        tables_repl = tables
    else:
        # without psum (CPU meshes, see psum_on_mesh) stats come back
        # per shard and the caller sums them on the host
        smapped = jax.shard_map(
            step, mesh=mesh,
            in_specs=(P(),) + (P("zmw"),) * 9,
            out_specs=(P("zmw"), P("zmw"),
                       P() if use_psum else P("zmw")),
            check_vma=False)
        repl = NamedSharding(mesh, P())
        tables_repl = jax.device_put(
            tables, jax.tree.map(lambda _: repl, tables))
        jfn = jax.jit(smapped)

    data_sharding = (None if n_dev == 1
                     else NamedSharding(mesh, P("zmw")))

    def fn(*args):
        # explicit async device_put of host arrays, placed with the step's
        # input sharding, so the upload can overlap the previous call's
        # execution
        args = tuple(a if isinstance(a, jax.Array)
                     else jax.device_put(a, data_sharding) for a in args)
        return jfn(tables_repl, *args)

    # the jitted program and its replicated tables, for ahead-of-time
    # lowering: fn._jitted.lower(fn.tables, *args).compile()
    fn._jitted = jfn
    fn.tables = tables_repl
    fn.stats_sharded = bool(n_dev > 1 and not use_psum)
    return fn


def device_put_sharded_batch(mesh: Mesh, arrays: tuple):
    """Place host window arrays onto the mesh, sharded over axis 0."""
    data = NamedSharding(mesh, P("zmw"))
    return tuple(jax.device_put(a, data) for a in arrays)
