"""Multi-device tests on the 8-virtual-CPU mesh (SURVEY.md §4.2(5)).

The contract mirrors the reference's --chunk guarantee
(/root/reference/docs/faq/parallelize.md:15-29): N-way sharded processing
must produce the same results as a single-device run.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ccs_tpu.models.chemistry import default_params
from ccs_tpu.ops.hmm_jax import params_to_device
from ccs_tpu.parallel.mesh import (device_put_sharded_batch, make_zmw_mesh,
                                   psum_on_mesh, shard_fused_polish)
from ccs_tpu.pipeline.polish_fused import polish_windows_fused
from ccs_tpu.sim.simulator import simulate_read


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    params = default_params()
    tables = params_to_device(params)
    B, C, T_CAP, R_CAP = 16, 8, 48, 56
    tpl = np.full((B, T_CAP), -1, np.int8)
    tlen = np.zeros(B, np.int32)
    reads = np.full((B, C, R_CAP), -1, np.int8)
    rlens = np.full((B, C), -1, np.int32)
    for b in range(B):
        tl = int(rng.integers(22, 30))
        t = rng.integers(0, 4, tl).astype(np.int8)
        corrupt = t.copy()
        p = int(rng.integers(0, tl))
        corrupt[p] = (corrupt[p] + 1) % 4
        tpl[b, :tl] = corrupt
        tlen[b] = tl
        for c in range(C):
            r = simulate_read(t, params, 3, rng)[:R_CAP]
            reads[b, c, :len(r)] = r
            rlens[b, c] = len(r)
    args = tuple(jnp.asarray(x) for x in
                 (tpl, tlen, np.full(B, 4, np.int32), tlen - 4,
                  np.full(B, 3, np.int32), reads, rlens,
                  np.zeros(B, dtype=bool)))
    return args, tables


@pytest.mark.parametrize("platform,want", [("cpu", False), ("gpu", True)])
def test_psum_rule(platform, want):
    """The stats psum is off only on CPU meshes; GPU meshes reduce on the
    mesh (NCCL)."""
    from types import SimpleNamespace
    assert psum_on_mesh([SimpleNamespace(platform=platform)] * 4) is want


class TestMesh:
    def test_eight_devices_available(self):
        assert len(jax.devices()) >= 8

    def test_sharded_equals_single(self, batch):
        """The PRODUCT path: 8-way fused polish == single-device fused
        polish, with the psum'd stats matching a local reduction (the
        --chunk-merge contract, parallelize.md:15-29)."""
        args, tables = batch
        B = args[0].shape[0]
        priority = jnp.ones((B, args[0].shape[1]), jnp.float32)
        # single-device reference
        state1, qv1, _ = polish_windows_fused(*args[:7], tables, max_iters=6,
                                              is_first=args[7])
        # 8-way sharded
        mesh = make_zmw_mesh(8)
        fn = shard_fused_polish(mesh, tables, max_iters=6, use_psum=True)
        sharded = device_put_sharded_batch(mesh, args + (priority,))
        state8, qv8, stats = fn(*sharded)
        np.testing.assert_array_equal(np.asarray(state1.tpl),
                                      np.asarray(state8.tpl))
        np.testing.assert_array_equal(np.asarray(state1.tlen),
                                      np.asarray(state8.tlen))
        np.testing.assert_allclose(np.asarray(qv1), np.asarray(qv8),
                                   rtol=1e-4, atol=1e-3)
        # psum'd stats agree with a local reduction over the same batch
        live = (np.asarray(args[6]) >= 0).any(-1)
        assert int(stats[0]) == int((~np.asarray(state1.active) & live).sum())
        want_yield = int(np.where(
            live, np.maximum(np.asarray(state1.core_end)
                             - np.asarray(state1.core_start), 0), 0).sum())
        assert int(stats[2]) == want_yield

    def test_dryrun_multichip(self):
        import __graft_entry__ as g
        g.dryrun_multichip(8)
