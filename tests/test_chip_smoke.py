"""chip_smoke.py: its phases at tiny sizes on the CPU, its refusal to run
without a GPU, bench.py's peak table, and (marked ``gpu``) the scorer on a
card when one is present."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cpu():
    import jax
    return jax.devices("cpu")[0]


def test_phase_device_on_cpu():
    devs = cs.phase_device("cpu", card_info=False)
    assert devs[0].platform == "cpu"
    with pytest.raises(cs.SmokeFailure):
        cs.phase_device("gpu", card_info=False)


def test_phase_scorer_tiny(cpu):
    """Compile, time and check both polish steps at W=8 on the CPU."""
    times = cs.phase_scorer(cpu, cpu, n_windows=8, covs=(4,), n_slice=4,
                            n_rep=1)
    assert set(times) == {("sparse", 4), ("dense", 4)}
    assert all(t > 0 for t in times.values())


def test_brute_force_lls_detects_a_wrong_score(cpu):
    """The slice check's reference is sharp: a template's own LL differs
    from that of a one-base substitution by far more than the limit."""
    import jax
    from ccs_tpu.models.chemistry import default_params
    from ccs_tpu.ops.hmm_jax import params_to_device
    from ccs_tpu.sim.simulator import simulate_window_batch
    params = default_params()
    with jax.default_device(cpu):
        tables = params_to_device(params)
    a = simulate_window_batch(2, 4, np.random.default_rng(1), params)
    t0 = int(a[0][0, 0])
    m = (t0 + 1) % 4                       # slot 0..3: substitute at 0
    ll0, lls = cs.brute_force_lls(a[0], a[1], a[4], a[5], a[6], [(0, m)],
                                  tables, cpu, chunk=4)
    assert ll0.shape == (2,)
    assert abs(lls[(0, m)] - ll0[0]) > 100 * cs.MUT_TOL


def test_phase_cli_tiny(cpu, tmp_path):
    cs.phase_cli(str(tmp_path), cpu, n_short=3, short_len=300, n_long=1,
                 long_len=600, passes=8, n_compare=2, min_success=0.5,
                 watch_card=False)
    assert os.path.exists(tmp_path / "out.bam.pbi")


def test_phase_mesh_tiny():
    import jax
    cs.phase_mesh(jax.devices()[:4], n_zmws=4, insert_len=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_script_fails_without_gpu(where, tmp_path):
    """On the CPU, and in a directory without the package, the script
    exits non-zero and never prints a result."""
    if where == "checkout":
        cwd, script = ROOT, os.path.join(ROOT, "chip_smoke.py")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
    else:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), script)
        cwd = str(tmp_path)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("kind,known", [("NVIDIA H100 80GB HBM3", True),
                                        ("cpu", False)])
def test_bench_peaks(kind, known):
    """bench.py's peak table: H100 from the data sheet; an unknown device
    is an error, not a default."""
    import bench
    if known:
        p = bench.device_peaks(kind)
        assert p["fp32_flop_per_s"] == 67e12
        assert p["hbm_bytes_per_s"] == 3.35e12
    else:
        with pytest.raises(KeyError):
            bench.device_peaks(kind)


@pytest.mark.gpu
def test_scorer_on_card(gpu_device, cpu):
    """The engine's polish steps on the card, checked against the CPU
    reference (run with JAX_PLATFORMS=cuda,cpu)."""
    cs.phase_scorer(gpu_device, cpu, n_windows=256, covs=(16,), n_slice=16,
                    n_rep=2)
