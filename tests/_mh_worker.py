"""Subprocess entry for the REAL 2-process multihost test
(tests/test_multihost.py::test_two_process_distributed).

argv: host_id num_hosts coordinator in_bam out_bam

Runs one host's share of a multihost CCS run with jax.distributed over the
coordinator (CPU backend — the same multi-process path as a GPU host, with
the cross-process collective included), then proves int64 counter
exactness past 2^24 with a psum of 2^40-scale values."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"


def main() -> int:
    i, n, coord, in_bam, out_bam = sys.argv[1:6]
    from ccs_tpu.cli import run
    from ccs_tpu.compile_cache import configure_compile_cache

    configure_compile_cache()

    rc = run([in_bam, out_bam, "--tpu-num-hosts", n, "--tpu-host-id", i,
              "--tpu-coordinator", coord])
    if rc != 0:
        return rc
    import numpy as np

    from ccs_tpu.parallel.multihost import allreduce_counters

    tot = allreduce_counters(
        np.asarray([2 ** 40 + int(i), int(i)], np.int64), True)
    print(f"PSUM {int(tot[0])} {int(tot[1])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
