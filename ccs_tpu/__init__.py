"""ccs_tpu — circular consensus sequencing (HiFi) engine on an accelerator.

A from-scratch re-implementation of the capabilities of PacBio's closed-source
``ccs`` tool (reference docs surveyed in SURVEY.md), built around a batched
device polish:

- host side: BAM/pbi/FASTQ I/O, windowing bookkeeping, stitching, reports
- device side: batched JAX DP programs (Arrow-style pair-HMM
  forward/backward, mutation scoring) over thousands of ZMWs per device
- scale-out: data-parallel ZMW sharding over a ``jax.sharding.Mesh``
  (the device analog of ``ccs --chunk`` + merge; docs/faq/parallelize.md:7-29)
"""

__version__ = "0.1.0"

from ccs_tpu.statuses import ZmwStatus  # noqa: F401
from ccs_tpu.config import CcsConfig  # noqa: F401
