"""Host prepare for a batch of ZMWs, kept free of jax.

The orchestrator runs this module in spawn worker processes. It imports
only the NumPy and native prepare path, never jax, so a worker cannot open
the accelerator: a JAX process reserves most of a card's memory when it
first uses it, and a second process on the card would then fail.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Sequence

from ccs_tpu.config import CcsConfig
from ccs_tpu.pipeline.zmw import (ConsensusResult, ZmwInput, ZmwWorkItem,
                                  prepare_zmw, split_by_strand)
from ccs_tpu.statuses import ZmwStatus

logger = logging.getLogger("ccs_tpu")


def prepare_many(zmws: Sequence[ZmwInput], cfg: CcsConfig, params,
                 control) -> list[ZmwWorkItem]:
    """Host prepare for a batch — a PURE function of (zmws, cfg, params,
    control) so the orchestrator can run it in worker PROCESSES, where the
    Python share of prepare does not serialize under the GIL."""
    work: list[tuple[ZmwInput, str]] = []
    for z in zmws:
        if cfg.by_strand:
            f, r = split_by_strand(z)
            work.append((f, "fwd"))
            work.append((r, "rev"))
        else:
            work.append((z, ""))

    items: list[ZmwWorkItem] = []
    for z, strand in work:
        try:
            item = prepare_zmw(z, cfg, params.snr_edges,
                               control=control, params=params)
        except Exception:  # noqa: BLE001 — failures are data (SURVEY §5)
            logger.exception("prepare failed for ZMW %s", z.hole)
            res = ConsensusResult(hole=z.hole, movie=z.movie,
                                  status=ZmwStatus.EXCEPTION_THROWN)
            item = ZmwWorkItem(z, res, None)
        if (cfg.hd_finder and not strand
                and item.result.status == ZmwStatus.HETERODUPLEXES):
            # --hd-finder: split the heteroduplex ZMW on the fly into
            # single-strand runs (mode-heteroduplex-filtering.md:25-39)
            ss_cfg = dataclasses.replace(cfg, by_strand=True, hd_finder=False)
            for zz, ss in zip(split_by_strand(z), ("fwd", "rev")):
                try:
                    ss_item = prepare_zmw(zz, ss_cfg, params.snr_edges,
                                          control=control, params=params)
                except Exception:  # noqa: BLE001
                    logger.exception("ss prepare failed for ZMW %s", z.hole)
                    ss_res = ConsensusResult(
                        hole=z.hole, movie=z.movie,
                        status=ZmwStatus.EXCEPTION_THROWN)
                    ss_item = ZmwWorkItem(zz, ss_res, None)
                ss_item.result.strand = ss
                items.append(ss_item)
            continue
        item.result.strand = strand
        items.append(item)
    return items


def prepare_task(zmws, cfg, params, control):
    """Process-pool task: (items, thread-seconds spent)."""
    t0 = time.monotonic()
    items = prepare_many(zmws, cfg, params, control)
    return items, time.monotonic() - t0
