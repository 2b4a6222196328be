"""Subread simulator: samples reads from the same Arrow HMM used for scoring.

SURVEY.md §4.2(3): polishing simulated subreads must recover the template and
produce calibrated QVs — this is the multi-ZMW integration fixture that needs
no real data. Also used to synthesize subreads.bam files for end-to-end tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ccs_tpu.io.bam import BamHeader, BamRecord, BamWriter
from ccs_tpu.io.pbi import build_index_from_records, write_pbi
from ccs_tpu.models.chemistry import ArrowParams, default_params
from ccs_tpu.ops import dna

# Local context flags (cx tag): ADAPTER_BEFORE | ADAPTER_AFTER = full-length pass
CX_ADAPTER_BEFORE = 1
CX_ADAPTER_AFTER = 2
CX_FULL = CX_ADAPTER_BEFORE | CX_ADAPTER_AFTER


def simulate_read(tpl: np.ndarray, params: ArrowParams, snr_bin: int,
                  rng: np.random.Generator,
                  return_classes: bool = False) -> np.ndarray:
    """Draw one read from the generative HMM (see models/chemistry.py).

    Vectorized over template positions: while the HMM sits at position j it
    emits a geometric number of branch/stick insertions (probability
    trans[j,1]+trans[j,2] of staying), then leaves via match (emit from
    emit_match) or delete. The branch/stick emissions at one position are
    exchangeable iid draws, so sampling counts first is distribution-
    identical to the sequential loop this replaces (which cost ~27 us/base
    in pure Python).

    ``return_classes`` additionally returns the per-base event class
    (0=match, 1=branch, 2=stick) so callers can sample kinetics
    conditioned on the event type (how-does-ccs-work.md:88-95 — real
    branch/stick events ride on distinctive short pulses)."""
    tpl = np.asarray(tpl, dtype=np.int64)
    T = len(tpl)
    if T == 0:
        e = np.empty(0, dtype=np.int8)
        return (e, e.copy()) if return_classes else e
    prev = np.concatenate([tpl[:1], tpl[:-1]])
    ctx = 4 * prev + tpl
    trans = params.trans[snr_bin][ctx]     # [T, 4] match/branch/stick/delete
    em = params.emit_match[snr_bin][ctx]
    es = params.emit_stick[snr_bin][ctx]
    p_stay = trans[:, 1] + trans[:, 2]
    k = rng.geometric(np.clip(1.0 - p_stay, 1e-9, 1.0)) - 1   # inserts at j
    leave_match = rng.random(T) < trans[:, 0] / np.maximum(
        trans[:, 0] + trans[:, 3], 1e-12)
    cum_em = np.cumsum(em, axis=1)
    mbase = np.minimum(
        (rng.random(T)[:, None] * cum_em[:, -1:] > cum_em).sum(axis=1), 3)
    parent = np.repeat(np.arange(T), k)
    K = len(parent)
    is_branch = rng.random(K) < (trans[:, 1] /
                                 np.maximum(p_stay, 1e-12))[parent]
    cum_es = np.cumsum(es, axis=1)[parent]
    sbase = np.minimum((rng.random(K)[:, None] * cum_es[:, -1:]
                        > cum_es).sum(axis=1), 3) if K else \
        np.empty(0, dtype=np.int64)
    ins_base = np.where(is_branch, tpl[parent], sbase)
    lens = k + leave_match.astype(np.int64)
    off = np.concatenate([[0], np.cumsum(lens)])
    out = np.empty(int(off[-1]), dtype=np.int8)
    rank = np.arange(K) - np.repeat(np.cumsum(k) - k, k)
    out[off[parent] + rank] = ins_base
    mj = np.nonzero(leave_match)[0]
    out[off[mj] + k[mj]] = mbase[mj]
    if not return_classes:
        return out
    cls = np.empty(int(off[-1]), dtype=np.int8)
    cls[off[parent] + rank] = np.where(is_branch, 1, 2).astype(np.int8)
    cls[off[mj] + k[mj]] = 0
    return out, cls


def sample_pw_frames(classes: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
    """Pulse-width frames per read base, conditioned on the event class.

    Real SMRT kinetics: genuine incorporations hold the polymerase longer
    (long pulses), while branch/stick artifacts are short spurious pulses —
    that correlation is why the documented model keys on PW
    (how-does-ccs-work.md:88-95). Matches draw frames centered ~18
    (mostly pw bins 2-3 of pw_edges=[10,24]), insertions centered ~7
    (mostly bins 1-2), with enough overlap that PW is informative, not
    deterministic."""
    classes = np.asarray(classes)
    lam = np.where(classes == 0, 18.0, 7.0)
    frames = rng.poisson(lam) + 1
    return np.clip(frames, 1, 255).astype(np.uint8)


@dataclasses.dataclass
class SimZmw:
    hole: int
    insert: np.ndarray              # true template (int8 codes)
    subreads: list[np.ndarray]      # subread sequences (int8 codes)
    strands: list[int]              # 0 = fwd, 1 = rev per subread
    cx: list[int]                   # local context flags per subread
    snr: np.ndarray                 # per-channel SNR (4,)
    pws: Optional[list] = None      # per-subread pw frames (uint8), event-
                                    # class-conditioned (sample_pw_frames)


def simulate_zmw(hole: int, insert_len: int, n_passes: int,
                 params: Optional[ArrowParams] = None,
                 rng: Optional[np.random.Generator] = None,
                 snr: float = 8.0,
                 first_partial: bool = False,
                 with_pw: bool = False) -> SimZmw:
    """Simulate one ZMW: a random insert sequenced ``n_passes`` times with
    alternating strand orientation (the SMRTbell rolling circle).
    ``with_pw`` samples event-class-conditioned pulse widths per base."""
    params = params or default_params()
    rng = rng or np.random.default_rng(hole)
    insert = rng.integers(0, 4, size=insert_len).astype(np.int8)
    snr_arr = np.asarray([snr] * 4, dtype=np.float32) + rng.normal(0, 0.5, 4).astype(np.float32)
    snr_bin = int(params.snr_bin(float(snr_arr.mean())))
    subreads, strands, cxs = [], [], []
    pws = [] if with_pw else None
    for p in range(n_passes):
        strand = p % 2
        tpl = dna.revcomp(insert) if strand else insert
        read, cls = simulate_read(tpl, params, snr_bin, rng,
                                  return_classes=True)
        pw = sample_pw_frames(cls, rng) if with_pw else None
        cx = CX_FULL
        if first_partial and p == 0:
            read = read[len(read) // 2:]
            pw = pw[len(pw) // 2:] if pw is not None else None
            cx = CX_ADAPTER_AFTER
        subreads.append(read)
        strands.append(strand)
        cxs.append(cx)
        if pws is not None:
            pws.append(pw)
    return SimZmw(hole=hole, insert=insert, subreads=subreads,
                  strands=strands, cx=cxs, snr=snr_arr, pws=pws)


def zmw_input(z: SimZmw, movie: str = "m_sim"):
    """The engine's ZmwInput for a simulated ZMW, with subread polymerase
    coordinates laid out as write_subreads_bam lays them out (40-base
    adapter gaps)."""
    from ccs_tpu.pipeline.zmw import Subread, ZmwInput
    subs, qpos = [], 0
    for read, cx in zip(z.subreads, z.cx):
        subs.append(Subread(seq=read, cx=cx, qs=qpos, qe=qpos + len(read)))
        qpos += len(read) + 40
    return ZmwInput(hole=z.hole, movie=movie, subreads=subs, snr=z.snr)


def simulate_heteroduplex_zmw(hole: int, insert_len: int, n_passes: int,
                              ins_len: int = 30,
                              params: Optional[ArrowParams] = None,
                              rng: Optional[np.random.Generator] = None,
                              snr: float = 8.0) -> SimZmw:
    """A heteroduplex molecule: the reverse strand carries an extra
    ``ins_len``-bp insertion the forward strand lacks
    (how-does-ccs-work.md:65-72)."""
    params = params or default_params()
    rng = rng or np.random.default_rng(hole)
    insert_f = rng.integers(0, 4, insert_len).astype(np.int8)
    mid = insert_len // 2
    extra = rng.integers(0, 4, ins_len).astype(np.int8)
    insert_r_template = np.concatenate([insert_f[:mid], extra, insert_f[mid:]])
    snr_arr = np.asarray([snr] * 4, dtype=np.float32)
    snr_bin = int(params.snr_bin(snr))
    subreads, strands, cxs = [], [], []
    for p in range(n_passes):
        strand = p % 2
        tpl = insert_f if strand == 0 else dna.revcomp(insert_r_template)
        subreads.append(simulate_read(tpl, params, snr_bin, rng))
        strands.append(strand)
        cxs.append(CX_FULL)
    return SimZmw(hole=hole, insert=insert_f, subreads=subreads,
                  strands=strands, cx=cxs, snr=snr_arr)


def make_subreads_header(movie: str = "m00001_260817_000000") -> BamHeader:
    ds = ("READTYPE=SUBREAD;BINDINGKIT=101-894-200;SEQUENCINGKIT=101-826-100;"
          "BASECALLERVERSION=5.0.0;FRAMERATEHZ=100.0")
    text = (
        "@HD\tVN:1.6\tSO:unknown\tpb:5.0.0\n"
        f"@RG\tID:sim0001\tPL:PACBIO\tDS:{ds}\tPU:{movie}\n"
    )
    return BamHeader(text)


def write_subreads_bam(path: str, zmws: list[SimZmw],
                       movie: str = "m00001_260817_000000",
                       with_kinetics: bool = False,
                       rng: Optional[np.random.Generator] = None) -> None:
    """Write a synthetic subreads.bam (+ .pbi) with the PacBio tag set."""
    rng = rng or np.random.default_rng(0)
    header = make_subreads_header(movie)
    records = []
    with BamWriter(path, header) as w:
        for z in zmws:
            qpos = 0
            pws = z.pws if z.pws is not None else [None] * len(z.subreads)
            for read, cx, pw in zip(z.subreads, z.cx, pws):
                qs, qe = qpos, qpos + len(read)
                qpos = qe + 40  # adapter gap in polymerase coordinates
                rec = BamRecord(name=f"{movie}/{z.hole}/{qs}_{qe}", seq=read, qual=None)
                rec.set_tag("zm", "i", int(z.hole))
                rec.set_tag("qs", "i", qs)
                rec.set_tag("qe", "i", qe)
                rec.set_tag("cx", "C", int(cx))
                rec.set_tag("np", "i", 1)
                rec.set_tag("sn", "B", z.snr, "f")
                rec.set_tag("rq", "f", 0.8)
                rec.set_tag("RG", "Z", b"sim0001")
                if with_kinetics or pw is not None:
                    n = len(read)
                    rec.set_tag("ip", "B",
                                rng.integers(4, 60, n).astype(np.uint8), "C")
                    if pw is None:
                        pw = rng.integers(4, 40, n).astype(np.uint8)
                    rec.set_tag("pw", "B", np.asarray(pw, np.uint8), "C")
                w.write_record(rec)
                records.append(rec)
        voffs = list(w.voffsets)
    write_pbi(path + ".pbi", build_index_from_records(records, voffs))


def simulate_window_batch(n_windows: int, cov: int, rng: np.random.Generator,
                          params: Optional[ArrowParams] = None,
                          t_cap: int = 44, r_cap: int = 39,
                          snr_bin: int = 4):
    """Polish-step inputs for ``n_windows`` real-shaped windows.

    Each window is a 26-32 bp random template with 0-1 injected
    substitutions, ``cov`` simulated read slices and the production
    candidate priorities (C7) from a real pileup vote, as prepare_zmw
    builds them. Rows are sorted by (candidate count, template length), as
    the engine's chunk fill does. Returns the engine step's argument tuple
    (tpl, tlen, cs, ce, snr_bin, reads, rlens, is_first, priority) as NumPy
    arrays with production caps ``t_cap`` x ``r_cap``."""
    from ccs_tpu.pipeline.draft import _pileup_consensus
    from ccs_tpu.pipeline.windows import candidate_priority_from_stats

    params = params or default_params()
    tpl = np.full((n_windows, t_cap), -1, np.int8)
    tlen = np.zeros(n_windows, np.int32)
    reads = np.full((n_windows, cov, r_cap), -1, np.int8)
    rlens = np.full((n_windows, cov), -1, np.int32)
    priority = np.zeros((n_windows, t_cap), np.float32)
    for b in range(n_windows):
        tl = int(rng.integers(26, 33))
        t = rng.integers(0, 4, tl).astype(np.int8)
        corrupt = t.copy()
        for _ in range(int(rng.integers(0, 2))):
            p = int(rng.integers(0, tl))
            corrupt[p] = (corrupt[p] + 1) % 4
        tpl[b, :tl] = corrupt
        tlen[b] = tl
        for c in range(cov):
            r = simulate_read(t, params, snr_bin, rng)[:r_cap]
            reads[b, c, :len(r)] = r
            rlens[b, c] = len(r)
        rds = [reads[b, c, :rlens[b, c]] for c in range(cov) if rlens[b, c] > 0]
        st = _pileup_consensus(corrupt, rds, want_stats=True)[4]
        if st is not None and len(st) == tl:
            priority[b, :tl] = candidate_priority_from_stats(corrupt, st)
        else:
            priority[b, :tl] = 1.0
    order = np.lexsort((tlen, (priority > 0).sum(axis=1)))
    tpl, tlen, reads, rlens, priority = (tpl[order], tlen[order],
                                         reads[order], rlens[order],
                                         priority[order])
    cs = np.full(n_windows, 4, np.int32)
    ce = tlen - 4
    return (tpl, tlen, cs, ce, np.full(n_windows, snr_bin, np.int32), reads,
            rlens, np.zeros(n_windows, bool), priority)
