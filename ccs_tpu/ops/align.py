"""Pairwise alignment: banded edit-distance with traceback + k-mer chaining.

Host-side equivalents of the reference's edlib/KSW2 usage
(docs/how-does-ccs-work.md:41-55). Design note:
base-exact full-length alignment is only used for *bookkeeping* — backbone
pileup for drafting, window boundary mapping, coverage/insertion checks. The
polishing itself marginalizes over alignments in the pair-HMM, so windows
tolerate ±few-bp fuzziness. That lets the hot path use cheap k-mer anchor
chaining; the banded DP here is vectorized NumPy (row-wise, with the
horizontal-move chain solved by a prefix-min trick).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

BIG = 1 << 30

# traceback moves
M_DIAG, M_UP, M_LEFT = 0, 1, 2  # diag = match/mismatch, up = ins in read, left = del


@dataclasses.dataclass
class Alignment:
    """Global alignment of read -> template."""
    score: int                 # total cost under (sub_cost, gap_cost)
    cigar: list[tuple[int, str]]  # [(length, op)] with ops M/I/D (I = extra read base)
    # per-template-position read coordinate: rpos_at[j] = read index aligned at
    # the start of template position j (monotone non-decreasing, len T+1)
    rpos_at: np.ndarray
    n_match: int = 0           # exact base matches within M columns

    def identity(self) -> float:
        total = sum(n for n, _ in self.cigar)
        return self.n_match / max(total, 1)


def band_width_for(rlen: int, tlen: int, frac: float = 0.18, base: int = 24) -> int:
    return int(base + frac * max(rlen, tlen)) + abs(rlen - tlen)


def edit_align(read: np.ndarray, tpl: np.ndarray,
               band: Optional[int] = None,
               sub_cost: int = 1, gap_cost: int = 1,
               centers: Optional[np.ndarray] = None) -> Optional[Alignment]:
    """Banded global alignment with traceback and configurable costs.

    With (1, 1) this is edit distance (edlib-equivalent). For SMRT subreads
    (indel-dominated, ~6:1 indel:mismatch) use ``sub_cost > gap_cost`` (e.g.
    3, 2) so indels are never absorbed as mismatch pairs — this keeps pileup
    votes for template indel corrections concentrated at one position (the
    role the reference's KSW2 scoring plays; how-does-ccs-work.md:53-55).

    Band is centered on the rescaled diagonal j ~= i * T/R, or on an
    explicit nondecreasing ``centers`` array (len R+1, e.g. interpolated from
    a k-mer anchor chain — makes long-read alignment O(R * W) with a narrow
    W). Returns None if the optimal path escapes the band (caller should
    widen and retry).

    Dispatches to the native C++ kernel (ccs_tpu.native) when available;
    the NumPy path below is the oracle/fallback (CCS_TPU_NO_NATIVE=1).
    """
    read = np.asarray(read, dtype=np.int8)
    tpl = np.asarray(tpl, dtype=np.int8)
    R, T = len(read), len(tpl)
    if R == 0:
        return Alignment(T * gap_cost, [(T, "D")] if T else [], np.zeros(T + 1, np.int64))
    if T == 0:
        return Alignment(R * gap_cost, [(R, "I")], np.zeros(1, np.int64))
    if band is None:
        band = band_width_for(R, T)
    W = min(band, T)
    width = 2 * W + 1

    # center column for each read row
    if centers is None:
        centers = np.round(np.arange(R + 1) * (T / R)).astype(np.int64)
    else:
        centers = np.asarray(centers, dtype=np.int64)
        assert len(centers) == R + 1
        centers = np.maximum.accumulate(np.clip(centers, 0, T))
        centers = centers.copy()
        centers[0], centers[-1] = 0, T  # endpoints must be reachable

    from ccs_tpu import native
    lib = native.load()
    if lib is not None:
        return _edit_align_native(lib, read, tpl, centers, W,
                                  sub_cost, gap_cost)

    # D[k] holds cost at column j = centers[i] - W + k
    cols_of = lambda i: centers[i] - W + np.arange(width)

    prev = np.full(width, BIG, dtype=np.int64)
    cols0 = cols_of(0)
    valid0 = (cols0 >= 0) & (cols0 <= T)
    prev[valid0] = cols0[valid0] * gap_cost  # row 0: all deletions
    moves = np.zeros((R, width), dtype=np.int8)

    for i in range(1, R + 1):
        shift = centers[i] - centers[i - 1]
        cols = cols_of(i)
        valid = (cols >= 0) & (cols <= T)
        # align prev row into current band frame
        if shift:
            prev_shifted = np.full(width, BIG, dtype=np.int64)
            if shift < width:
                prev_shifted[:width - shift] = prev[shift:]
        else:
            prev_shifted = prev
        # prev value at column j (for vertical move) = prev_shifted[k]
        # prev value at column j-1 (diag move) = prev_shifted[k-1]
        diag_prev = np.full(width, BIG, dtype=np.int64)
        diag_prev[1:] = prev_shifted[:-1]
        if 0 < shift <= width:  # column centers[i]-W-1 of prev frame
            diag_prev[0] = prev[shift - 1]
        jm1 = cols - 1
        tchar = np.where((jm1 >= 0) & (jm1 < T), tpl[np.clip(jm1, 0, T - 1)], -2)
        sub = diag_prev + np.where(tchar == read[i - 1], 0, sub_cost)
        sub[jm1 < 0] = BIG
        ins = prev_shifted + gap_cost
        tmp = np.minimum(sub, ins)
        move = np.where(sub <= ins, M_DIAG, M_UP).astype(np.int8)
        tmp[~valid] = BIG  # keep invalid columns out of the horizontal chain
        # horizontal chain: cur[k] = min over k' <= k of tmp[k'] + g*(k - k')
        garange = gap_cost * np.arange(width)
        shifted = tmp - garange
        runmin = np.minimum.accumulate(shifted)
        cur = runmin + garange
        move = np.where(cur < tmp, M_LEFT, move).astype(np.int8)
        cur[~valid] = BIG
        moves[i - 1] = move
        prev = cur

    # endpoint
    end_k = T - centers[R] + W
    if end_k < 0 or end_k >= width or prev[end_k] >= BIG:
        return None
    score = int(prev[end_k])

    # traceback from (R, T) to (0, 0); rpos_at[j] ends as the *lowest* read
    # index visited at template position j (i.e. before any insertions there)
    cigar_rev: list[str] = []
    rpos_at = np.zeros(T + 1, dtype=np.int64)
    n_match = 0
    i, k = R, end_k
    while True:
        j = centers[i] - W + k
        rpos_at[j] = i  # backward walk => final write is the lowest i for j
        if i == 0 and j == 0:
            break
        if i == 0:
            mv = M_LEFT
        elif j == 0:
            mv = M_UP
        else:
            mv = moves[i - 1][k]
        if mv == M_DIAG:
            n_match += int(read[i - 1] == tpl[j - 1])
            shift = centers[i] - centers[i - 1]
            i, k = i - 1, k - 1 + shift
            cigar_rev.append("M")
        elif mv == M_UP:
            shift = centers[i] - centers[i - 1]
            i, k = i - 1, k + shift
            cigar_rev.append("I")
        else:
            k -= 1
            cigar_rev.append("D")

    # run-length encode
    cigar: list[tuple[int, str]] = []
    for op in reversed(cigar_rev):
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    return Alignment(score, cigar, rpos_at, n_match)


def _edit_align_native(lib, read: np.ndarray, tpl: np.ndarray,
                       centers: np.ndarray, W: int,
                       sub_cost: int, gap_cost: int) -> Optional[Alignment]:
    """ctypes call into ccs_tpu/native/align.cpp (exact same DP/traceback)."""
    import ctypes
    R, T = len(read), len(tpl)
    read = np.ascontiguousarray(read, dtype=np.int8)
    tpl = np.ascontiguousarray(tpl, dtype=np.int8)
    centers = np.ascontiguousarray(centers, dtype=np.int64)
    rpos_at = np.zeros(T + 1, dtype=np.int64)
    ops_rev = np.empty(R + T + 2, dtype=np.int8)
    ops_len = np.zeros(1, dtype=np.int64)
    n_match = np.zeros(1, dtype=np.int64)
    score = lib.ccs_edit_align(
        read.ctypes.data_as(ctypes.c_void_p), R,
        tpl.ctypes.data_as(ctypes.c_void_p), T,
        centers.ctypes.data_as(ctypes.c_void_p), W,
        sub_cost, gap_cost,
        rpos_at.ctypes.data_as(ctypes.c_void_p),
        ops_rev.ctypes.data_as(ctypes.c_void_p),
        ops_len.ctypes.data_as(ctypes.c_void_p),
        n_match.ctypes.data_as(ctypes.c_void_p))
    if score < 0:
        return None
    ops = ops_rev[:int(ops_len[0])][::-1]
    cigar: list[tuple[int, str]] = []
    if len(ops):
        # vectorized run-length encode
        brk = np.nonzero(np.diff(ops))[0] + 1
        starts = np.concatenate([[0], brk])
        ends = np.concatenate([brk, [len(ops)]])
        names = {M_DIAG: "M", M_UP: "I", M_LEFT: "D"}
        cigar = [(int(e - s), names[int(ops[s])])
                 for s, e in zip(starts, ends)]
    return Alignment(int(score), cigar, rpos_at, int(n_match[0]))


def affine_align(read: np.ndarray, tpl: np.ndarray,
                 band: Optional[int] = None,
                 sub_cost: int = 6, gap_open: int = 2, gap_ext: int = 2,
                 centers: Optional[np.ndarray] = None) -> Optional[Alignment]:
    """Banded global alignment with AFFINE gap costs (Gotoh 3-matrix DP).

    The KSW2-equivalent of the reference (how-does-ccs-work.md:53-55): a
    k-base gap costs ``gap_open + k*gap_ext``, so multi-base indels collapse
    into one run instead of being scattered as alternating ops or absorbed
    as mismatch pairs. Defaults (6, 2, 2) keep single-base indels cheaper
    than substitutions (SMRT errors are indel-dominated) while long gaps pay
    per base.

    Same band framing / return contract as edit_align: band is centered on
    the rescaled diagonal or an explicit ``centers`` path; returns None if
    the optimal path escapes the band. Dispatches to the native C++ kernel
    (ccs_tpu.native) when available; NumPy is the oracle/fallback.
    """
    read = np.asarray(read, dtype=np.int8)
    tpl = np.asarray(tpl, dtype=np.int8)
    R, T = len(read), len(tpl)
    if R == 0:
        cigar = [(T, "D")] if T else []
        return Alignment(gap_open + T * gap_ext if T else 0, cigar,
                         np.zeros(T + 1, np.int64))
    if T == 0:
        return Alignment(gap_open + R * gap_ext, [(R, "I")],
                         np.zeros(1, np.int64))
    if band is None:
        band = band_width_for(R, T)
    W = min(band, T)
    width = 2 * W + 1

    if centers is None:
        centers = np.round(np.arange(R + 1) * (T / R)).astype(np.int64)
    else:
        centers = np.asarray(centers, dtype=np.int64)
        assert len(centers) == R + 1
        centers = np.maximum.accumulate(np.clip(centers, 0, T))
        centers = centers.copy()
        centers[0], centers[-1] = 0, T

    from ccs_tpu import native
    lib = native.load()
    if lib is not None and hasattr(lib, "ccs_affine_align"):
        return _affine_align_native(lib, read, tpl, centers, W,
                                    sub_cost, gap_open, gap_ext)

    cols_of = lambda i: centers[i] - W + np.arange(width)
    garange = gap_ext * np.arange(width)

    # row 0: pure deletion prefix — V = D state with one gap_open
    prevV = np.full(width, BIG, dtype=np.int64)
    prevI = np.full(width, BIG, dtype=np.int64)
    cols0 = cols_of(0)
    valid0 = (cols0 >= 0) & (cols0 <= T)
    prevV[valid0] = np.where(cols0[valid0] == 0, 0,
                             gap_open + cols0[valid0] * gap_ext)
    # per-row backpointers: V's choice, and extension bits for I and D chains
    vmoves = np.zeros((R, width), dtype=np.int8)
    iexts = np.zeros((R, width), dtype=bool)
    dexts = np.zeros((R + 1, width), dtype=bool)

    for i in range(1, R + 1):
        shift = centers[i] - centers[i - 1]
        cols = cols_of(i)
        valid = (cols >= 0) & (cols <= T)
        if shift:
            pVs = np.full(width, BIG, dtype=np.int64)
            pIs = np.full(width, BIG, dtype=np.int64)
            if shift < width:
                pVs[:width - shift] = prevV[shift:]
                pIs[:width - shift] = prevI[shift:]
        else:
            pVs, pIs = prevV, prevI
        diag_prevV = np.full(width, BIG, dtype=np.int64)
        diag_prevV[1:] = pVs[:-1]
        if 0 < shift <= width:
            diag_prevV[0] = prevV[shift - 1]
        jm1 = cols - 1
        tchar = np.where((jm1 >= 0) & (jm1 < T), tpl[np.clip(jm1, 0, T - 1)], -2)
        m_val = diag_prevV + np.where(tchar == read[i - 1], 0, sub_cost)
        m_val[jm1 < 0] = BIG
        # vertical (insertion) chain across rows
        i_open = np.minimum(pVs + gap_open + gap_ext, BIG)
        i_ext = np.minimum(pIs + gap_ext, BIG)
        i_val = np.minimum(i_open, i_ext)
        iexts[i - 1] = i_ext <= i_open
        # best non-deletion value per column
        u = np.minimum(m_val, i_val)
        vmove = np.where(m_val <= i_val, M_DIAG, M_UP).astype(np.int8)
        u_masked = np.where(valid, u, BIG)
        # horizontal (deletion) chain within the row via exclusive prefix-min:
        # D[k] = min_{k'<k} U[k'] + gap_open + gap_ext*(k-k')
        shifted = np.minimum(u_masked - garange, BIG)
        runmin = np.minimum.accumulate(shifted)
        d_val = np.full(width, BIG, dtype=np.int64)
        d_val[1:] = np.minimum(runmin[:-1] + garange[1:] + gap_open, BIG)
        d_val[~valid] = BIG
        d_val[jm1 < 0] = BIG
        # extension bit: D[k] reachable as D[k-1] + gap_ext (tie -> extend)
        dexts[i][1:] = (d_val[:-1] + gap_ext <= u_masked[:-1] + gap_open + gap_ext) \
            & (d_val[:-1] < BIG)
        curV = np.minimum(u_masked, d_val)
        vmove = np.where(d_val < u_masked, M_LEFT, vmove).astype(np.int8)
        curV[~valid] = BIG
        vmoves[i - 1] = vmove
        prevV, prevI = curV, np.where(valid, i_val, BIG)

    end_k = T - centers[R] + W
    if end_k < 0 or end_k >= width or prevV[end_k] >= BIG:
        return None
    score = int(prevV[end_k])

    # traceback with explicit Gotoh state (V / I-chain / D-chain)
    cigar_rev: list[str] = []
    rpos_at = np.zeros(T + 1, dtype=np.int64)
    n_match = 0
    i, k = R, end_k
    state = "V"
    while True:
        j = centers[i] - W + k
        rpos_at[j] = i
        if i == 0 and j == 0:
            break
        if state == "V":
            if i == 0:
                state = "D"
                continue
            if j == 0:
                state = "I"
                continue
            mv = vmoves[i - 1][k]
            if mv == M_DIAG:
                n_match += int(read[i - 1] == tpl[j - 1])
                shift = centers[i] - centers[i - 1]
                i, k = i - 1, k - 1 + shift
                cigar_rev.append("M")
            elif mv == M_UP:
                state = "I"
            else:
                state = "D"
        elif state == "I":
            was_ext = iexts[i - 1][k]
            shift = centers[i] - centers[i - 1]
            i, k = i - 1, k + shift
            cigar_rev.append("I")
            state = "I" if was_ext else "V"
        else:  # D
            was_ext = dexts[i][k]
            k -= 1
            cigar_rev.append("D")
            state = "D" if was_ext else "V"

    cigar: list[tuple[int, str]] = []
    for op in reversed(cigar_rev):
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    return Alignment(score, cigar, rpos_at, n_match)


def _affine_align_native(lib, read: np.ndarray, tpl: np.ndarray,
                         centers: np.ndarray, W: int, sub_cost: int,
                         gap_open: int, gap_ext: int) -> Optional[Alignment]:
    """ctypes call into ccs_tpu/native/align.cpp (same Gotoh DP/traceback)."""
    import ctypes
    R, T = len(read), len(tpl)
    read = np.ascontiguousarray(read, dtype=np.int8)
    tpl = np.ascontiguousarray(tpl, dtype=np.int8)
    centers = np.ascontiguousarray(centers, dtype=np.int64)
    rpos_at = np.zeros(T + 1, dtype=np.int64)
    ops_rev = np.empty(R + T + 2, dtype=np.int8)
    ops_len = np.zeros(1, dtype=np.int64)
    n_match = np.zeros(1, dtype=np.int64)
    score = lib.ccs_affine_align(
        read.ctypes.data_as(ctypes.c_void_p), R,
        tpl.ctypes.data_as(ctypes.c_void_p), T,
        centers.ctypes.data_as(ctypes.c_void_p), W,
        sub_cost, gap_open, gap_ext,
        rpos_at.ctypes.data_as(ctypes.c_void_p),
        ops_rev.ctypes.data_as(ctypes.c_void_p),
        ops_len.ctypes.data_as(ctypes.c_void_p),
        n_match.ctypes.data_as(ctypes.c_void_p))
    if score < 0:
        return None
    ops = ops_rev[:int(ops_len[0])][::-1]
    cigar: list[tuple[int, str]] = []
    if len(ops):
        brk = np.nonzero(np.diff(ops))[0] + 1
        starts = np.concatenate([[0], brk])
        ends = np.concatenate([brk, [len(ops)]])
        names = {M_DIAG: "M", M_UP: "I", M_LEFT: "D"}
        cigar = [(int(e - s), names[int(ops[s])])
                 for s, e in zip(starts, ends)]
    return Alignment(int(score), cigar, rpos_at, int(n_match[0]))


def align_with_retry(read: np.ndarray, tpl: np.ndarray,
                     max_band: Optional[int] = None,
                     sub_cost: int = 1, gap_cost: int = 1) -> Optional[Alignment]:
    """Widen the band geometrically until the path fits."""
    band = band_width_for(len(read), len(tpl))
    limit = max_band or max(len(read), len(tpl))
    while True:
        aln = edit_align(read, tpl, band, sub_cost=sub_cost, gap_cost=gap_cost)
        if aln is not None:
            return aln
        if band >= limit:
            return None
        band = min(band * 2, limit)


# ---------------------------------------------------------------------------
# k-mer anchor chaining (pancake-style seeding, host-side, vectorized)
# ---------------------------------------------------------------------------

def _kmer_codes(seq: np.ndarray, k: int) -> np.ndarray:
    """Packed 2-bit k-mer codes at each position (len-k+1). PAD bases poison."""
    seq = np.asarray(seq, dtype=np.int64)
    n = len(seq) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    codes = np.zeros(n, dtype=np.int64)
    bad = np.zeros(n, dtype=bool)
    for off in range(k):
        s = seq[off:off + n]
        codes = (codes << 2) | np.clip(s, 0, 3)
        bad |= s < 0
    codes[bad] = -1
    return codes


def anchor_chain(read: np.ndarray, tpl: np.ndarray, k: int = 13
                 ) -> np.ndarray:
    """Monotone chain of unique-k-mer anchors [(rpos, tpos)], sorted by rpos.

    Template k-mers that occur exactly once anchor the mapping; matches are
    chained by longest-increasing-subsequence on tpos (patience algorithm,
    O(n log n)) to enforce monotonicity. Dispatches to the native C++ kernel
    when available; the NumPy path below is the oracle/fallback.
    """
    from ccs_tpu import native
    lib = native.load()
    if lib is not None and hasattr(lib, "ccs_anchor_chain"):
        import ctypes
        read_c = np.ascontiguousarray(read, dtype=np.int8)
        tpl_c = np.ascontiguousarray(tpl, dtype=np.int8)
        cap = max(len(read_c), 1)
        out = np.empty((cap, 2), dtype=np.int64)
        n = lib.ccs_anchor_chain(
            read_c.ctypes.data_as(ctypes.c_void_p), len(read_c),
            tpl_c.ctypes.data_as(ctypes.c_void_p), len(tpl_c),
            k, out.ctypes.data_as(ctypes.c_void_p), cap)
        return out[:n].copy()
    tk = _kmer_codes(tpl, k)
    rk = _kmer_codes(read, k)
    if len(tk) == 0 or len(rk) == 0:
        return np.empty((0, 2), dtype=np.int64)
    order = np.argsort(tk, kind="stable")
    sorted_tk = tk[order]
    uniq_mask = np.ones(len(sorted_tk), dtype=bool)
    uniq_mask[1:] &= sorted_tk[1:] != sorted_tk[:-1]
    uniq_mask[:-1] &= sorted_tk[:-1] != sorted_tk[1:]
    uniq_mask &= sorted_tk >= 0
    u_codes = sorted_tk[uniq_mask]
    u_pos = order[uniq_mask]
    idx = np.searchsorted(u_codes, rk)
    idx = np.clip(idx, 0, len(u_codes) - 1)
    hit = len(u_codes) > 0
    if not hit:
        return np.empty((0, 2), dtype=np.int64)
    match = (u_codes[idx] == rk) & (rk >= 0)
    rpos = np.nonzero(match)[0]
    tpos = u_pos[idx[match]]
    if len(rpos) == 0:
        return np.empty((0, 2), dtype=np.int64)
    # LIS on tpos (strictly increasing) over anchors sorted by rpos
    tails: list[int] = []          # tails[h] = smallest tpos ending a chain of len h+1
    tails_idx: list[int] = []
    parent = np.full(len(rpos), -1, dtype=np.int64)
    import bisect
    for a in range(len(rpos)):
        t = tpos[a]
        h = bisect.bisect_left(tails, t)
        if h == len(tails):
            tails.append(t)
            tails_idx.append(a)
        else:
            tails[h] = t
            tails_idx[h] = a
        parent[a] = tails_idx[h - 1] if h > 0 else -1
    # reconstruct
    chain = []
    a = tails_idx[len(tails) - 1]
    while a >= 0:
        chain.append((rpos[a], tpos[a]))
        a = parent[a]
    chain.reverse()
    return np.asarray(chain, dtype=np.int64)


def _flatten_reads(reads: list[np.ndarray]):
    import ctypes
    offs = np.zeros(len(reads) + 1, dtype=np.int64)
    for i, r in enumerate(reads):
        offs[i + 1] = offs[i] + len(r)
    flat = np.empty(int(offs[-1]), dtype=np.int8)
    for i, r in enumerate(reads):
        flat[offs[i]:offs[i + 1]] = r
    return flat, offs, ctypes


def _unpack_chains(offs, out_chain, out_n):
    chains = []
    for i in range(len(out_n)):
        n = int(out_n[i])
        chains.append(out_chain[int(offs[i]):int(offs[i]) + n].copy())
    return chains


def orient_chain_batch(reads: list[np.ndarray], tpl: np.ndarray,
                       k: int = 13) -> tuple[list[int], list[np.ndarray]]:
    """Orientation + anchor chain for every read of one ZMW against one
    template, with the template k-mer index built once (native); returns
    (strands, chains) where chains[i] is in the winning orientation's read
    coordinates. NumPy fallback composes anchor_chain per read."""
    from ccs_tpu import native
    lib = native.load()
    tpl_c = np.ascontiguousarray(tpl, dtype=np.int8)
    if lib is not None and hasattr(lib, "ccs_orient_chain_batch") and \
            len(reads):
        flat, offs, ctypes = _flatten_reads(reads)
        out_strand = np.zeros(len(reads), dtype=np.uint8)
        out_chain = np.empty((int(offs[-1]), 2), dtype=np.int64)
        out_n = np.zeros(len(reads), dtype=np.int64)
        lib.ccs_orient_chain_batch(
            tpl_c.ctypes.data_as(ctypes.c_void_p), len(tpl_c),
            flat.ctypes.data_as(ctypes.c_void_p),
            offs.ctypes.data_as(ctypes.c_void_p), len(reads), k,
            out_strand.ctypes.data_as(ctypes.c_void_p),
            out_chain.ctypes.data_as(ctypes.c_void_p),
            out_n.ctypes.data_as(ctypes.c_void_p))
        return [int(s) for s in out_strand], _unpack_chains(offs, out_chain,
                                                            out_n)
    from ccs_tpu.ops import dna
    strands, chains = [], []
    for read in reads:
        cf = anchor_chain(read, tpl_c, k)
        cr = anchor_chain(dna.revcomp(read), tpl_c, k)
        rev = len(cr) > len(cf)
        strands.append(1 if rev else 0)
        chains.append(cr if rev else cf)
    return strands, chains


def chain_batch(reads: list[np.ndarray], tpl: np.ndarray,
                k: int = 13) -> list[np.ndarray]:
    """Anchor chains for already-oriented reads against one template with a
    shared k-mer index (native); NumPy fallback is per-read anchor_chain."""
    from ccs_tpu import native
    lib = native.load()
    tpl_c = np.ascontiguousarray(tpl, dtype=np.int8)
    if lib is not None and hasattr(lib, "ccs_chain_batch") and len(reads):
        flat, offs, ctypes = _flatten_reads(reads)
        out_chain = np.empty((int(offs[-1]), 2), dtype=np.int64)
        out_n = np.zeros(len(reads), dtype=np.int64)
        lib.ccs_chain_batch(
            tpl_c.ctypes.data_as(ctypes.c_void_p), len(tpl_c),
            flat.ctypes.data_as(ctypes.c_void_p),
            offs.ctypes.data_as(ctypes.c_void_p), len(reads), k,
            out_chain.ctypes.data_as(ctypes.c_void_p),
            out_n.ctypes.data_as(ctypes.c_void_p))
        return _unpack_chains(offs, out_chain, out_n)
    return [anchor_chain(r, tpl_c, k) for r in reads]


def guided_align(read: np.ndarray, tpl: np.ndarray, band: int = 48,
                 k: int = 13, sub_cost: int = 1, gap_cost: int = 1,
                 gap_open: int = 0) -> Optional[Alignment]:
    """Anchor-chain-guided banded alignment: O(R * band) regardless of drift.

    Chains unique k-mer anchors, interpolates a template center for every
    read row, and runs the banded DP along that path. Falls back to plain
    (rescaled-diagonal) banding with widening if the chain is too sparse or
    the path escapes.

    With ``gap_open > 0`` the DP is the affine-gap Gotoh kernel (KSW2 role,
    how-does-ccs-work.md:53-55): a k-gap costs gap_open + k*gap_cost, so
    multi-base indels collapse into single runs.
    """
    read = np.asarray(read, dtype=np.int8)
    tpl = np.asarray(tpl, dtype=np.int8)

    def dp(band=None, centers=None):
        if gap_open > 0:
            return affine_align(read, tpl, band=band, sub_cost=sub_cost,
                                gap_open=gap_open, gap_ext=gap_cost,
                                centers=centers)
        return edit_align(read, tpl, band=band, sub_cost=sub_cost,
                          gap_cost=gap_cost, centers=centers)

    R, T = len(read), len(tpl)
    if R == 0 or T == 0:
        return dp()
    chain = anchor_chain(read, tpl, k)
    if len(chain) >= 3:
        # invert the chain: template position per read row
        rp = np.concatenate([[0], chain[:, 0], [R]])
        tp = np.concatenate([[0], chain[:, 1], [T]])
        rp = np.maximum.accumulate(rp)
        tp = np.maximum.accumulate(tp)
        centers = np.round(np.interp(np.arange(R + 1), rp, tp)).astype(np.int64)
        for w in (band, band * 2):
            aln = dp(band=w, centers=centers)
            if aln is not None:
                return aln
    # plain rescaled-diagonal banding with geometric widening
    band = band_width_for(R, T)
    limit = max(R, T)
    while True:
        aln = dp(band=band)
        if aln is not None:
            return aln
        if band >= limit:
            return None
        band = min(band * 2, limit)


def interp_read_pos(chain: np.ndarray, tquery: np.ndarray,
                    rlen: int, tlen: int) -> np.ndarray:
    """Interpolate read coordinates for template positions using the anchor
    chain (piecewise linear, clamped monotone)."""
    tquery = np.asarray(tquery)
    if len(chain) == 0:
        scale = rlen / max(tlen, 1)
        return np.clip((tquery * scale).astype(np.int64), 0, rlen)
    tp = np.concatenate([[0], chain[:, 1], [tlen]])
    rp = np.concatenate([[max(0, chain[0, 0] - chain[0, 1])],
                         chain[:, 0], [min(rlen, chain[-1, 0] + (tlen - chain[-1, 1]))]])
    rp = np.maximum.accumulate(rp)
    out = np.interp(tquery, tp, rp)
    return np.clip(np.round(out).astype(np.int64), 0, rlen)
