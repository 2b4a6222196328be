"""Native host kernels (C++ via ctypes).

The runtime around the device compute path is native where the reference's is
(SURVEY.md §2.3: the reference statically links SIMD-tuned C++ for its host
work). The shared library is built on demand from the shipped source with
the system toolchain and cached; set ``CCS_TPU_NO_NATIVE=1`` to force the
pure-NumPy fallbacks (used as test oracles).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
from typing import Optional

logger = logging.getLogger("ccs_tpu")

_HERE = os.path.dirname(__file__)
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build(src: str, out: str) -> bool:
    cmd = ["g++", "-O3", "-march=native",
           "--param", "vect-max-version-for-alias-checks=50",
           "-shared", "-fPIC", "-std=c++17", "-o", out, src]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as exc:  # noqa: BLE001
        logger.warning("native build failed (%s); using NumPy fallbacks", exc)
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("CCS_TPU_NO_NATIVE"):
        return None
    src = os.path.join(_HERE, "align.cpp")
    candidates = [os.path.join(_HERE, "libccsalign.so")]
    cache = os.path.join(tempfile.gettempdir(),
                         f"ccs_tpu_native_{os.getuid()}")
    os.makedirs(cache, exist_ok=True)
    candidates.append(os.path.join(cache, "libccsalign.so"))
    for path in candidates:
        if (os.path.exists(path)
                and os.path.getmtime(path) >= os.path.getmtime(src)):
            try:
                _LIB = ctypes.CDLL(path)
                break
            except OSError:
                continue
    if _LIB is None:
        for path in candidates:
            if os.access(os.path.dirname(path), os.W_OK) and _build(src, path):
                _LIB = ctypes.CDLL(path)
                break
    if _LIB is not None:
        fn = _LIB.ccs_edit_align
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # read, R
            ctypes.c_void_p, ctypes.c_int64,   # tpl, T
            ctypes.c_void_p, ctypes.c_int64,   # centers, W
            ctypes.c_int64, ctypes.c_int64,    # sub_cost, gap_cost
            ctypes.c_void_p,                   # rpos_at
            ctypes.c_void_p, ctypes.c_void_p,  # ops_rev, ops_len
            ctypes.c_void_p,                   # n_match
        ]
        try:
            fa = _LIB.ccs_affine_align
            fa.restype = ctypes.c_int64
            fa.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,   # read, R
                ctypes.c_void_p, ctypes.c_int64,   # tpl, T
                ctypes.c_void_p, ctypes.c_int64,   # centers, W
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # sub/open/ext
                ctypes.c_void_p,                   # rpos_at
                ctypes.c_void_p, ctypes.c_void_p,  # ops_rev, ops_len
                ctypes.c_void_p,                   # n_match
            ]
            fc = _LIB.ccs_anchor_chain
            fc.restype = ctypes.c_int64
            fc.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,   # read, R
                ctypes.c_void_p, ctypes.c_int64,   # tpl, T
                ctypes.c_int64,                    # k
                ctypes.c_void_p, ctypes.c_int64,   # out_rt, cap
            ]
            fp = _LIB.ccs_pileup_draft
            fp.restype = ctypes.c_int64
            fp.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,   # tpl, T
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # reads, offs, n
                ctypes.c_int64, ctypes.c_int64,    # k, band
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # sub/open/ext
                ctypes.c_double,                   # min_identity
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,  # draft, cap, len
                ctypes.c_void_p, ctypes.c_void_p,  # out_mapped, out_ident
                ctypes.c_void_p,                   # out_weak
                ctypes.c_void_p,                   # out_stats [cap,3] f32 or NULL
                ctypes.c_void_p,                   # out_rpos [n,(T+1)] i64 or NULL
                ctypes.c_void_p,                   # out_src [cap] i32 or NULL
            ]
            fd = _LIB.ccs_dust_profile
            fd.restype = ctypes.c_int64
            fd.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,   # seq, n
                ctypes.c_int64,                    # window
                ctypes.c_void_p,                   # out_scores f64
            ]
            fi = _LIB.ccs_guided_identity
            fi.restype = ctypes.c_double
            fi.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,   # read, R
                ctypes.c_void_p, ctypes.c_int64,   # tpl, T
                ctypes.c_int64, ctypes.c_int64,    # k, band
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # sub/open/ext
            ]
            fo = _LIB.ccs_orient_chain_batch
            fo.restype = ctypes.c_int64
            fo.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,   # tpl, T
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # reads, offs, n
                ctypes.c_int64,                    # k
                ctypes.c_void_p,                   # out_strand
                ctypes.c_void_p, ctypes.c_void_p,  # out_chain, out_nchain
            ]
            fb = _LIB.ccs_chain_batch
            fb.restype = ctypes.c_int64
            fb.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,   # tpl, T
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # reads, offs, n
                ctypes.c_int64,                    # k
                ctypes.c_void_p, ctypes.c_void_p,  # out_chain, out_nchain
            ]
        except AttributeError:  # stale cached .so without the new symbols
            pass
    return _LIB
