"""Plain NumPy references for the device ops whose form was shaped by a
matrix unit: ``overlap.analyze``, ``stats.stat_batch`` and
``stats.kmer_counts``.

Each is written from the reference program's semantics, not from the
device code, so agreement is a cross-check: a scalar per-pair port of
``OverlapAnalysis::analyze`` with its early exit (reference:
src/overlapanalysis.cpp:7-72, SURVEY.md section 2.1), and histograms of
``Stats::statRead`` (src/stats.cpp:237-274) by ``np.add.at`` and
``np.bincount``.  All results are integers and compare exactly.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

COMPLETE_COMPARE_REQUIRE = 50  # overlapanalysis.cpp:14
Q20_CHAR, Q30_CHAR = ord("5"), ord("?")  # stats.cpp:250-251

# reverseComplement (seq.h:24-48): A<->T, C<->G in either case, else N
_RC = bytes.maketrans(b"ATCGatcg", b"TAGCTAGC")
_KEEP = frozenset(b"ATCGatcg")


def _revcomp(s: bytes) -> bytes:
    return bytes(c if c in _KEEP else ord("N") for c in s[::-1]).translate(_RC)


def _analyze_one(s1: bytes, s2: bytes, diff_limit: int, require: int):
    """(overlapped, offset, overlap_len, diff) of one pair, in the
    reference's scan order and with its early exit."""
    r2 = _revcomp(s2)
    len1, len2 = len(s1), len(r2)
    offset = 0
    while offset < len1 - require:
        ol = min(len1 - offset, len2)
        diff = 0
        i = 0
        while i < ol:
            if s1[offset + i] != r2[i]:
                diff += 1
                if diff >= diff_limit and i < COMPLETE_COMPARE_REQUIRE:
                    break
            i += 1
        if diff < diff_limit or i > COMPLETE_COMPARE_REQUIRE:
            return 1, offset, ol, diff
        offset += 1
    offset = 0
    while offset > -(len2 - require):
        ol = min(len1, len2 - abs(offset))
        diff = 0
        i = 0
        while i < ol:
            if s1[i] != r2[-offset + i]:
                diff += 1
                if diff >= diff_limit and i < COMPLETE_COMPARE_REQUIRE:
                    break
            i += 1
        if diff < diff_limit or i > COMPLETE_COMPARE_REQUIRE:
            return 1, offset, ol, diff
        offset -= 1
    return 0, 0, 0, 0


def overlap_analyze(seq1: np.ndarray, rlen1: np.ndarray, seq2: np.ndarray,
                    rlen2: np.ndarray, diff_limit: int,
                    overlap_require: int) -> Dict[str, np.ndarray]:
    """Per-pair overlap analysis of ``seq1[b, :rlen1[b]]`` against
    ``seq2[b, :rlen2[b]]``; keys follow ``ops.overlap.OverlapResult``."""
    res = np.array([
        _analyze_one(seq1[b, : rlen1[b]].tobytes(),
                     seq2[b, : rlen2[b]].tobytes(),
                     diff_limit, overlap_require)
        for b in range(len(rlen1))], np.int32).reshape(-1, 4)
    return {"overlapped": res[:, 0].astype(bool), "offset": res[:, 1],
            "overlap_len": res[:, 2], "diff": res[:, 3]}


def _valid(rlen: np.ndarray, width: int,
           select: Optional[np.ndarray]) -> np.ndarray:
    m = np.arange(width)[None, :] < np.asarray(rlen)[:, None]
    return m if select is None else m & np.asarray(select)[:, None]


def stat_batch(seq: np.ndarray, qual: np.ndarray, rlen: np.ndarray,
               select: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Per-cycle histograms binned by ``base & 0x07``; keys follow
    ``ops.stats.BatchStats``."""
    B, L = seq.shape
    b, pos = np.nonzero(_valid(rlen, L, select))
    bins = seq[b, pos] & 0x07
    q = qual[b, pos].astype(np.int64)
    hist = {k: np.zeros((8, L), np.int64) for k in
            ("cycle_content", "cycle_q20", "cycle_q30", "cycle_quality")}
    np.add.at(hist["cycle_content"], (bins, pos), 1)
    np.add.at(hist["cycle_q20"], (bins, pos), q > Q20_CHAR)
    np.add.at(hist["cycle_q30"], (bins, pos), q > Q30_CHAR)
    np.add.at(hist["cycle_quality"], (bins, pos), q - 33)
    hist["cycle_total"] = hist["cycle_content"].sum(axis=0)
    hist["cycle_total_qual"] = hist["cycle_quality"].sum(axis=0)
    sel = np.ones(B, bool) if select is None else np.asarray(select)
    hist["reads"] = np.int64(sel.sum())
    hist["length_sum"] = np.int64(np.asarray(rlen)[sel].sum())
    return hist


def kmer_counts(seq: np.ndarray, rlen: np.ndarray, k: int,
                select: Optional[np.ndarray] = None) -> np.ndarray:
    """[4**k] counts of the k-mers ending at every position i with
    k-1 <= i < rlen whose bases are all A/T/C/G, keyed A=0 T=1 C=2 G=3,
    first base most significant (stats.cpp:266-274)."""
    B, L = seq.shape
    code = np.full(seq.shape, -1, np.int64)
    for v, base in enumerate(b"ATCG"):
        code[seq == base] = v
    win = np.lib.stride_tricks.sliding_window_view(code, k, axis=1)
    ok = (win >= 0).all(axis=2) & _valid(rlen, L, select)[:, k - 1:]
    keys = (win * (4 ** np.arange(k - 1, -1, -1))).sum(axis=2)
    return np.bincount(keys[ok], minlength=4 ** k)
