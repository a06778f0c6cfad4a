"""Pair overlap analysis.

Vectorized port of ``OverlapAnalysis::analyze``
(reference: src/overlapanalysis.cpp:7-72): read1 is compared against the
reverse complement of read2 at every candidate offset in parallel; the first
offset in the reference scan order (phase 1: 0..len1-require-1, then phase 2:
0,-1,..,require-len2+1) that satisfies the acceptance predicate wins.

Acceptance replicates the early-exit loop exactly: with limit = diff_limit and
d50 = mismatches among the first 50 compared bases,

    accept  <=>  full_diff < limit  OR  (d50 < limit AND overlap_len > 50)

because the scan breaks (rejecting) exactly when the running diff reaches the
limit before compare index 50 (overlapanalysis.cpp:27-29,32).

That predicate collapses to ``d50 < limit`` alone: when overlap_len <= 50
every compared base is among the first 50 so full_diff == d50, and when
overlap_len > 50 the d50 clause subsumes the full_diff clause (full_diff <
limit implies d50 <= full_diff < limit).  The accept scan therefore only
needs mismatch counts over a [B, offsets, 50] window -- O(L*50) work instead
of O(L^2) -- and the full diff (reported for the correction/trim gates) is
computed once per row at the selected offset.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .common import (A, C, G, N, T, complement, first_true, positions,
                     shift_rows)

COMPLETE_COMPARE_REQUIRE = 50  # overlapanalysis.cpp:14



class OverlapResult(NamedTuple):
    overlapped: jnp.ndarray   # bool [B]
    offset: jnp.ndarray       # int32 [B]
    overlap_len: jnp.ndarray  # int32 [B]
    diff: jnp.ndarray         # int32 [B]


def reverse_complement(seq: jnp.ndarray, rlen: jnp.ndarray) -> jnp.ndarray:
    """rc[b, i] = complement(seq[b, rlen-1-i]); positions at or past rlen
    hold wrapped garbage and must be masked by i < rlen.  Static lane flip
    plus a per-row barrel shift -- no gathers."""
    L = seq.shape[1]
    return complement(shift_rows(seq[:, ::-1], L - rlen))


def _phase_scan50(head: jnp.ndarray, moving: jnp.ndarray, O: int,
                  ol: jnp.ndarray, valid: jnp.ndarray, diff_limit: int):
    """Accept/select over the first COMPLETE_COMPARE_REQUIRE compared bases
    (accept <=> d50 < diff_limit, see module docstring).

    ``head``: [B, >=W]; ``moving``: [B, >=O+W] (already padded); compares
    moving[b, o+i] vs head[b, i] for i < min(ol, W) at every offset o.

    Lowering: W unrolled adds into one [B, O] uint8 accumulator (d50 <= 50
    always fits), with the offset axis minor and nothing materialized
    beyond [B, O] planes -- a [B, W, O] slice stack would write and read a
    [B, 50, O] intermediate (~100 MB at 16k x 152)."""
    W = COMPLETE_COMPARE_REQUIRE
    d50u = jnp.zeros(ol.shape, jnp.uint8)
    for i in range(W):
        neq = moving[:, i : i + O] != head[:, i][:, None]
        d50u = d50u + (neq & (i < ol)).astype(jnp.uint8)
    hit = (d50u.astype(jnp.int32) < diff_limit) & valid
    found = jnp.any(hit, axis=1)
    sel = first_true(hit, jnp.int32(0))
    # masked lane reduction instead of a [B, O] -> [B] per-row gather (the
    # same scalar-path-gather cost the correction patches paid); sel is a
    # valid offset whenever found, where ol > overlap_require > 0 -- rows
    # without a hit are masked by `found` downstream
    ol_sel = jnp.max(jnp.where(positions(O) == sel[:, None], ol, 0), axis=1)
    return found, sel, ol_sel


def _grouped_correlation(oh1: jnp.ndarray, oh2: jnp.ndarray) -> jnp.ndarray:
    """Per-pair cross-correlation of one-hot sequences as a grouped
    convolution.

    oh1, oh2: [B, C, L] (0/1).  Returns corr [B, 2L-1] where
    corr[b, L-1+lag] = sum_i oh1[b, :, i+lag] . oh2[b, :, i].
    """
    B, C, L = oh1.shape
    lhs = oh1.reshape(1, B * C, L)  # [N=1, feat=B*C, W=L]
    rhs = oh2.reshape(B, C, L)      # [out=B, in/group=C, W=L]
    out = jax.lax.conv_general_dilated(
        lhs.astype(jnp.bfloat16), rhs.astype(jnp.bfloat16),
        window_strides=(1,), padding=[(L - 1, L - 1)],
        feature_group_count=B,
        dimension_numbers=("NCW", "OIW", "NCW"),
        preferred_element_type=jnp.float32)
    # XLA convolution is cross-correlation (no filter flip): out[0, b, p]
    # = sum_dx oh1[b, :, p + dx - (L-1)] . oh2[b, :, dx], i.e. lag = p - (L-1)
    return out[0].astype(jnp.int32)  # [B, 2L-1]


_SYMBOLS = (A, C, G, T, N)


def _one_hot(seq: jnp.ndarray, limit: jnp.ndarray) -> jnp.ndarray:
    """[B, 5, L] exact-byte one-hot over the A/C/G/T/N alphabet; positions at
    or past ``limit`` are zero vectors (zero padding bytes already miss)."""
    L = seq.shape[1]
    mask = positions(L) < limit[:, None]
    return jnp.stack([(seq == s) & mask for s in _SYMBOLS], axis=1)


def analyze_mxu(seq1: jnp.ndarray, rlen1: jnp.ndarray,
                seq2: jnp.ndarray, rlen2: jnp.ndarray,
                diff_limit: int, overlap_require: int) -> OverlapResult:
    """All-offsets overlap analysis via grouped one-hot cross-correlations.

    Bit-identical to :func:`analyze` (validated in tests/test_overlap_mxu.py)
    and kept as an independent formulation for that cross-check; the
    pipeline calls :func:`analyze`.
    """
    B, L1 = seq1.shape
    L2 = seq2.shape[1]
    L = max(L1, L2)
    rs2 = jnp.pad(reverse_complement(seq2, rlen2), ((0, 0), (0, L - L2)))
    s1 = jnp.pad(seq1, ((0, 0), (0, L - L1)))
    zero = jnp.zeros((B,), jnp.int32)

    oh1 = _one_hot(s1, rlen1)
    oh2 = _one_hot(rs2, rlen2)
    lim50 = jnp.full((B,), COMPLETE_COMPARE_REQUIRE, jnp.int32)
    oh1_50 = _one_hot(s1, jnp.minimum(rlen1, lim50))
    oh2_50 = _one_hot(rs2, jnp.minimum(rlen2, lim50))

    corr = _grouped_correlation(oh1, oh2)        # matches at every lag
    corr_i50_p1 = _grouped_correlation(oh1, oh2_50)  # phase-1 compare idx < 50
    corr_i50_p2 = _grouped_correlation(oh1_50, oh2)  # phase-2 compare idx < 50

    # ---- phase 1: offset o >= 0 (lag +o); compare s1[o+i] vs rs2[i] ----
    O1 = max(L1 - overlap_require, 0)
    if O1 > 0:
        o_ax = positions(O1)  # [1, O1]
        ol1 = jnp.minimum(rlen1[:, None] - o_ax, rlen2[:, None])
        m_full = corr[:, L - 1 : L - 1 + O1]
        m_50 = corr_i50_p1[:, L - 1 : L - 1 + O1]
        full1 = ol1 - m_full
        d50_1 = jnp.minimum(ol1, COMPLETE_COMPARE_REQUIRE) - m_50
        accept1 = (full1 < diff_limit) | \
            ((d50_1 < diff_limit) & (ol1 > COMPLETE_COMPARE_REQUIRE))
        valid1 = o_ax < (rlen1[:, None] - overlap_require)
        hit1 = accept1 & valid1
        found1 = jnp.any(hit1, axis=1)
        o1 = first_true(hit1, jnp.int32(0))
        take = jnp.take_along_axis
        ol_sel1 = take(ol1, o1[:, None], axis=1)[:, 0]
        diff_sel1 = take(full1, o1[:, None], axis=1)[:, 0]
    else:
        found1, o1, ol_sel1, diff_sel1 = jnp.zeros((B,), bool), zero, zero, zero

    # ---- phase 2: offset o <= 0 (j = -o, lag -j); compare s1[i] vs rs2[j+i] --
    O2 = max(L2 - overlap_require, 0)
    if O2 > 0:
        j_ax = positions(O2)
        ol2 = jnp.minimum(rlen1[:, None], rlen2[:, None] - j_ax)
        m_full = corr[:, L - O2 : L][:, ::-1]  # lag -j for j = 0..O2-1
        m_50 = corr_i50_p2[:, L - O2 : L][:, ::-1]
        full2 = ol2 - m_full
        d50_2 = jnp.minimum(ol2, COMPLETE_COMPARE_REQUIRE) - m_50
        accept2 = (full2 < diff_limit) | \
            ((d50_2 < diff_limit) & (ol2 > COMPLETE_COMPARE_REQUIRE))
        valid2 = j_ax < (rlen2[:, None] - overlap_require)
        hit2 = accept2 & valid2
        found2 = jnp.any(hit2, axis=1)
        j2 = first_true(hit2, jnp.int32(0))
        take = jnp.take_along_axis
        ol_sel2 = take(ol2, j2[:, None], axis=1)[:, 0]
        diff_sel2 = take(full2, j2[:, None], axis=1)[:, 0]
    else:
        found2, j2, ol_sel2, diff_sel2 = jnp.zeros((B,), bool), zero, zero, zero

    overlapped = found1 | found2
    offset = jnp.where(found1, o1, -j2)
    overlap_len = jnp.where(found1, ol_sel1, jnp.where(found2, ol_sel2, 0))
    diff = jnp.where(found1, diff_sel1, jnp.where(found2, diff_sel2, 0))
    offset = jnp.where(overlapped, offset, 0)
    return OverlapResult(overlapped, offset, overlap_len, diff)


def analyze(seq1: jnp.ndarray, rlen1: jnp.ndarray,
            seq2: jnp.ndarray, rlen2: jnp.ndarray,
            diff_limit: int, overlap_require: int) -> OverlapResult:
    """All-offsets overlap analysis -- the production path.

    The accept scan compares only the first COMPLETE_COMPARE_REQUIRE bases at
    every offset ([B, offsets, 50] masked compare, see module docstring for
    why that is exact), then the reported full diff is computed at the
    selected offset alone with two per-row shifted gathers."""
    B, L1 = seq1.shape
    L2 = seq2.shape[1]
    L = max(L1, L2)
    W = COMPLETE_COMPARE_REQUIRE
    rs2 = jnp.pad(reverse_complement(seq2, rlen2), ((0, 0), (0, L - L2)))
    s1 = jnp.pad(seq1, ((0, 0), (0, L - L1)))
    zero = jnp.zeros((B,), jnp.int32)

    def padded(x, O):
        return jnp.pad(x, ((0, 0), (0, O + W)))

    def head50(x):
        return jnp.pad(x, ((0, 0), (0, W - L))) if L < W else x

    # ---- phase 1: offset o >= 0; compare s1[o+i] vs rs2[i] ----
    O1 = max(L1 - overlap_require, 0)
    if O1 > 0:
        o_ax = positions(O1)[0]
        ol1 = jnp.minimum(rlen1[:, None] - o_ax[None, :], rlen2[:, None])
        valid1 = o_ax[None, :] < (rlen1[:, None] - overlap_require)
        found1, o1, ol_sel1 = _phase_scan50(
            head50(rs2), padded(s1, O1), O1, ol1, valid1, diff_limit)
    else:
        found1, o1, ol_sel1 = jnp.zeros((B,), bool), zero, zero

    # ---- phase 2: offset o <= 0 (j = -o); compare s1[i] vs rs2[j+i] ----
    O2 = max(L2 - overlap_require, 0)
    if O2 > 0:
        j_ax = positions(O2)[0]
        ol2 = jnp.minimum(rlen1[:, None], rlen2[:, None] - j_ax[None, :])
        valid2 = j_ax[None, :] < (rlen2[:, None] - overlap_require)
        found2, j2, ol_sel2 = _phase_scan50(
            head50(s1), padded(rs2, O2), O2, ol2, valid2, diff_limit)
    else:
        found2, j2, ol_sel2 = jnp.zeros((B,), bool), zero, zero

    overlapped = found1 | found2
    offset = jnp.where(found1, o1, -j2)
    overlap_len = jnp.where(found1, ol_sel1, jnp.where(found2, ol_sel2, 0))

    # full diff at the selected offset only: compare s1[i+max(o,0)] vs
    # rs2[i+max(-o,0)] for i < overlap_len (two per-row barrel shifts; the
    # compared span never wraps, and positions past it are masked)
    pos = positions(L)
    g1 = shift_rows(s1, jnp.maximum(offset, 0))
    g2 = shift_rows(rs2, jnp.maximum(-offset, 0))
    diff = jnp.sum((g1 != g2) & (pos < overlap_len[:, None]),
                   axis=1).astype(jnp.int32)

    offset = jnp.where(overlapped, offset, 0)
    diff = jnp.where(overlapped, diff, 0)
    return OverlapResult(overlapped, offset, overlap_len, diff)
