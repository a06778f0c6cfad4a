"""Overlap-based base correction.

Vectorized port of ``BaseCorrector::correctByOverlapAnalysis``
(reference: src/basecorrector.cpp:14-70): within the overlap, a mismatching
base pair where one side is >= Q30 and the other <= Q14 is overwritten with
the complemented high-quality base.  Implemented scatter-free: each read's
correction mask is computed directly in its own coordinate space via the
involution p2 = (start1 + start2) - p1.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .common import complement, positions, shift_rows

GOOD_QUAL = 30 + 33  # util::num2qual(30), basecorrector.cpp:27
BAD_QUAL = 14 + 33   # util::num2qual(14), basecorrector.cpp:28


MAX_FIXES = 5  # diff <= 5 bounds corrections per pair (basecorrector.cpp:15)


class CorrectResult(NamedTuple):
    seq1: jnp.ndarray
    qual1: jnp.ndarray
    seq2: jnp.ndarray
    qual2: jnp.ndarray
    corrected1: jnp.ndarray   # int32 [B] corrected bases in read1
    corrected2: jnp.ndarray   # int32 [B] corrected bases in read2
    matrix: jnp.ndarray       # int32 [64] correction from->to histogram
    # sparse patches for host-side record materialization (positions in the
    # front-aligned read coordinates; -1 = unused slot)
    pos1: jnp.ndarray         # int32 [B, MAX_FIXES]
    new_seq1: jnp.ndarray     # uint8 [B, MAX_FIXES]
    new_qual1: jnp.ndarray    # uint8 [B, MAX_FIXES]
    pos2: jnp.ndarray
    new_seq2: jnp.ndarray
    new_qual2: jnp.ndarray


def _sparse_patches(fix: jnp.ndarray, new_seq: jnp.ndarray,
                    new_qual: jnp.ndarray, seq: jnp.ndarray):
    """Extract up to MAX_FIXES corrected positions per row, with the new
    (seq, qual) byte and the pre-correction base at each.

    Iterative max-extraction instead of ``lax.top_k``: 5 masked max
    reductions compile to straight elementwise code, where top_k lowers to
    a sort.  The slot VALUES come out of the
    same loop as masked lane reductions -- positions are unique per row, so
    exactly one lane matches ``hit`` -- instead of [B, L] -> [B, 5]
    take_along_axis gathers, which lower to per-row dynamic gathers.
    Values in dead slots (pos == -1) are unspecified; every consumer
    masks by pos >= 0."""
    pos = positions(fix.shape[1])
    cur = jnp.where(fix, pos, -1)
    # one masked max per slot extracts (new_seq | new_qual | from) packed
    # into a single int32 plane instead of three separate reductions
    packed = ((new_seq.astype(jnp.int32) << 16)
              | (new_qual.astype(jnp.int32) << 8) | seq.astype(jnp.int32))
    tops, vals = [], []
    for _ in range(MAX_FIXES):
        t = jnp.max(cur, axis=1)          # [B] largest remaining position
        hit = cur == t[:, None]
        tops.append(t)
        vals.append(jnp.max(jnp.where(hit, packed, 0), axis=1))
        cur = jnp.where(hit, -1, cur)
    v = jnp.stack(vals, axis=1)           # [B, MAX_FIXES]
    return (jnp.stack(tops, axis=1),      # [B, MAX_FIXES] descending, -1 pad
            ((v >> 16) & 0xFF).astype(jnp.uint8),
            ((v >> 8) & 0xFF).astype(jnp.uint8),
            v & 0xFF)


def correct_by_overlap(seq1, qual1, rlen1, seq2, qual2, rlen2, ov,
                       eligible) -> CorrectResult:
    """``ov`` is an OverlapResult; ``eligible`` [B] gates pairs (caller passes
    r1&&r2 non-NULL).  Pairs with diff == 0 or diff > 5 are skipped
    (basecorrector.cpp:15-17)."""
    B, L1 = seq1.shape
    L2 = seq2.shape[1]
    active = eligible & (ov.diff != 0) & (ov.diff <= 5)

    start1 = jnp.maximum(0, ov.offset)                      # [B]
    start2 = rlen2 - jnp.maximum(0, -ov.offset) - 1         # [B]
    k = start1 + start2                                     # p1 + p2 == k

    # ---- corrections applied to read1 (positions q in [start1, start1+ol)) --
    q1pos = positions(L1)
    in_ov1 = (q1pos >= start1[:, None]) & (q1pos < (start1 + ov.overlap_len)[:, None])
    # mate[q] = seq2[k - q] = seq2[::-1][(L2-1-k) + q]: static flip + per-row
    # barrel shift on a max-width plane (valid indices never wrap); garbage
    # at out-of-overlap positions is masked by fix1/fix2 below
    Lm = max(L1, L2)

    def _flip_pad(x, Lx):
        return jnp.pad(x[:, ::-1], ((0, 0), (0, Lm - Lx)))

    mate_seq, mate_qual = (p[:, :L1] for p in shift_rows(
        (_flip_pad(seq2, L2), _flip_pad(qual2, L2)), (L2 - 1) - k))
    mism1 = seq1 != complement(mate_seq)
    fix1 = (active[:, None] & in_ov1 & mism1
            & (mate_qual >= GOOD_QUAL) & (qual1 <= BAD_QUAL))
    new_seq1 = jnp.where(fix1, complement(mate_seq), seq1)
    new_qual1 = jnp.where(fix1, mate_qual, qual1)

    # ---- corrections applied to read2 (positions j with i = start2 - j) ----
    q2pos = positions(L2)
    in_ov2 = (q2pos <= start2[:, None]) & (q2pos > (start2 - ov.overlap_len)[:, None])
    mate_seq2, mate_qual2 = (p[:, :L2] for p in shift_rows(
        (_flip_pad(seq1, L1), _flip_pad(qual1, L1)), (L1 - 1) - k))
    mism2 = mate_seq2 != complement(seq2)
    fix2 = (active[:, None] & in_ov2 & mism2
            & (mate_qual2 >= GOOD_QUAL) & (qual2 <= BAD_QUAL))
    new_seq2 = jnp.where(fix2, complement(mate_seq2), seq2)
    new_qual2 = jnp.where(fix2, mate_qual2, qual2)

    corrected1 = jnp.sum(fix1, axis=1).astype(jnp.int32)
    corrected2 = jnp.sum(fix2, axis=1).astype(jnp.int32)

    pos1, ns1, nq1, frm1 = _sparse_patches(fix1, new_seq1, new_qual1, seq1)
    pos2, ns2, nq2, frm2 = _sparse_patches(fix2, new_seq2, new_qual2, seq2)

    # correction matrix (from & 7) * 8 + (to & 7), filterresult.cpp:122-126 --
    # computed from the sparse patches (<= MAX_FIXES entries per row) as 64
    # masked sums over [B, MAX_FIXES] instead of a [B*L] scatter-add into
    # 64 bins
    def _matrix_from(frm, pos, new_seq):
        key = (frm & 7).astype(jnp.int32) * 8 + (new_seq & 7).astype(jnp.int32)
        live = (pos >= 0).astype(jnp.int32)
        return jnp.stack([jnp.sum(jnp.where(key == m, live, 0))
                          for m in range(64)])

    matrix = (_matrix_from(frm1, pos1, ns1)
              + _matrix_from(frm2, pos2, ns2)).astype(jnp.int32)

    return CorrectResult(new_seq1, new_qual1, new_seq2, new_qual2,
                         corrected1, corrected2, matrix,
                         pos1, ns1, nq1, pos2, ns2, nq2)
