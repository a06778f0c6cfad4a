"""Pair-end device pipeline.

Jit-compiled composition in the exact op order of
``PairEndProcessor::processPairEnd`` (reference: src/peprocessor.cpp:261-508):

  pre-stats -> dup keys -> [host: index filter + UMI] -> trimAndCut r1/r2 ->
  polyG (argument-swap quirk Q4) -> overlap analyze -> insert size ->
  base correction -> adapter trim (overlap, then by-sequence fallback) ->
  polyX -> max-length resize -> merge / passFilter routing -> post-stats.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config.options import KernelParams
from ..ops import adapter as ops_adapter
from ..ops import correct as ops_correct
from ..ops import dup as ops_dup
from ..ops import filters as ops_filters
from ..ops import merge as ops_merge
from ..ops import overlap as ops_overlap
from ..ops import polyx as ops_polyx
from ..ops import qualcut as ops_qualcut
from ..ops import stats as ops_stats
from ..ops.common import align, align_static
from .blob import BlobCall


@functools.partial(
    jax.jit,
    static_argnames=("p", "p2", "adapter_r1", "adapter_r2", "use_start0",
                     "with_kmer", "discard_unmerged"),
)
def pe_pipeline(
    seq1, qual1, lens1, seq2, qual2, lens2,
    start1, start2, keep, real,
    p: KernelParams,
    p2: KernelParams,
    adapter_r1: bytes = b"",
    adapter_r2: bytes = b"",
    use_start0: bool = False,
    with_kmer: bool = False,
    discard_unmerged: bool = False,
    start1_static: int = -1,
    start2_static: int = -1,
):
    """Full PE per-pair pipeline on one pack.  ``p`` carries the shared/r1
    parameters, ``p2`` the r2 force-trim parameters."""
    out = {}
    lens1 = lens1.astype(jnp.int32)
    lens2 = lens2.astype(jnp.int32)
    keep = keep & real  # `real` masks off chunk-padding rows entirely

    # 1. pre-stats on raw reads (peprocessor.cpp:276-277)
    out["pre1"] = ops_stats.stat_batch(seq1, qual1, lens1, select=real)
    out["pre2"] = ops_stats.stat_batch(seq2, qual2, lens2, select=real)
    if with_kmer and p.kmer_len:
        out["pre1_kmer"] = ops_stats.kmer_counts(seq1, lens1, p.kmer_len, select=real)
        out["pre2_kmer"] = ops_stats.kmer_counts(seq2, lens2, p.kmer_len, select=real)

    # 2. duplication keys (peprocessor.cpp:279-281)
    if p.dup_enabled:
        out["dup"] = ops_dup.dup_keys_pe(seq1, lens1, seq2, lens2, p.dup_keylen)

    # 3. UMI offsets from host; fixed-length UMIs give uniform offsets
    # (runner-detected): static slice+pad instead of per-row gathers
    if use_start0:
        if start1_static >= 0:
            seq1 = align_static(seq1, start1_static)
            qual1 = align_static(qual1, start1_static)
        else:
            seq1, qual1 = align((seq1, qual1), start1)
        lens1 = lens1 - start1
        if start2_static >= 0:
            seq2 = align_static(seq2, start2_static)
            qual2 = align_static(qual2, start2_static)
        else:
            seq2, qual2 = align((seq2, qual2), start2)
        lens2 = lens2 - start2

    # 4. trimAndCut per side (peprocessor.cpp:292-293)
    tc1 = ops_qualcut.trim_and_cut(seq1, qual1, lens1, p.front, p.tail, p)
    tc2 = ops_qualcut.trim_and_cut(seq2, qual2, lens2, p2.front, p2.tail, p2)
    if p.cut_front:
        seq1, qual1 = align((seq1, qual1), tc1.front)
    elif p.front > 0:  # static force trim: slice+pad, no gather
        seq1 = align_static(seq1, p.front)
        qual1 = align_static(qual1, p.front)
    if p2.cut_front:
        seq2, qual2 = align((seq2, qual2), tc2.front)
    elif p2.front > 0:
        seq2 = align_static(seq2, p2.front)
        qual2 = align_static(qual2, p2.front)
    rlen1, rlen2 = tc1.rlen, tc2.rlen
    drop1, drop2 = tc1.dropped, tc2.dropped
    both = ~drop1 & ~drop2

    # 5. polyG with the PE argument swap (quirk Q4, peprocessor.cpp:297):
    #    compareReq <- maxMismatch, maxMismatch <- each, each <- minLen
    if p.polyg_enabled:
        for side in (1, 2):
            s, r = (seq1, rlen1) if side == 1 else (seq2, rlen2)
            pg = ops_polyx.trim_polyg(s, r, compare_req=p.polyg_max_mismatch,
                                      max_mismatch=p.polyg_each,
                                      each=p.polyg_min_len)
            newr = jnp.where(both, pg.rlen, r)
            out[f"polyg_trimmed{side}"] = pg.trimmed & both
            out[f"polyg_trim_len{side}"] = pg.trim_len.astype(jnp.int16)
            if side == 1:
                rlen1 = newr
            else:
                rlen2 = newr

    # 6. overlap analysis + insert size + correction + adapter trimming
    #    (peprocessor.cpp:300-333)
    do_overlap_stage = p.adapter_trimming_enabled or p.correction_enabled
    isize_default = jnp.full(rlen1.shape, p.insert_size_max, jnp.int32)
    if do_overlap_stage:
        ov = ops_overlap.analyze(seq1, rlen1, seq2, rlen2,
                                 p.overlap_diff_limit, p.overlap_require)
        # insert size from this analysis (statInsertSize, peprocessor.cpp:510-523)
        isize = jnp.where(
            ov.overlapped,
            jnp.where(ov.offset > 0, rlen1 + rlen2 - ov.overlap_len, ov.overlap_len),
            isize_default)
        out["isize"] = jnp.minimum(isize, p.insert_size_max).astype(jnp.int16)
        out["isize_valid"] = both
        if p.correction_enabled:
            # index-filtered pairs are skipped before correction in the
            # reference (peprocessor.cpp:283-286), so they must not contribute
            # corrections or counter increments
            cr = ops_correct.correct_by_overlap(seq1, qual1, rlen1,
                                                seq2, qual2, rlen2, ov,
                                                both & keep)
            seq1, qual1 = cr.seq1, cr.qual1
            seq2, qual2 = cr.seq2, cr.qual2
            out["corrected1"] = cr.corrected1.astype(jnp.uint8)
            out["corrected2"] = cr.corrected2.astype(jnp.uint8)
            out["correction_matrix"] = cr.matrix
            # sparse patches: the host applies them to its pack copies instead
            # of fetching the full corrected matrices
            out["corr_pos1"], out["corr_seq1"], out["corr_qual1"] = \
                cr.pos1.astype(jnp.int16), cr.new_seq1, cr.new_qual1
            out["corr_pos2"], out["corr_seq2"], out["corr_qual2"] = \
                cr.pos2.astype(jnp.int16), cr.new_seq2, cr.new_qual2
        if p.adapter_trimming_enabled:
            # overlap-based trim first (adaptertrimmer.cpp:14-27)
            ov_trim = (both & (ov.diff <= 5) & ov.overlapped & (ov.offset < 0)
                       & (ov.overlap_len > rlen1 // 3))
            out["ov_trimmed"] = ov_trim
            out["len1_before_ov_trim"] = rlen1.astype(jnp.int16)
            out["len2_before_ov_trim"] = rlen2.astype(jnp.int16)
            rlen1 = jnp.where(ov_trim, ov.overlap_len, rlen1)
            rlen2 = jnp.where(ov_trim, ov.overlap_len, rlen2)
            # by-sequence fallback when not trimmed (peprocessor.cpp:318-325)
            if adapter_r1:
                ad1 = ops_adapter.trim_by_sequence(
                    seq1, rlen1, np.frombuffer(adapter_r1, np.uint8))
                use = both & ~ov_trim
                rlen1 = jnp.where(use, ad1.rlen, rlen1)
                out["adapter_found1"] = ad1.found & use
                out["adapter_pos1"] = ad1.pos.astype(jnp.int16)
            if adapter_r2:
                ad2 = ops_adapter.trim_by_sequence(
                    seq2, rlen2, np.frombuffer(adapter_r2, np.uint8))
                use = both & ~ov_trim
                rlen2 = jnp.where(use, ad2.rlen, rlen2)
                out["adapter_found2"] = ad2.found & use
                out["adapter_pos2"] = ad2.pos.astype(jnp.int16)
    else:
        # insert-size fallback analysis (peprocessor.cpp:329-333)
        ov = ops_overlap.analyze(seq1, rlen1, seq2, rlen2,
                                 p.overlap_diff_limit, p.overlap_require)
        isize = jnp.where(
            ov.overlapped,
            jnp.where(ov.offset > 0, rlen1 + rlen2 - ov.overlap_len, ov.overlap_len),
            isize_default)
        out["isize"] = jnp.minimum(isize, p.insert_size_max).astype(jnp.int16)
        out["isize_valid"] = both
    out["len_after_adapter1"] = rlen1.astype(jnp.int16)
    out["len_after_adapter2"] = rlen2.astype(jnp.int16)

    # 7. polyX (peprocessor.cpp:335-340)
    if p.polyx_enabled:
        for side in (1, 2):
            s, r = (seq1, rlen1) if side == 1 else (seq2, rlen2)
            px = ops_polyx.trim_polyx(s, r, p.polyx_trim_chr, p.polyx_min_len,
                                      p.polyx_max_mismatch, p.polyx_each)
            newr = jnp.where(both, px.rlen, r)
            out[f"polyx_trimmed{side}"] = px.trimmed & both
            out[f"polyx_trim_len{side}"] = px.trim_len.astype(jnp.int16)
            out[f"polyx_base{side}"] = px.base_idx.astype(jnp.uint8)
            if side == 1:
                rlen1 = newr
            else:
                rlen2 = newr

    # 8. max length resize (peprocessor.cpp:342-349)
    if p.max_len > 0:
        rlen1 = jnp.where(both, jnp.minimum(rlen1, p.max_len), rlen1)
    if p2.max_len > 0:
        rlen2 = jnp.where(both, jnp.minimum(rlen2, p2.max_len), rlen2)

    # 9. classification ------------------------------------------------
    result1 = ops_filters.pass_filter(seq1, qual1, rlen1, drop1, p)
    result2 = ops_filters.pass_filter(seq2, qual2, rlen2, drop2, p)
    out["result1"] = result1.astype(jnp.uint8)
    out["result2"] = result2.astype(jnp.uint8)
    pass1 = result1 == ops_filters.PASS_FILTER
    pass2 = result2 == ops_filters.PASS_FILTER

    if p.merge_enabled:
        # fresh overlap analysis on the final reads (peprocessor.cpp:354)
        ov2 = ops_overlap.analyze(seq1, rlen1, seq2, rlen2,
                                  p.overlap_diff_limit, p.overlap_require)
        mergeable = both & ov2.overlapped
        mg = ops_merge.merge_pairs(seq1, qual1, rlen1, seq2, qual2, rlen2, ov2)
        resultM = ops_filters.pass_filter(mg.seq, mg.qual, mg.rlen,
                                          jnp.zeros_like(mergeable), p)
        passM = resultM == ops_filters.PASS_FILTER
        out["mergeable"] = mergeable
        out["resultM"] = resultM.astype(jnp.uint8)
        out["merged_len1"] = mg.len1.astype(jnp.int16)
        out["merged_len2"] = mg.len2.astype(jnp.int16)
        out["merged_rlen"] = mg.rlen.astype(jnp.int16)
        sel_m = mergeable & passM & keep
        # unmerged kept reads statted individually (peprocessor.cpp:367-379)
        if discard_unmerged:
            keep_unmerged = jnp.zeros_like(mergeable)
        else:
            keep_unmerged = both & ~mergeable & keep
        sel1 = keep_unmerged & pass1
        sel2 = keep_unmerged & pass2
        out["postM"] = ops_stats.stat_batch(mg.seq, mg.qual, mg.rlen, select=sel_m)
        out["post1"] = ops_stats.stat_batch(seq1, qual1, rlen1, select=sel1)
        out["post2"] = ops_stats.stat_batch(seq2, qual2, rlen2, select=sel2)
        if with_kmer and p.kmer_len:
            out["postM_kmer"] = ops_stats.kmer_counts(mg.seq, mg.rlen, p.kmer_len, select=sel_m)
            out["post1_kmer"] = ops_stats.kmer_counts(seq1, rlen1, p.kmer_len, select=sel1)
            out["post2_kmer"] = ops_stats.kmer_counts(seq2, rlen2, p.kmer_len, select=sel2)
        # overlap length feeds host-side merged-record assembly
        out["merged_ol"] = ov2.overlap_len.astype(jnp.int16)
    else:
        sel = pass1 & pass2 & keep & both
        out["post1"] = ops_stats.stat_batch(seq1, qual1, rlen1, select=sel)
        out["post2"] = ops_stats.stat_batch(seq2, qual2, rlen2, select=sel)
        if with_kmer and p.kmer_len:
            out["post1_kmer"] = ops_stats.kmer_counts(seq1, rlen1, p.kmer_len, select=sel)
            out["post2_kmer"] = ops_stats.kmer_counts(seq2, rlen2, p.kmer_len, select=sel)

    span_t = jnp.int16 if max(seq1.shape[1], seq2.shape[1]) < (1 << 15) else jnp.int32
    out["front1"] = ((start1 if use_start0 else jnp.zeros_like(lens1))
                     + tc1.front).astype(span_t)
    out["front2"] = ((start2 if use_start0 else jnp.zeros_like(lens2))
                     + tc2.front).astype(span_t)
    out["rlen1"] = rlen1.astype(span_t)
    out["rlen2"] = rlen2.astype(span_t)
    out["dropped1"], out["dropped2"] = drop1, drop2
    return out


se_static = ("p", "p2", "adapter_r1", "adapter_r2", "use_start0", "with_kmer",
             "discard_unmerged", "start1_static", "start2_static")
pe_pipeline_call = BlobCall(pe_pipeline.__wrapped__, se_static)


def _pe_pipeline_packed(enc1, lens1, enc2, lens2, start1, start2, keep, real,
                        **kw):
    """Packed-transport variant: each side's seq+qual ride in one uint8
    matrix (ops/packed.py), halving the host->device payload."""
    from ..ops.packed import decode_device

    seq1, qual1 = decode_device(enc1)
    seq2, qual2 = decode_device(enc2)
    return pe_pipeline.__wrapped__(seq1, qual1, lens1, seq2, qual2, lens2,
                                   start1, start2, keep, real, **kw)


pe_packed_call = BlobCall(_pe_pipeline_packed, se_static)


def _pe_pipeline_packed5(enc5_1, lens1, enc5_2, lens2, start1, start2, keep,
                         real, dict32_1, dict32_2, *, enc_width1, enc_width2,
                         **kw):
    """5-bit dictionary transport variant (ops/packed.py::encode5_host)."""
    from ..ops.packed import decode5_device

    seq1, qual1 = decode5_device(enc5_1, dict32_1, enc_width1)
    seq2, qual2 = decode5_device(enc5_2, dict32_2, enc_width2)
    return pe_pipeline.__wrapped__(seq1, qual1, lens1, seq2, qual2, lens2,
                                   start1, start2, keep, real, **kw)


pe_packed5_call = BlobCall(_pe_pipeline_packed5,
                           se_static + ("enc_width1", "enc_width2"))
