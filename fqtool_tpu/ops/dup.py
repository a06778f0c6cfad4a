"""Duplication-analysis key extraction.

Device-side port of ``Duplicate::statRead`` / ``statPair``
(reference: src/duplicate.cpp:64-129): per read, a 2-bit packed prefix key, a
32-base "kmer32" discriminator (split into two uint32 halves -- no 64-bit
types on device), and a GC byte.  The host-side table combiner lives in
``fqtool_tpu.host.duplicate``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .common import C, G, select_at, seq2int_codes, valid_mask


class DupKeys(NamedTuple):
    key: jnp.ndarray       # int32 [B]  (low 32 key bits)
    kmer_hi: jnp.ndarray   # uint32 [B] first 16 bases of the 32-mer
    kmer_lo: jnp.ndarray   # uint32 [B] last 16 bases
    gc: jnp.ndarray        # uint8 [B] round(255 * gc / len)
    valid: jnp.ndarray     # bool [B]
    key_hi: jnp.ndarray = None  # int32 [B] key bits past 32 (keylen > 16 only)


def _pack_key(codes: jnp.ndarray, keylen: int):
    """2-bit pack the first ``keylen`` bases; keys wider than 32 bits split
    into (low, high) uint32 halves (no 64-bit ints on device)."""
    if keylen <= 16:
        key, ok = _pack_2bit_fixed(codes, 0, keylen)
        return key, None, ok
    hi, ok1 = _pack_2bit_fixed(codes, 0, keylen - 16)
    lo, ok2 = _pack_2bit_fixed(codes, keylen - 16, 16)
    return lo, hi.astype(jnp.int32), ok1 & ok2


def _pack_2bit_fixed(codes: jnp.ndarray, start: int, n: int):
    """Pack ``n`` 2-bit codes from the static column ``start`` (one fused
    pass over static slices; no gathers)."""
    if start + n > codes.shape[1]:
        # pack narrower than the window: every read is too short anyway
        return (jnp.zeros((codes.shape[0],), jnp.uint32),
                jnp.zeros((codes.shape[0],), bool))
    val = jnp.zeros((codes.shape[0],), jnp.uint32)
    ok = jnp.ones((codes.shape[0],), bool)
    for j in range(n):
        c = codes[:, start + j].astype(jnp.int32)
        val = val * 4 + jnp.maximum(c, 0).astype(jnp.uint32)
        ok = ok & (c >= 0)
    return val, ok


def _rolling_pack16(codes: jnp.ndarray):
    """w16[b, p] = 2-bit pack of codes[b, p..p+16) for EVERY position, via 4
    shift-doubling steps of static slices -- no gathers.  Also returns the
    all-valid mask per window."""
    B, L = codes.shape
    val = jnp.maximum(codes, 0).astype(jnp.uint32)
    ok = codes >= 0
    width = 1
    while width < 16:
        val_sh = jnp.pad(val[:, width:], ((0, 0), (0, width)))
        ok_sh = jnp.pad(ok[:, width:], ((0, 0), (0, width)))
        val = (val << (2 * width)) | val_sh
        ok = ok & ok_sh
        width *= 2
    return val, ok


def _rolling_pack8_u16(codes: jnp.ndarray):
    """w8[b, p] = 2-bit pack of codes[b, p..p+8) for EVERY position, in
    uint16 planes: 3 shift-doubling steps at half the plane bytes of the
    uint32 16-base version (the dup key scan is plane-traffic-bound)."""
    val = jnp.maximum(codes, 0).astype(jnp.uint16)
    ok = codes >= 0
    width = 1
    while width < 8:
        val_sh = jnp.pad(val[:, width:], ((0, 0), (0, width)))
        ok_sh = jnp.pad(ok[:, width:], ((0, 0), (0, width)))
        val = (val << (2 * width)) | val_sh
        ok = ok & ok_sh
        width *= 2
    return val, ok


def _pack_kmer32(codes: jnp.ndarray, start: jnp.ndarray):
    """(hi, hi_ok, lo, lo_ok) -- the 32-base discriminator at per-read
    ``start`` as two uint32 halves, from FOUR 8-base u16 rolling windows
    (half the cumulative plane traffic of two 16-base u32 extractions,
    bit-identical)."""
    w8, ok8 = _rolling_pack8_u16(codes)
    w8u = w8.astype(jnp.uint32)
    oku = ok8.astype(jnp.uint32)
    segs = [select_at(w8u, start + k) for k in (0, 8, 16, 24)]
    oks = [select_at(oku, start + k) > 0 for k in (0, 8, 16, 24)]
    hi = (segs[0] << 16) | segs[1]
    lo = (segs[2] << 16) | segs[3]
    return hi, oks[0] & oks[1], lo, oks[2] & oks[3]


def _pack_2bit(codes: jnp.ndarray, start: jnp.ndarray, n: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pack ``n`` (16) 2-bit codes beginning at per-read ``start``: rolling
    windows over all positions (static slices), then a masked-reduction
    select at ``start`` instead of a per-row gather."""
    assert n == 16
    w16, ok16 = _rolling_pack16(codes)
    val = select_at(w16, start)
    ok = select_at(ok16.astype(jnp.uint32), start) > 0
    return val, ok


def _gc_byte(seq: jnp.ndarray, rlen: jnp.ndarray, total_len: jnp.ndarray) -> jnp.ndarray:
    mask = valid_mask(rlen, seq.shape[1])
    # the reference accumulates the GC count in a uint8 (duplicate.cpp:83-92),
    # so reads with >255 GC bases wrap mod 256 before the scale
    gc = (jnp.sum(mask & ((seq == C) | (seq == G)), axis=1)
          % 256).astype(jnp.float32)
    tl = jnp.maximum(total_len, 1).astype(jnp.float32)
    # std::round = half away from zero = floor(x + 0.5) for non-negative x
    return jnp.floor(255.0 * gc / tl + 0.5).astype(jnp.uint8)


def dup_keys_se(seq: jnp.ndarray, rlen: jnp.ndarray, keylen: int) -> DupKeys:
    """reference: src/duplicate.cpp:64-93.  kmer32 starts at
    max(0, len - 32 - 5)."""
    B, L = seq.shape
    codes = seq2int_codes(seq)
    key, key_hi, key_ok = _pack_key(codes, keylen)
    start2 = jnp.maximum(0, rlen - 32 - 5)
    hi, hi_ok, lo, lo_ok = _pack_kmer32(codes, start2)
    valid = (rlen >= 32) & key_ok & hi_ok & lo_ok
    gc = _gc_byte(seq, rlen, rlen)
    return DupKeys(key.astype(jnp.int32), hi, lo, gc, valid, key_hi)


def dup_keys_pe(seq1: jnp.ndarray, rlen1: jnp.ndarray,
                seq2: jnp.ndarray, rlen2: jnp.ndarray, keylen: int) -> DupKeys:
    """reference: src/duplicate.cpp:95-129.  Key from read1 prefix, kmer32 from
    read2 prefix, GC over both reads."""
    B, L1 = seq1.shape
    codes1 = seq2int_codes(seq1)
    codes2 = seq2int_codes(seq2)
    key, key_hi, key_ok = _pack_key(codes1, keylen)
    hi, hi_ok = _pack_2bit_fixed(codes2, 0, 16)
    lo, lo_ok = _pack_2bit_fixed(codes2, 16, 16)
    valid = (rlen1 >= 32) & (rlen2 >= 32) & key_ok & hi_ok & lo_ok
    mask1 = valid_mask(rlen1, seq1.shape[1])
    mask2 = valid_mask(rlen2, seq2.shape[1])
    gc1 = jnp.sum(mask1 & ((seq1 == C) | (seq1 == G)), axis=1)
    gc2 = jnp.sum(mask2 & ((seq2 == C) | (seq2 == G)), axis=1)
    tl = jnp.maximum(rlen1 + rlen2, 1).astype(jnp.float32)
    # uint8 accumulator wrap: a pair with >255 GC bases wraps mod 256 in the
    # reference (duplicate.cpp:114-127 accumulates into uint8_t gc)
    gcw = ((gc1 + gc2) % 256).astype(jnp.float32)
    gc = jnp.floor(255.0 * gcw / tl + 0.5).astype(jnp.uint8)
    return DupKeys(key.astype(jnp.int32), hi, lo, gc, valid, key_hi)
