"""Packed seq+qual transport encoding.

The two uint8 matrices per read side (sequence + quality) are by far the
largest host->device payload.  For real FASTQ data both fit in ONE byte per
base:

    enc = code(base) + 5 * (qual - 33)        code: A=0 C=1 G=2 T=3 N=4
    pad = 250 (above every valid code, 4 + 5*49 = 249)

which is valid whenever every base is A/C/G/T/N and every quality is in
[33, 82] ('!' .. 'R') -- all Illumina and phred64-converted data.  The host
encoder is a single 256x256 LUT gather whose invalid cells hold 255, so
validation is one ``max()`` reduction; it returns None for anything outside
the alphabet (lowercase bases, exotic bytes, quality > 'R') and the runner
falls back to the raw two-matrix path, so the encoding is a pure transport
optimization with no semantic surface.

The device decoder reconstructs the exact ASCII bytes with elementwise
arithmetic and a 6-way select (no gathers), so every downstream kernel sees
byte-identical inputs.  This halves upload bytes where the upload bounds
throughput (host/linkprobe.py decides; there is no reference counterpart:
fqtool's reader hands `std::string`s to pthread workers,
src/fqreader.cpp:160-195).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from .common import A, C, G, N, T

QUAL_MIN = 33
QUAL_MAX = 33 + 49  # code + 5*49 = 249 < PAD
PAD = 250
_INVALID = 255

# (base byte, qual byte) -> encoded byte; one gather pass + one max() check
# instead of the ~6 elementwise validation passes of the scalar formulation
# (the encode pass sits on the critical dispatch path of every chunk)
_ENC_LUT = np.full((256, 256), _INVALID, np.uint8)
_ENC_LUT[0, 0] = PAD  # seq pad and qual pad must agree
for _i, _ch in enumerate(b"ACGTN"):
    for _q in range(QUAL_MIN, QUAL_MAX + 1):
        _ENC_LUT[_ch, _q] = _i + 5 * (_q - QUAL_MIN)


def encode_host(seq: np.ndarray, qual: np.ndarray) -> Optional[np.ndarray]:
    """Encode a zero-padded ASCII (seq, qual) pair into one uint8 matrix, or
    None when the content is outside the encodable alphabet/quality range.
    Native single pass when available (71 -> ~9 ms per 64k x 152 chunk);
    numpy LUT gather otherwise."""
    from ..io.native import encode_native, get_lib

    if get_lib() is not None and seq.flags.c_contiguous and \
            qual.flags.c_contiguous:
        return encode_native(seq, qual, _ENC_LUT)
    enc = _ENC_LUT[seq, qual]
    if int(enc.max(initial=0)) == _INVALID:
        return None
    return enc


def encode5_host(enc: np.ndarray):
    """5-bit dictionary transport on top of :func:`encode_host`: real
    sequencing data is heavily quality-binned (the reference testdata has 6
    distinct quality bytes -> ~22 distinct ``enc`` values incl. the pad), so
    when a pack's value set fits in 32 entries, each byte is replaced by a
    5-bit dictionary index and 8 indices pack into 5 bytes -- 0.625x the
    upload bytes of the 1-byte encoding.

    Returns ``(packed [B, ceil(L/8)*5] uint8, dict32 [32] uint8)`` or None
    when the pack's alphabet exceeds 32 values (caller falls back to the
    1-byte encoding).  The dictionary rides to the device as a tiny array
    argument; decode is exact (decode5_device).
    """
    from ..io.native import pack5_native

    if enc.flags.c_contiguous:
        got = pack5_native(enc)
        if got is not False:  # None = >32 values; tuple = packed result
            return got
    counts = np.bincount(enc.reshape(-1), minlength=256)
    vals = np.flatnonzero(counts).astype(np.uint8)
    if len(vals) > 32:
        return None
    dict32 = np.zeros(32, np.uint8)
    dict32[: len(vals)] = vals
    inv = np.zeros(256, np.uint8)
    inv[vals] = np.arange(len(vals), dtype=np.uint8)
    codes = inv[enc]
    B, L = codes.shape
    Lp = -(-L // 8) * 8
    if Lp != L:
        codes = np.pad(codes, ((0, 0), (0, Lp - L)))
    # pure uint8 plane arithmetic (little-endian bit offsets 5*i): ~10x the
    # uint64 shift-chain formulation this replaced, and this pass sits on
    # the dispatch critical path when the pool is busy
    c = codes.reshape(B, Lp // 8, 8)
    c0, c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    c4, c5, c6, c7 = c[..., 4], c[..., 5], c[..., 6], c[..., 7]

    def sh(x, k):  # dtype-preserving uint8 shift (wraparound intended)
        return np.left_shift(x, k, dtype=np.uint8, casting="unsafe")

    out = np.empty((B, Lp // 8, 5), np.uint8)
    out[..., 0] = c0 | sh(c1, 5)
    out[..., 1] = (c1 >> 3) | sh(c2, 2) | sh(c3, 7)
    out[..., 2] = (c3 >> 1) | sh(c4, 4)
    out[..., 3] = (c4 >> 4) | sh(c5, 1) | sh(c6, 6)
    out[..., 4] = (c6 >> 2) | sh(c7, 3)
    return out.reshape(B, (Lp // 8) * 5), dict32


def decode5_device(packed: jnp.ndarray, dict32: jnp.ndarray,
                   width: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse of :func:`encode5_host` on device: unpack the 5-bit indices
    with uint32 shifts (no gathers), rebuild ``enc`` with a 32-way masked
    sum against the dictionary, then decode to (seq, qual) bytes."""
    B = packed.shape[0]
    G = packed.shape[1] // 5
    pb = packed.reshape(B, G, 5).astype(jnp.uint32)
    lo = pb[:, :, 0] | pb[:, :, 1] << 8 | pb[:, :, 2] << 16 | pb[:, :, 3] << 24
    hi = pb[:, :, 4]
    cols = [(lo >> (5 * j)) & 31 for j in range(6)]
    cols.append((lo >> 30) | ((hi & 7) << 2))
    cols.append((hi >> 3) & 31)
    codes = jnp.stack(cols, axis=2).reshape(B, G * 8)[:, :width]
    enc = jnp.zeros(codes.shape, jnp.uint8)
    for k in range(32):
        enc = jnp.where(codes == k, dict32[k], enc)
    return decode_device(enc)


def decode_device(enc: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse of :func:`encode_host`, on device: elementwise arithmetic plus
    a 6-way select -- no gathers."""
    pad = enc == PAD
    q33 = enc // np.uint8(5)          # 0..49 (pad: 50)
    code = enc - q33 * np.uint8(5)    # 0..4 (pad: 0)
    qual = jnp.where(pad, np.uint8(0), q33 + np.uint8(QUAL_MIN)).astype(jnp.uint8)
    seq = jnp.select(
        [pad, code == 0, code == 1, code == 2, code == 3],
        [np.uint8(0), np.uint8(A), np.uint8(C), np.uint8(G), np.uint8(T)],
        np.uint8(N)).astype(jnp.uint8)
    return seq, qual
