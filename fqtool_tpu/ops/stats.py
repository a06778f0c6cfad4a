"""Per-cycle statistics kernels.

Vectorized port of ``Stats::statRead`` (reference: src/stats.cpp:237-295):
per-cycle Q20/Q30/content/quality histograms binned by ``base & 0x07``, plus
optional k-mer counting.  Q20/Q30 use strict ``>`` against '5'/'?'
(stats.cpp:250-259).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .common import Q20_CHAR, Q30_CHAR, seq2int_codes, valid_mask

# kmer-histogram lowering gate: one-hot planes past ~1.5 GiB fall back to
# the scatter-add (very large k on very large chunks)
_KMER_ONEHOT_LIMIT = 3 << 29


class BatchStats(NamedTuple):
    cycle_q20: jnp.ndarray       # int32 [8, L]
    cycle_q30: jnp.ndarray       # int32 [8, L]
    cycle_content: jnp.ndarray   # int32 [8, L]
    cycle_quality: jnp.ndarray   # int32 [8, L]
    cycle_total: jnp.ndarray     # int32 [L]
    cycle_total_qual: jnp.ndarray  # int32 [L]
    reads: jnp.ndarray           # int32 []
    length_sum: jnp.ndarray      # int32 []


def stat_batch(seq: jnp.ndarray, qual: jnp.ndarray, rlen: jnp.ndarray,
               select: jnp.ndarray | None = None) -> BatchStats:
    """Accumulate per-cycle statistics over a batch.

    ``select`` (bool [B]) restricts which reads contribute (post-filter stats
    only cover passing reads, seprocessor.cpp:342-345).
    """
    B, L = seq.shape
    # cycle-blocked matmul formulation: per cycle l the 8x4 histogram block
    # is onehot[l](8 x B) @ weights[l](B x 4).  Batching that dot over L
    # gives M=8, N=4 matmuls, far below a matrix unit's tile.  Instead,
    # cycles are grouped G=16 at a time into M=8G=128 / N=4G=64 matmuls;
    # the (g != g') cross-cycle blocks are computed and discarded (a 16x
    # MAC overcount).  The g == g' diagonal is extracted with an
    # eye-contraction (no gathers).  int8 operands (0/1 one-hots, quality
    # offsets <= 93) with int32 accumulation are exact and halve the
    # operand-construction traffic of bf16.
    G = 16
    Lp = -(-L // G) * G
    if Lp != L:
        seq = jnp.pad(seq, ((0, 0), (0, Lp - L)))
        qual = jnp.pad(qual, ((0, 0), (0, Lp - L)))
    mask = valid_mask(rlen, Lp)
    if select is not None:
        mask = mask & select[:, None]
    qv = qual.astype(jnp.int32)
    q20 = mask & (qv > Q20_CHAR)
    q30 = mask & (qv > Q30_CHAR)
    qoff = jnp.where(mask, qv - 33, 0)

    oh = jnp.stack([mask & ((seq & 0x07) == k) for k in range(8)],
                   axis=1).astype(jnp.int8)                # [B, 8, Lp]
    w = jnp.stack([mask.astype(jnp.int8),
                   q20.astype(jnp.int8),
                   q30.astype(jnp.int8),
                   qoff.astype(jnp.int8)], axis=1)         # [B, 4, Lp]
    nb = Lp // G
    lhs = oh.reshape(B, 8, nb, G).transpose(0, 2, 1, 3).reshape(B, nb, 8 * G)
    rhs = w.reshape(B, 4, nb, G).transpose(0, 2, 1, 3).reshape(B, nb, 4 * G)
    hist = jax.lax.dot_general(
        lhs, rhs, (((0,), (0,)), ((1,), (1,))),
        preferred_element_type=jnp.int32)                  # [nb, 8G, 4G]
    eye = jnp.eye(G, dtype=jnp.int32)
    cq = jnp.einsum("nkgjh,gh->kjng", hist.reshape(nb, 8, G, 4, G),
                    eye).reshape(8, 4, Lp)[:, :, :L]

    if select is None:
        nreads = jnp.int32(B)
        lsum = jnp.sum(rlen)
    else:
        nreads = jnp.sum(select).astype(jnp.int32)
        lsum = jnp.sum(jnp.where(select, rlen, 0))
    # bins partition the masked positions, so the totals are bin sums
    return BatchStats(
        cycle_q20=cq[:, 1],
        cycle_q30=cq[:, 2],
        cycle_content=cq[:, 0],
        cycle_quality=cq[:, 3],
        cycle_total=jnp.sum(cq[:, 0], axis=0),
        cycle_total_qual=jnp.sum(cq[:, 3], axis=0),
        reads=nreads,
        length_sum=lsum.astype(jnp.int32),
    )


def kmer_counts(seq: jnp.ndarray, rlen: jnp.ndarray, kmer_len: int,
                select: jnp.ndarray | None = None) -> jnp.ndarray:
    """K-mer histogram [4**kmer_len] over all valid windows
    (stats.cpp:266-274): a window ending at position i (i >= k-1, i < rlen)
    counts iff all k bases are A/T/C/G.

    Matmul formulation: the key splits into hi (first k//2 bases) and lo
    (the rest), and the histogram is the outer-product accumulation
    ``H[a, b] = sum_w onehot_hi[w, a] * onehot_lo[w, b]`` -- one
    [4^k1, W] x [W, 4^k2] matmul contracting the window axis (0/1 bf16
    operands, f32 accumulation exact below 2^24 counts per bin) in place of
    a [B*nwin] scatter-add.  Very large k (one-hot planes past ~1.5 GiB)
    falls back to the scatter."""
    B, L = seq.shape
    k = kmer_len
    if k <= 0 or L < k:
        return jnp.zeros((4 ** max(k, 1),), jnp.int32)
    codes = seq2int_codes(seq).astype(jnp.int32)  # -1 invalid
    nwin = L - k + 1
    k1 = k // 2
    k2 = k - k1
    hi = jnp.zeros((B, nwin), jnp.int32)
    lo = jnp.zeros((B, nwin), jnp.int32)
    ok = jnp.ones((B, nwin), bool)
    for j in range(k):
        c = codes[:, j : j + nwin]
        if j < k1:
            hi = hi * 4 + jnp.maximum(c, 0)
        else:
            lo = lo * 4 + jnp.maximum(c, 0)
        ok = ok & (c >= 0)
    # window end position i = w + k - 1 must satisfy i < rlen
    end_ok = (jnp.arange(nwin, dtype=jnp.int32)[None, :] + (k - 1)) < rlen[:, None]
    ok = ok & end_ok
    if select is not None:
        ok = ok & select[:, None]

    bytes_per_row = (4 ** k1 + 4 ** k2) * nwin * 2
    rows_per = max(1, _KMER_ONEHOT_LIMIT // max(bytes_per_row, 1))
    if rows_per < 64 or 4 ** k > (1 << 20):
        # enormous k: the one-hot planes would thrash even chunked (and the
        # reference's 4^k table is equally degenerate there) -- scatter-add
        hist = jnp.zeros((4 ** k,), jnp.int32)
        keys = hi * (4 ** k2) + lo
        return hist.at[keys.reshape(-1)].add(ok.reshape(-1).astype(jnp.int32))

    iota_hi = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 4 ** k1), 2)
    iota_lo = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 4 ** k2), 2)

    def block(hi_b, lo_b, ok_b):
        oh_hi = ((hi_b[:, :, None] == iota_hi)
                 & ok_b[:, :, None]).astype(jnp.bfloat16)
        oh_lo = (lo_b[:, :, None] == iota_lo).astype(jnp.bfloat16)
        return jax.lax.dot_general(
            oh_hi.reshape(-1, 4 ** k1), oh_lo.reshape(-1, 4 ** k2),
            (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32)

    # chunk the batch so the one-hot planes stay within the limit (large k)
    h = None
    for b0 in range(0, B, rows_per):
        hb = block(hi[b0 : b0 + rows_per], lo[b0 : b0 + rows_per],
                   ok[b0 : b0 + rows_per])
        h = hb if h is None else h + hb
    # key = hi * 4^k2 + lo is exactly the row-major flattening of [hi, lo]
    return h.reshape(-1).astype(jnp.int32)
