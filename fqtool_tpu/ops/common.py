"""Shared vectorized primitives for the per-read kernels.

All kernels operate on left-aligned batches: ``seq``/``qual`` are
``uint8[B, L]`` ASCII matrices, ``rlen`` is ``int32[B]``.  Data-dependent
early-exit loops from the reference become evaluate-everywhere + first/last
true-index selections, which compile to fused elementwise code.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# ASCII codes
A, C, G, T, N = 65, 67, 71, 84, 78
Q20_CHAR = ord("5")  # reference: stats.cpp:250
Q30_CHAR = ord("?")  # reference: stats.cpp:251

def seq2int_codes(seq: jnp.ndarray) -> jnp.ndarray:
    """Map ASCII bases to 2-bit codes; -1 marks invalid bases.

    Compare/select chain, not a 256-entry LUT: a 4-way select fuses with
    its neighbours, where a per-element table gather does not."""
    return jnp.select(
        [seq == A, seq == T, seq == C, seq == G],
        [jnp.int8(0), jnp.int8(1), jnp.int8(2), jnp.int8(3)],
        jnp.int8(-1)).astype(jnp.int8)


def complement(seq: jnp.ndarray) -> jnp.ndarray:
    """Base complement (reference: seq.h:24-48): A<->T C<->G (either case),
    everything else -> N.  Select chain for the same reason as above."""
    la, lt, lc, lg = ord("a"), ord("t"), ord("c"), ord("g")
    return jnp.select(
        [(seq == A) | (seq == la), (seq == T) | (seq == lt),
         (seq == C) | (seq == lc), (seq == G) | (seq == lg)],
        [jnp.uint8(T), jnp.uint8(A), jnp.uint8(G), jnp.uint8(C)],
        jnp.uint8(N)).astype(jnp.uint8)


def positions(n: int) -> jnp.ndarray:
    """[1, n] int32 position row for broadcasting against [B, 1] scalars."""
    return jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)


def first_true(mask: jnp.ndarray, default) -> jnp.ndarray:
    """Per-row index of the first True along the last axis, else ``default``.

    ``default`` may be a scalar or a [B]-shaped array.
    """
    found = jnp.any(mask, axis=-1)
    idx = jnp.argmax(mask, axis=-1).astype(jnp.int32)
    return jnp.where(found, idx, default)


def last_true(mask: jnp.ndarray, default) -> jnp.ndarray:
    """Per-row index of the last True along the last axis, else ``default``."""
    n = mask.shape[-1]
    found = jnp.any(mask, axis=-1)
    idx = (n - 1) - jnp.argmax(mask[..., ::-1], axis=-1).astype(jnp.int32)
    return jnp.where(found, idx, default)


def valid_mask(rlen: jnp.ndarray, width: int) -> jnp.ndarray:
    """[B, width] mask of positions < rlen."""
    return positions(width) < rlen[:, None]


def take_dyn(planes, idx: jnp.ndarray):
    """Per-row dynamic gather ``out[b, i] = x[b, idx[b, i]]`` as a one-hot
    batched matmul.

    An alternative to ``jnp.take_along_axis`` that contracts a one-hot
    [B, Lo, Lx] compare in a matrix product.  uint8 payloads are exact in
    bfloat16
    (integers up to 256).  Out-of-range indices yield 0 -- callers either
    clip (identical to take_along_axis) or mask those positions downstream.

    ``planes``: one [B, Lx] array, or a sequence of them sharing ``idx``
    (contracted against the same one-hot in a single dot).
    ``idx``: [B, Lo] int32.
    """
    single = not isinstance(planes, (tuple, list))
    if single:
        planes = (planes,)
    lx = planes[0].shape[1]
    # the one-hot is an O(B*Lo*Lx) HBM intermediate where the gather is
    # O(B*Lo); past ~1 GiB (very long reads x big chunks) fall back to the
    # scalar-path gather rather than risk device OOM.  Every call site
    # pre-clips idx in range, where the two are element-identical.
    if planes[0].shape[0] * idx.shape[1] * lx * 2 > (1 << 30):
        outs = tuple(jnp.take_along_axis(p, jnp.clip(idx, 0, lx - 1), axis=1)
                     for p in planes)
        return outs[0] if single else outs
    hot = (idx[:, :, None] ==
           jax.lax.broadcasted_iota(jnp.int32, (1, 1, lx), 2)
           ).astype(jnp.bfloat16)
    stacked = jnp.stack([p.astype(jnp.bfloat16) for p in planes], axis=2)
    out = jax.lax.dot_general(hot, stacked, (((2,), (1,)), ((0,), (0,))),
                              preferred_element_type=jnp.float32)
    outs = tuple(out[:, :, k].astype(planes[k].dtype)
                 for k in range(len(planes)))
    return outs[0] if single else outs


def shift_rows(planes, shift: jnp.ndarray):
    """Per-row cyclic shift ``out[b, i] = x[b, (i + shift[b]) mod L]`` as a
    barrel rotate: log2(L) conditional static rolls, each a select over
    rotated copies, so nothing is materialized beyond the planes themselves
    (the one-hot-matmul gather of :func:`take_dyn` builds a [B, L, L]
    intermediate).  Positions that wrap read cyclic garbage -- callers mask by
    the row's valid length, exactly as with the padding garbage before.

    ``planes``: one [B, L] array, or a sequence sharing ``shift``.
    ``shift``: [B] int32 (any sign).
    """
    single = not isinstance(planes, (tuple, list))
    xs = [planes] if single else list(planes)
    L = xs[0].shape[1]
    s = jnp.mod(shift, L)
    if L % 4 == 0 and L >= 8 and all(x.dtype == jnp.uint8 for x in xs):
        xs = _shift_rows_packed(xs, s, L)
    else:
        k = 1
        while k < L:
            bit = ((s & k) != 0)[:, None]
            xs = [jnp.where(bit, jnp.roll(x, -k, axis=1), x) for x in xs]
            k <<= 1
    return xs[0] if single else tuple(xs)


def _shift_rows_packed(xs, s, L):
    """uint8 byte-rotate via packed uint32 lanes -- exactly cyclic mod L when
    L % 4 == 0.  The barrel rotate over u8 elements pays a permute per
    log2(L) step; packing 4 bytes per u32 word cuts the element count 4x
    and moves the sub-word rotate into register shifts.  Word rotate by
    s//4, then the
    s%4 byte phase is one select over (w >> 8r) | (next_lane << (32-8r))
    (little-endian byte order, verified by the cyclic-wrap unit test)."""
    NL = L // 4
    q = s // 4
    r = s % 4
    outs = []
    for x in xs:
        B = x.shape[0]
        v = jax.lax.bitcast_convert_type(x.reshape(B, NL, 4), jnp.uint32)
        k = 1
        while k < NL:
            bit = ((q & k) != 0)[:, None]
            v = jnp.where(bit, jnp.roll(v, -k, axis=1), v)
            k <<= 1
        w1 = jnp.roll(v, -1, axis=1)
        res = v
        for rr in (1, 2, 3):
            res = jnp.where((r == rr)[:, None],
                            (v >> jnp.uint32(8 * rr))
                            | (w1 << jnp.uint32(32 - 8 * rr)), res)
        outs.append(jax.lax.bitcast_convert_type(res, jnp.uint8).reshape(B, L))
    return outs


def align(planes, start: jnp.ndarray):
    """Left-align each row at ``start``; positions past the end read
    wrapped garbage -- callers must mask by the new length.
    ``planes``: one [B, L] array or a (seq, qual) pair sharing the shift."""
    return shift_rows(planes, start)


def align_static(seq: jnp.ndarray, k: int) -> jnp.ndarray:
    """Left-shift every row by the STATIC offset ``k`` (slice + pad, no
    per-row rotate as in :func:`align`).
    Used when the front offset is a compile-time constant (force-front trim
    with quality front-cut disabled)."""
    if k == 0:
        return seq
    return jnp.pad(seq[:, k:], ((0, 0), (0, k)))


def select_at(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """x[b, idx[b]] as a masked reduction -- one compare + sum instead of
    a per-row gather."""
    sel = positions(x.shape[1]) == idx[:, None]
    return jnp.sum(jnp.where(sel, x, jnp.zeros((), x.dtype)), axis=1)


def prefix_sums(x: jnp.ndarray) -> jnp.ndarray:
    """[B, L] -> [B, L+1] exclusive prefix sums in int32."""
    c = jnp.cumsum(x.astype(jnp.int32), axis=1)
    return jnp.pad(c, ((0, 0), (1, 0)))
