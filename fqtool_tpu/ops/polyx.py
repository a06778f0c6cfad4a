"""PolyG / polyX tail trimming.

Vectorized port of ``PolyX::trimPolyG`` / ``trimPolyX``
(reference: src/polyx.cpp:14-101).  Both scan from the 3' end with a growing
mismatch budget ``min(maxMismatch, max(1, (i+1)/each))`` and trigger when the
scanned length (break position + 1) reaches ``compareReq``.

The 3'-end scan runs over the STATIC lane flip ``seq[:, ::-1]`` with the
scanned index recovered per row as ``i = q - (L - rlen)``: the static
flip needs no per-row reversal gather.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .common import A, C, G, N, T, first_true, last_true, positions


class PolyTrimResult(NamedTuple):
    rlen: jnp.ndarray      # int32 [B] new length
    trimmed: jnp.ndarray   # bool [B] a trim event was recorded
    trim_len: jnp.ndarray  # int32 [B] bases recorded by addPolyXTrimmed
    base_idx: jnp.ndarray  # int32 [B] 0..4 = A/T/C/G/N index recorded


def _scan_frame(seq: jnp.ndarray, rlen: jnp.ndarray):
    """(flipped seq, scanned index per column, scan mask).

    Column q of the flip holds absolute position p = L-1-q; the 3'-end scan
    index is i = q - (L - rlen), valid where i >= 0."""
    L = seq.shape[1]
    rev = seq[:, ::-1]
    iq = positions(L) - (L - rlen)[:, None]  # [B, L] scanned index at column q
    return rev, iq, iq >= 0


def _allowed_mismatch(iq: jnp.ndarray, max_mismatch: int, each: int) -> jnp.ndarray:
    return jnp.minimum(max_mismatch, jnp.maximum(1, (iq + 1) // each))


def trim_polyg(seq: jnp.ndarray, rlen: jnp.ndarray, compare_req: int,
               max_mismatch: int, each: int) -> PolyTrimResult:
    """reference: src/polyx.cpp:14-38.

    Returns the new length plus the FilterResult event (base index 3 = G,
    length = rlen - firstGpos, recorded whenever the scan length reaches
    compareReq -- even when resize() is a no-op, e.g. firstGpos = -1 on an
    empty read under the PE argument-swap parameters).
    """
    B, L = seq.shape
    rev, iq, mask = _scan_frame(seq, rlen)
    is_g = (rev == G) & mask
    mm = jnp.cumsum((~is_g & mask).astype(jnp.int32), axis=1)
    allowed = _allowed_mismatch(iq, max_mismatch, each)
    # break at first scanned i with mismatch > allowed; else i = rlen
    break_hit = (mm > allowed) & mask
    q_star = first_true(break_hit, jnp.int32(L))  # q = L <=> i = rlen
    i_star = q_star - (L - rlen)
    # first G position = rlen - 1 - (largest scanned i <= i_star with G);
    # init rlen - 1 when no G seen (polyx.cpp:19,24)
    scan_mask = positions(L) <= q_star[:, None]
    j_star = last_true(is_g & scan_mask, jnp.int32(0))  # column of that G
    has_g = jnp.any(is_g & scan_mask, axis=1)
    first_g_pos = jnp.where(has_g, L - 1 - j_star, rlen - 1)
    triggered = (i_star + 1) >= compare_req
    trim_len = rlen - first_g_pos
    # resize(firstGpos) is a no-op when firstGpos < 0 (read.h:181-187)
    new_rlen = jnp.where(triggered & (first_g_pos >= 0), first_g_pos, rlen)
    return PolyTrimResult(new_rlen, triggered, trim_len,
                          jnp.full((B,), 3, jnp.int32))


# ATCGN tally order used by trimPolyX (polyx.cpp:48-49)
_POLYX_BASES = (A, T, C, G, N)


def trim_polyx(seq: jnp.ndarray, rlen: jnp.ndarray, trim_chr: str,
               compare_req: int, max_mismatch: int, each: int) -> PolyTrimResult:
    """reference: src/polyx.cpp:45-101.

    The cumulative ATCGN tallies are packed into ONE int32 cumsum plane
    when the width allows (L <= 255: four 8-bit A/T/C/G fields, with the
    N tally DERIVED as scanned-count minus the four -- the five classes
    partition the scanned columns), falling back to two 10-bit-field
    planes for L <= 1023 and five planes beyond: one cumsum plane instead
    of five, and a select chain instead of a 6-entry LUT gather.  Counter
    fields cannot overflow at their width bound; bit-identical on every
    path (fuzz-validated incl. N's)."""
    B, L = seq.shape
    rev, iq, mask = _scan_frame(seq, rlen)
    in_trim = [c in trim_chr for c in "ATCGN"]
    cmp = iq + 1

    if L <= 255:
        contrib = jnp.where(rev == A, 1,
                  jnp.where(rev == T, 1 << 8,
                  jnp.where(rev == C, 1 << 16,
                  jnp.where(rev == G, 1 << 24, 0))))
        c1 = jnp.cumsum(jnp.where(mask, contrib, 0).astype(jnp.int32), axis=1)
        f = jnp.int32(255)
        counts = [c1 & f, (c1 >> 8) & f, (c1 >> 16) & f, (c1 >> 24) & f]
        counts.append(jnp.maximum(cmp, 0)
                      - counts[0] - counts[1] - counts[2] - counts[3])
    elif L <= 1023:
        # base class per column: A=0 T=1 C=2 G=3 other=4; masked-out
        # columns get class 5 (tallies nothing)
        contrib1 = jnp.where(rev == A, 1,
                   jnp.where(rev == T, 1 << 10,
                   jnp.where(rev == C, 1 << 20, 0)))
        contrib2 = jnp.where((rev == A) | (rev == T) | (rev == C), 0,
                   jnp.where(rev == G, 1, 1 << 10))
        c1 = jnp.cumsum(jnp.where(mask, contrib1, 0).astype(jnp.int32), axis=1)
        c2 = jnp.cumsum(jnp.where(mask, contrib2, 0).astype(jnp.int32), axis=1)
        f = jnp.int32(1023)
        counts = [c1 & f, (c1 >> 10) & f, (c1 >> 20) & f,
                  c2 & f, (c2 >> 10) & f]
    else:
        counts = []  # cumulative tallies per base, [B, L] each
        for bchar in _POLYX_BASES:
            if bchar == N:
                # default switch case: anything not A/T/C/G tallies as N
                hit = ~((rev == A) | (rev == T) | (rev == C) | (rev == G)) & mask
            else:
                hit = (rev == bchar) & mask
            counts.append(jnp.cumsum(hit.astype(jnp.int32), axis=1))

    allowed = _allowed_mismatch(iq, max_mismatch, each)
    # continue while ANY trim base still fits the budget (polyx.cpp:71-79)
    keep_going = jnp.zeros((B, L), bool)
    for b in range(5):
        if in_trim[b]:
            keep_going = keep_going | (cmp - counts[b] <= allowed)
    break_hit = ~keep_going & mask
    q_star = first_true(break_hit, jnp.int32(L))  # loop-exit column
    pos_star = q_star - (L - rlen)                # == rlen if completed
    triggered = (pos_star + 1) >= compare_req

    # tallies include the breaking position; for a completed scan use the last
    # valid index (column L-1).  One-hot masked reduction instead of a
    # per-row dynamic gather along the row
    tally_q = jnp.clip(jnp.minimum(q_star, jnp.int32(L - 1)), 0, L - 1)
    onehot_q = positions(L) == tally_q[:, None]  # [B, L]
    tallies = jnp.stack(
        [jnp.sum(jnp.where(onehot_q, c, 0), axis=1) for c in counts],
        axis=1)  # [B, 5]
    # dominant trim base: strict > comparison walking A,T,C,G,N
    # (polyx.cpp:83-90) == first argmax over trim bases in that order
    sel = jnp.array([(0 if t else -1) for t in in_trim], jnp.int32)[None, :]
    masked_tallies = jnp.where(sel == 0, tallies, -1)
    poly = jnp.argmax(masked_tallies, axis=1).astype(jnp.int32)  # [B]
    # select chain instead of a [B] table gather (lane-gather slow path)
    poly_char = jnp.where(poly == 0, A,
                jnp.where(poly == 1, T,
                jnp.where(poly == 2, C,
                jnp.where(poly == 3, G, N)))).astype(jnp.uint8)

    # pos = min(rlen-1, pos); back up to the last occurrence of the dominant
    # base (polyx.cpp:92-95): largest scanned p <= pos with rev[p] == polyBase,
    # else 0
    q_cap = jnp.minimum(jnp.int32(L - 1), q_star)
    match_dom = (rev == poly_char[:, None]) & (positions(L) <= q_cap[:, None]) & mask
    q_final = last_true(match_dom, (L - rlen))  # default: scanned index 0
    p_final = q_final - (L - rlen)
    # rlen == 0: the backup loop never runs and pos stays at min(rlen-1, pos) = -1
    p_final = jnp.where(rlen == 0, jnp.minimum(rlen - 1, pos_star), p_final)
    trim_len = p_final + 1
    new_len = rlen - p_final - 1
    new_rlen = jnp.where(triggered & (new_len >= 0), new_len, rlen)
    return PolyTrimResult(new_rlen, triggered, trim_len, poly)
