"""Adapter trimming by provided/detected sequence.

Vectorized port of ``AdapterTrimmer::trimBySequence``
(reference: src/adaptertrimmer.cpp:29-90): every candidate position is scored
in parallel and the first match (in the reference scan order, including the
negative-start positions for long adapters) wins.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .common import first_true, positions

MATCH_REQUIRED = 4           # adaptertrimmer.cpp:30
ALLOW_ONE_MISMATCH_EACH = 8  # adaptertrimmer.cpp:31


def adapter_start(alen: int) -> int:
    """Scan start offset by adapter length (adaptertrimmer.cpp:45-51)."""
    if alen >= 16:
        return -4
    if alen >= 12:
        return -3
    if alen >= 8:
        return -2
    return 0


class AdapterTrimResult(NamedTuple):
    rlen: jnp.ndarray     # int32 [B] new length (0 when pos < 0 empties the read)
    found: jnp.ndarray    # bool [B]
    pos: jnp.ndarray      # int32 [B] matched position (may be negative)


def trim_by_sequence(seq: jnp.ndarray, rlen: jnp.ndarray,
                     adapter: np.ndarray) -> AdapterTrimResult:
    """``adapter`` is a host uint8 array of the ASCII adapter sequence; its
    length is static (one compiled kernel per distinct adapter length)."""
    B, L = seq.shape
    alen = int(adapter.shape[0])
    if alen < MATCH_REQUIRED:
        return AdapterTrimResult(rlen, jnp.zeros((B,), bool), jnp.zeros((B,), jnp.int32))

    start = adapter_start(alen)
    P = L + (-start)  # candidate positions start .. L-1
    pos_axis = positions(P) + start  # [1, P] actual pos values

    # mism[b, p] = sum over i in [max(0,-pos), cmplen) of adapter[i] != seq[b, i+pos]
    # computed as ``alen`` static shifted slices (no per-row gather)
    seq_pad = jnp.pad(seq, ((0, 0), (-start, alen)))  # read index i+pos -> col i+pos-start
    # uint8 accumulator (mism <= alen < 256): a quarter of the HBM traffic
    # of int32 across the ``alen`` accumulation passes
    mism = jnp.zeros(seq.shape[:1] + (P,), jnp.uint8)
    for i in range(alen):
        window = seq_pad[:, i : i + P]  # == seq[b, pos + i] over the pos axis
        neq = window != adapter[i]
        # compare region: i >= -pos (static per column) and pos + i < rlen
        valid_i = (pos_axis >= -i) & (pos_axis + i < rlen[:, None])
        mism = mism + (neq & valid_i).astype(jnp.uint8)
    mism = mism.astype(jnp.int32)
    cmplen = jnp.minimum(rlen[:, None] - pos_axis, alen)  # [B, P]
    allowed = cmplen // ALLOW_ONE_MISMATCH_EACH
    matched = mism <= allowed
    # valid scan positions: pos in [start, rlen - matchRequired)
    valid = pos_axis < (rlen[:, None] - MATCH_REQUIRED)
    hit = matched & valid
    found = jnp.any(hit, axis=1)
    first = first_true(hit, jnp.int32(0))
    pos = first + start
    # pos < 0 empties the read entirely (adaptertrimmer.cpp:72-78); else truncate
    new_rlen = jnp.where(found, jnp.where(pos < 0, 0, pos), rlen)
    return AdapterTrimResult(new_rlen, found, pos)
