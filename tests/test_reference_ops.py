"""The device ops against their plain NumPy references (reference_ops.py):
overlap analysis, per-cycle statistics and k-mer counts, compared exactly."""

from __future__ import annotations

import numpy as np
import pytest

from . import reference_ops as ref

_COMP = {65: 84, 84: 65, 67: 71, 71: 67, 78: 78}


def _pairs(B, L, rng):
    """Random pairs with Ns and ragged lengths; every other pair gets a
    planted overlap (R2 starts with the reverse complement of R1's end),
    every fourth a read-through one (R1's start in R2's reverse
    complement), so both scan phases find hits."""
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    p = [.245, .245, .245, .245, .02]
    seq1 = rng.choice(alphabet, size=(B, L), p=p).astype(np.uint8)
    seq2 = rng.choice(alphabet, size=(B, L), p=p).astype(np.uint8)
    l1 = rng.integers(max(1, L // 3), L + 1, B).astype(np.int32)
    l2 = rng.integers(max(1, L // 3), L + 1, B).astype(np.int32)
    for b in range(0, B, 2):
        n1, n2 = int(l1[b]), int(l2[b])
        ol = int(min(n1, n2, rng.integers(20, 2 * L)))
        if b % 4 == 0:
            frag = seq1[b, n1 - ol: n1]
            seq2[b, :ol] = [_COMP[int(c)] for c in frag[::-1]]
        else:
            frag = seq1[b, :ol]
            seq2[b, n2 - ol: n2] = [_COMP[int(c)] for c in frag[::-1]]
        # a few mismatches inside the planted overlap
        for j in rng.integers(0, ol, int(rng.integers(0, 5))):
            seq2[b, j] = int(rng.choice(alphabet))
    pos = np.arange(L)[None, :]
    seq1 = np.where(pos < l1[:, None], seq1, 0).astype(np.uint8)
    seq2 = np.where(pos < l2[:, None], seq2, 0).astype(np.uint8)
    return seq1, l1, seq2, l2


@pytest.mark.parametrize("L", [40, 152, 251, 301])
@pytest.mark.parametrize("diff_limit,require", [(5, 30), (3, 20)])
def test_overlap_analyze_matches_scalar_reference(L, diff_limit, require):
    import jax

    from fqtool_tpu.ops import overlap

    rng = np.random.default_rng(L * 10 + diff_limit)
    seq1, l1, seq2, l2 = _pairs(64, L, rng)
    got = jax.jit(overlap.analyze, static_argnums=(4, 5))(
        seq1, l1, seq2, l2, diff_limit, require)
    want = ref.overlap_analyze(seq1, l1, seq2, l2, diff_limit, require)
    assert want["overlapped"].any() and (want["offset"] < 0).any()
    for name in got._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      want[name], err_msg=name)


def _reads(B, L, rng):
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (B, L),
                     p=[.24, .24, .24, .24, .04]).astype(np.uint8)
    qual = rng.choice(np.frombuffer(b"#-8FK", np.uint8), (B, L)).astype(np.uint8)
    rlen = rng.integers(0, L + 1, B).astype(np.int32)
    return seq, qual, rlen


@pytest.mark.parametrize("with_select", [False, True])
def test_stat_batch_matches_histogram_reference(with_select):
    import jax

    from fqtool_tpu.ops import stats

    rng = np.random.default_rng(3)
    seq, qual, rlen = _reads(300, 151, rng)
    select = rng.random(300) < 0.6 if with_select else None
    got = jax.jit(stats.stat_batch)(seq, qual, rlen, select)
    want = ref.stat_batch(seq, qual, rlen, select)
    for name in got._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      want[name], err_msg=name)


@pytest.mark.parametrize("k,with_select", [(6, False), (6, True), (4, True)])
def test_kmer_counts_matches_bincount_reference(k, with_select):
    import jax

    from fqtool_tpu.ops import stats

    rng = np.random.default_rng(k + 10 * with_select)
    seq, _, rlen = _reads(256, 152, rng)
    select = rng.random(256) < 0.7 if with_select else None
    got = jax.jit(stats.kmer_counts, static_argnums=2)(seq, rlen, k, select)
    np.testing.assert_array_equal(np.asarray(got),
                                  ref.kmer_counts(seq, rlen, k, select))
