"""Cross-validation of the grouped-correlation overlap analysis
(``analyze_mxu``) against the direct masked-compare implementation."""

from __future__ import annotations

import numpy as np
import pytest

_COMP = {65: 84, 84: 65, 67: 71, 71: 67, 78: 78}


def _gen(B, L, rng, plant=True):
    seq1 = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(B, L),
                      p=[.24, .24, .24, .24, .04]).astype(np.uint8)
    seq2 = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(B, L),
                      p=[.24, .24, .24, .24, .04]).astype(np.uint8)
    l1 = rng.integers(1, L + 1, B).astype(np.int32)
    l2 = rng.integers(1, L + 1, B).astype(np.int32)
    seq1 = np.where(np.arange(L)[None, :] < l1[:, None], seq1, 0).astype(np.uint8)
    seq2 = np.where(np.arange(L)[None, :] < l2[:, None], seq2, 0).astype(np.uint8)
    if plant:
        for b in range(0, B, 2):
            n1, n2 = int(l1[b]), int(l2[b])
            ol = int(min(n1, n2, rng.integers(25, 80)))
            frag = seq1[b, n1 - ol : n1]
            rc = np.array([_COMP.get(int(c), 78) for c in frag[::-1]], np.uint8)
            seq2[b, :ol] = rc
    return seq1, l1, seq2, l2


@pytest.mark.parametrize("L", [40, 96, 152, 200])
@pytest.mark.parametrize("dl,orq", [(5, 30), (3, 20), (5, 12), (1, 30)])
def test_mxu_matches_direct(L, dl, orq):
    from fqtool_tpu.ops import overlap as ovp

    rng = np.random.default_rng(L * 1000 + dl)
    seq1, l1, seq2, l2 = _gen(48, L, rng)
    a = ovp.analyze_mxu(seq1, l1, seq2, l2, dl, orq)
    d = ovp.analyze(seq1, l1, seq2, l2, dl, orq)
    for f in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(d, f)), err_msg=f)


def test_take_dyn_matches_take_along_axis():
    """take_dyn (one-hot matmul gather) must equal jnp.take_along_axis for
    in-range indices, on every dtype it is used with."""
    import jax.numpy as jnp
    import numpy as np

    from fqtool_tpu.ops.common import take_dyn

    rng = np.random.default_rng(5)
    B, L, LO = 64, 37, 51
    x = rng.integers(0, 256, (B, L)).astype(np.uint8)
    q = rng.integers(33, 105, (B, L)).astype(np.uint8)
    idx = rng.integers(0, L, (B, LO)).astype(np.int32)
    want_x = np.take_along_axis(x, np.minimum(idx, L - 1), axis=1)
    want_q = np.take_along_axis(q, np.minimum(idx, L - 1), axis=1)
    got_x, got_q = take_dyn((jnp.asarray(x), jnp.asarray(q)), jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(got_x), want_x)
    np.testing.assert_array_equal(np.asarray(got_q), want_q)
    # out-of-range indices must yield 0 (documented contract)
    oob = np.full((B, 3), L, np.int32)
    np.testing.assert_array_equal(np.asarray(take_dyn(jnp.asarray(x), jnp.asarray(oob))), 0)
