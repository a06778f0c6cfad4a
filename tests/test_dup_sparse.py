"""Duplication-table memory guard: key lengths past 15 spill to a sparse
slot table instead of allocating 4^keylen dense arrays (the reference
allocates 13 B x 4^keylen unconditionally and OOMs at keylen >= 16,
src/duplicate.cpp:3-13 -- a flaw we deliberately do not copy)."""

import json

import numpy as np
import pytest

from fqtool_tpu.host.duplicate import DuplicateTable


def _random_batches(rng, n_batches, batch, key_space, wide_keys=False):
    out = []
    for _ in range(n_batches):
        key = rng.integers(0, key_space, size=batch).astype(np.uint32).view(np.int32)
        key_hi = (rng.integers(0, 4, size=batch).astype(np.uint32).view(np.int32)
                  if wide_keys else None)
        kmer_hi = rng.integers(0, 1 << 8, size=batch).astype(np.uint32)
        kmer_lo = rng.integers(0, 1 << 8, size=batch).astype(np.uint32)
        gc = rng.integers(0, 256, size=batch).astype(np.uint8)
        valid = rng.random(batch) > 0.1
        out.append((key, kmer_hi, kmer_lo, gc, valid, key_hi))
    return out


def test_sparse_matches_dense():
    rng = np.random.default_rng(7)
    dense = DuplicateTable(6, 32)
    sparse = DuplicateTable(6, 32, force_sparse=True)
    for key, kmer_hi, kmer_lo, gc, valid, _ in _random_batches(
            rng, 5, 4096, 1 << 12):
        dense.add_batch(key, kmer_hi, kmer_lo, gc, valid)
        sparse.add_batch(key, kmer_hi, kmer_lo, gc, valid)
    h1, g1, r1 = dense.stat_all()
    h2, g2, r2 = sparse.stat_all()
    np.testing.assert_array_equal(h1, h2)
    np.testing.assert_allclose(g1, g2)
    assert r1 == r2


def test_sparse_wide_keys_distinct():
    """key_hi bits separate keys that share the low 32 bits."""
    t = DuplicateTable(17, 32)
    assert t.sparse
    key = np.array([5, 5, 5], np.int32)
    key_hi = np.array([0, 1, 0], np.int32)
    kh = np.array([1, 1, 1], np.uint32)
    kl = np.array([2, 2, 2], np.uint32)
    gc = np.array([10, 20, 30], np.uint8)
    valid = np.ones(3, bool)
    t.add_batch(key, kh, kl, gc, valid, key_hi=key_hi)
    hist, _, rate = t.stat_all()
    # two distinct keys: (5,0) seen twice, (5,1) once => one duplicate of 3
    assert hist[1] == 1 and hist[2] == 1
    assert rate == pytest.approx(1 / 3)


def test_keylen17_end_to_end(tmp_path):
    """--dup_ana_key_len 17 completes without a 4^17-entry allocation and
    reports a duplication section."""
    from fqtool_tpu import synth
    from fqtool_tpu.main import main as fq_main

    synth.write_se(str(tmp_path / "r1.fq.gz"), 12500, seed=17)
    rc = fq_main([
        "-i", str(tmp_path / "r1.fq.gz"),
        "-o", str(tmp_path / "out.fq"),
        "-J", str(tmp_path / "report.json"),
        "-H", str(tmp_path / "report.html"),
        "-d", "--dup_ana_key_len", "17",
    ])
    assert rc == 0
    report = json.loads((tmp_path / "report.json").read_text())
    assert "Duplication" in report
    assert report["Duplication"]["Rate"] >= 0.0


def test_pack_kmer32_matches_rolling16():
    """The u16 8-base-window kmer32 extraction (round 5) must agree with
    the u32 16-base rolling reference formulation on random data with N's
    and short reads."""
    import jax.numpy as jnp
    import numpy as np

    from fqtool_tpu.ops.common import seq2int_codes
    from fqtool_tpu.ops.dup import _pack_2bit, _pack_kmer32

    rng = np.random.default_rng(56)
    B, L = 96, 152
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                     (B, L), p=[0.24, 0.24, 0.24, 0.24, 0.04]).astype(np.uint8)
    rlen = rng.integers(0, L + 1, B).astype(np.int32)
    seq = np.where(np.arange(L)[None, :] < rlen[:, None], seq, 0).astype(np.uint8)
    codes = seq2int_codes(jnp.asarray(seq))
    start = jnp.maximum(0, jnp.asarray(rlen) - 37)
    hi_r, hi_ok_r = _pack_2bit(codes, start, 16)
    lo_r, lo_ok_r = _pack_2bit(codes, start + 16, 16)
    hi, hi_ok, lo, lo_ok = _pack_kmer32(codes, start)
    np.testing.assert_array_equal(np.asarray(hi), np.asarray(hi_r))
    np.testing.assert_array_equal(np.asarray(lo), np.asarray(lo_r))
    np.testing.assert_array_equal(np.asarray(hi_ok), np.asarray(hi_ok_r))
    np.testing.assert_array_equal(np.asarray(lo_ok), np.asarray(lo_ok_r))
