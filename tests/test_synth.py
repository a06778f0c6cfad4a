"""The seeded FASTQ generator: same seed, same bytes; reads as stated."""

from __future__ import annotations

import gzip

import numpy as np

from fqtool_tpu import synth


def test_same_seed_same_bytes(tmp_path):
    paths = [tmp_path / f"{k}.fq.gz" for k in ("a1", "a2", "b1", "b2", "c1", "c2")]
    synth.write_pe(str(paths[0]), str(paths[1]), 500, seed=5)
    synth.write_pe(str(paths[2]), str(paths[3]), 500, seed=5)
    synth.write_pe(str(paths[4]), str(paths[5]), 500, seed=6)
    assert paths[0].read_bytes() == paths[2].read_bytes()
    assert paths[1].read_bytes() == paths[3].read_bytes()
    assert paths[0].read_bytes() != paths[4].read_bytes()


def test_reads_are_as_stated(tmp_path):
    n = 4000
    r = synth.make_reads(n, seed=1, paired=True)
    for m in (1, 2):
        seq, qual = r[f"seq{m}"], r[f"qual{m}"]
        assert seq.shape == qual.shape == (n, synth.READ_LEN)
        assert set(np.unique(seq).tobytes()) <= set(b"ACGTN")
        assert set(np.unique(qual).tobytes()) == set(synth.QUAL_BINS)
        # Q2 marks N and nothing else
        np.testing.assert_array_equal(seq == ord("N"), qual == ord("#"))
        assert 0.0003 < (seq == ord("N")).mean() < 0.003
    isize = r["isize"]
    assert synth.INSERT_MIN <= isize.min() and isize.max() <= synth.INSERT_MAX
    assert 250 < isize.mean() < 350
    # pairs shorter than a read run into their adapter, and only those
    short = isize < synth.READ_LEN - len(synth.ADAPTER_R1)
    starts = np.frombuffer(synth.ADAPTER_R1[:12], np.uint8)
    hits = np.array([starts.tobytes() in r["seq1"][i].tobytes()
                     for i in range(n)])
    assert short.sum() > 10 and hits[short].mean() > 0.8
    assert hits[isize > 200].mean() < 0.01
    # a few per cent of mates end in a polyG run
    tail_g = (r["seq1"][:, -10:] == ord("G")).all(axis=1)
    assert 0.01 < tail_g.mean() < 0.06

    path = tmp_path / "r1.fq.gz"
    synth.write_fastq_gz(str(path), r["seq1"], r["qual1"], 1)
    lines = gzip.open(path).read().split(b"\n")
    assert len(lines) == 4 * n + 1 and lines[-1] == b""
    assert lines[0].startswith(b"@SYN:") and lines[0].endswith(b" 1:N:0:GATCAGAT")
    assert lines[1] == r["seq1"][0].tobytes() and lines[2] == b"+"
    assert lines[3] == r["qual1"][0].tobytes()
