"""Seeded Illumina-like FASTQ generator.

Reads are 2x151 bp (one mate for single-end files) sampled from a random
genome, with these properties:

* insert sizes ~ N(300, 80) clipped to [35, 700]: pairs with an insert
  shorter than the read read through into the TruSeq R1/R2 adapters, and
  pairs with an insert shorter than two reads overlap;
* a few per cent of reads end in a polyG tail (two-colour chemistry's
  no-signal base);
* sequencing errors at ~0.3% per base, carried at a low quality;
* N at ~0.1% per base, quality '#';
* qualities binned to the Illumina levels Q2/Q12/Q23/Q37 (``#``, ``-``,
  ``8``, ``F``; Q2 only on N), degrading towards the 3' end, with a few
  per cent of reads mostly low quality.

Names are fixed width, so a whole file is one ``[records, bytes]`` matrix.
Output is gzip with a zero mtime: the same seed gives the same bytes.
"""

from __future__ import annotations

import gzip
from typing import Dict, Tuple

import numpy as np

READ_LEN = 151
ADAPTER_R1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER_R2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
QUAL_BINS = b"#-8F"           # Q2, Q12, Q23, Q37
INSERT_MEAN, INSERT_SD = 300.0, 80.0
INSERT_MIN, INSERT_MAX = 35, 700
GENOME_LEN = 4_000_000
POLYG_FRAC = 0.03
ERROR_RATE = 0.003
N_RATE = 0.001
LOW_QUAL_FRAC = 0.04

_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[list(b"ACGTN")] = list(b"TGCAN")


def _tail(adapter: bytes, isize: np.ndarray,
          rng: np.random.Generator) -> np.ndarray:
    """[n, READ_LEN] of what a read shows once it runs past its insert:
    the adapter from position ``isize`` on, then random bases."""
    n = isize.shape[0]
    out = _BASES[rng.integers(0, 4, (n, READ_LEN))]
    k = np.arange(READ_LEN)[None, :] - isize[:, None]
    ad = np.frombuffer(adapter, np.uint8)
    inside = (k >= 0) & (k < len(ad))
    out[inside] = ad[k[inside]]
    return out


def _mate(frag: np.ndarray, isize: np.ndarray, adapter: bytes,
          rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Sequence and quality of one mate: the first READ_LEN bases of
    ``frag`` (the insert as this mate reads it), then adapter read-through,
    polyG tails, errors and Ns."""
    n = frag.shape[0]
    pos = np.arange(READ_LEN)[None, :]
    seq = np.where(pos < isize[:, None], frag, _tail(adapter, isize, rng))

    # polyG: the last t bases read as G
    g = rng.random(n) < POLYG_FRAC
    t = rng.integers(10, 61, n)
    seq = np.where(g[:, None] & (pos >= READ_LEN - t[:, None]), ord("G"), seq)

    # binned qualities, worse towards the 3' end and in low-quality reads
    frac = pos / (READ_LEN - 1)
    good = 0.93 - 0.25 * frac
    low = rng.random(n) < LOW_QUAL_FRAC
    good = np.where(low[:, None], 0.15, good)
    u = rng.random((n, READ_LEN))
    qidx = np.where(u < good, 3, np.where(u < good + (1 - good) * 0.6, 2, 1))
    qual = np.frombuffer(QUAL_BINS, np.uint8)[qidx]

    err = rng.random((n, READ_LEN)) < ERROR_RATE
    shift = rng.integers(1, 4, (n, READ_LEN))
    code = np.searchsorted(_BASES, seq)  # A/C/G/T -> 0..3
    seq = np.where(err, _BASES[(code + shift) % 4], seq)
    qual = np.where(err, np.uint8(ord("-")), qual)

    nb = rng.random((n, READ_LEN)) < N_RATE
    seq = np.where(nb, np.uint8(ord("N")), seq).astype(np.uint8)
    qual = np.where(nb, np.uint8(ord("#")), qual).astype(np.uint8)
    return seq, qual


def make_reads(n: int, seed: int, paired: bool) -> Dict[str, np.ndarray]:
    """``n`` reads (or pairs) as ``seq1``/``qual1`` [n, READ_LEN] uint8
    matrices, plus ``seq2``/``qual2`` when ``paired``, and ``isize`` [n]."""
    rng = np.random.default_rng(seed)
    genome = _BASES[rng.integers(0, 4, GENOME_LEN)]
    isize = np.clip(np.rint(rng.normal(INSERT_MEAN, INSERT_SD, n)),
                    INSERT_MIN, INSERT_MAX).astype(np.int64)
    start = rng.integers(0, GENOME_LEN - INSERT_MAX, n)
    pos = np.arange(READ_LEN)[None, :]
    # R1 reads the insert forward from its start; R2 reads its reverse
    # complement from the insert's far end
    fwd = genome[start[:, None] + pos]
    out = {"isize": isize}
    out["seq1"], out["qual1"] = _mate(fwd, isize, ADAPTER_R1, rng)
    if paired:
        far = start + isize - 1
        rev = _COMP[genome[np.maximum(far[:, None] - pos, 0)]]
        out["seq2"], out["qual2"] = _mate(rev, isize, ADAPTER_R2, rng)
    return out


def _digits(x: np.ndarray, width: int) -> np.ndarray:
    """[n, width] ASCII zero-padded decimal digits of ``x``."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((x[:, None] // p[None, :]) % 10 + ord("0")).astype(np.uint8)


def fastq_bytes(seq: np.ndarray, qual: np.ndarray, mate: int) -> bytes:
    """FASTQ text of fixed-length reads. Both mates of pair ``i`` share the
    name ``@SYN:1:FC0001:1:1101:<i>:<i % 100000>``; the comment carries
    the mate number."""
    n, L = seq.shape
    idx = np.arange(n, dtype=np.int64)
    cols = [
        np.frombuffer(b"@SYN:1:FC0001:1:1101:", np.uint8),
        _digits(idx, 9),
        np.frombuffer(b":", np.uint8),
        _digits(idx % 100000, 5),
        np.frombuffer(b" %d:N:0:GATCAGAT\n" % mate, np.uint8),
        seq,
        np.frombuffer(b"\n+\n", np.uint8),
        qual,
        np.frombuffer(b"\n", np.uint8),
    ]
    rec = np.concatenate(
        [np.broadcast_to(c, (n, c.shape[-1])) for c in cols], axis=1)
    return rec.tobytes()


def write_fastq_gz(path: str, seq: np.ndarray, qual: np.ndarray,
                   mate: int = 1) -> None:
    """Write reads as gzip FASTQ with a fixed header (mtime 0, no name)."""
    with open(path, "wb") as f, gzip.GzipFile(
            filename="", mode="wb", fileobj=f, mtime=0,
            compresslevel=1) as gz:
        gz.write(fastq_bytes(seq, qual, mate))


def write_se(path: str, n: int, seed: int) -> None:
    r = make_reads(n, seed, paired=False)
    write_fastq_gz(path, r["seq1"], r["qual1"], 1)


def write_pe(path1: str, path2: str, n: int, seed: int) -> None:
    r = make_reads(n, seed, paired=True)
    write_fastq_gz(path1, r["seq1"], r["qual1"], 1)
    write_fastq_gz(path2, r["seq2"], r["qual2"], 2)
