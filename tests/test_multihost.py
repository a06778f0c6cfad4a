"""Multi-host data-parallel golden tests.

Launches N fqtool_tpu processes on localhost (jax.distributed process group
on CPU, one virtual device each) and asserts the merged outputs are
byte-identical to the single-process run: FASTQ streams compared as raw file
bytes (including gzip framing -- the rank-0 merge recompresses the globally
ordered record stream through one writer) and the JSON report compared
key-for-key.

Reference architecture being replaced: producer/consumer pthreads + mutex
output ordering (src/seprocessor.cpp:59-180, peprocessor.cpp:525-658); here
packs stride across host processes and only end-of-stream statistics cross
hosts (dist/multihost.py).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from .oracle import TESTDATA, compare_json

R1 = TESTDATA / "r1.fq.gz"
R2 = TESTDATA / "r2.fq.gz"
REPO = str(Path(__file__).resolve().parent.parent)

# small packs so 12.5k reads spread over several ranks
_CHUNK_ENV = {
    "FQTOOL_TPU_SE_CHUNK": "2048",
    "FQTOOL_TPU_PE_CHUNK": "1024",
    "FQTOOL_TPU_SE_PACK_CHUNKS": "1",
    "FQTOOL_TPU_PE_PACK_CHUNKS": "2",
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _run_single(argv, workdir: Path) -> None:
    workdir.mkdir(parents=True, exist_ok=True)
    env = os.environ.copy()
    env.update(_CHUNK_ENV)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env.pop("FQTOOL_TPU_COORDINATOR", None)
    proc = subprocess.run(
        [sys.executable, "-m", "fqtool_tpu.main", *argv], cwd=workdir,
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr


def _run_multihost(argv, workdir: Path, nprocs: int) -> None:
    workdir.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    procs = []
    for rank in range(nprocs):
        env = os.environ.copy()
        env.update(_CHUNK_ENV)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.update({
            "FQTOOL_TPU_COORDINATOR": f"127.0.0.1:{port}",
            "FQTOOL_TPU_NPROCS": str(nprocs),
            "FQTOOL_TPU_PROC_ID": str(rank),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fqtool_tpu.main", *argv], cwd=workdir,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    fails = []
    for rank, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            fails.append(f"rank {rank} rc={p.returncode}:\n{err}")
    assert not fails, "\n".join(fails)


def _assert_equal_outputs(single: Path, multi: Path, outputs, json_name="report.json"):
    for name in outputs:
        a = (single / name).read_bytes() if (single / name).exists() else None
        b = (multi / name).read_bytes() if (multi / name).exists() else None
        assert a == b, f"{name}: multihost bytes differ from single-process"
    with open(single / json_name) as f:
        js = json.load(f)
    with open(multi / json_name) as f:
        jm = json.load(f)
    diffs = compare_json(jm, js)
    assert not diffs, "\n".join(diffs[:40])


@pytest.mark.parametrize("nprocs", [2, 4])
def test_multihost_se_quality_dup(tmp_path, nprocs):
    """SE config with quality filter, trims and duplication analysis."""
    argv = ["-i", str(R1), "-o", "out.fq.gz", "-q", "-f", "3", "-t", "2", "-d",
            "--failed_out", "failed.fq.gz"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / f"mh{nprocs}", nprocs)
    _assert_equal_outputs(tmp_path / "single", tmp_path / f"mh{nprocs}",
                          ("out.fq.gz", "failed.fq.gz"))


def test_multihost_pe_merge_correction(tmp_path):
    """PE merge + correction: stateful paths (insert-size histogram, dup
    combiner, correction patches) across 2 hosts."""
    argv = ["-i", str(R1), "-I", str(R2), "-o", "out1.fq.gz",
            "-O", "out2.fq.gz", "-m", "--merge_output", "merged.fq.gz",
            "-c", "-d", "--failed_out", "failed.fq.gz"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / "mh2", 2)
    _assert_equal_outputs(tmp_path / "single", tmp_path / "mh2",
                          ("merged.fq.gz", "failed.fq.gz"))


def test_multihost_sparse_dup_table(tmp_path):
    """keylen >= 16 spills the dup table to the sparse slot map; the
    cross-host merge must combine raw keys, not slot ids."""
    argv = ["-i", str(R1), "-o", "out.fq.gz", "-q", "-d",
            "--dup_ana_key_len", "17"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / "mh2", 2)
    _assert_equal_outputs(tmp_path / "single", tmp_path / "mh2",
                          ("out.fq.gz",))


def test_multihost_pe_full(tmp_path):
    """Full PE with adapter trimming, unpaired routing and kmer stats."""
    argv = ["-i", str(R1), "-I", str(R2), "-o", "out1.fq.gz",
            "-O", "out2.fq.gz", "-q", "--kmer", "--kmer_length", "6",
            "-d", "-a", "--detect_pe_adapter",
            "--unpaired_read1", "up1.fq.gz", "--unpaired_read2", "up2.fq.gz"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / "mh2", 2)
    _assert_equal_outputs(tmp_path / "single", tmp_path / "mh2",
                          ("out1.fq.gz", "out2.fq.gz", "up1.fq.gz", "up2.fq.gz"))


def _replicate(src: Path, dst: Path, n: int) -> None:
    data = src.read_bytes()
    with open(dst, "wb") as f:
        for _ in range(n):
            f.write(data)  # concatenated gzip members form one valid stream


def _gunzip_to(src: Path, dst: Path, n: int = 1) -> None:
    import gzip
    data = gzip.decompress(src.read_bytes())
    with open(dst, "wb") as f:
        for _ in range(n):
            f.write(data)


@pytest.mark.parametrize("nprocs", [2, 4])
def test_multihost_parallel_ingest_se_gz(tmp_path, nprocs):
    """Multi-member gzip SE input takes the parallel-ingest plan (each rank
    scans only its member range); outputs stay byte-identical to the
    single-process run (dist/ingest.py)."""
    _replicate(R1, tmp_path / "in8.fq.gz", 8)
    argv = ["-i", str(tmp_path / "in8.fq.gz"), "-o", "out.fq.gz",
            "-q", "-f", "3", "-t", "2", "-d",
            "--failed_out", "failed.fq.gz"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / f"mh{nprocs}", nprocs)
    _assert_equal_outputs(tmp_path / "single", tmp_path / f"mh{nprocs}",
                          ("out.fq.gz", "failed.fq.gz"))


def test_multihost_parallel_ingest_se_plain(tmp_path):
    """Plain-text SE input splits at raw byte offsets -- no rank reads bytes
    it does not own."""
    _gunzip_to(R1, tmp_path / "in4.fq", 4)
    argv = ["-i", str(tmp_path / "in4.fq"), "-o", "out.fq.gz", "-q"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / "mh3", 3)
    _assert_equal_outputs(tmp_path / "single", tmp_path / "mh3",
                          ("out.fq.gz",))


def test_multihost_parallel_ingest_pe(tmp_path):
    """Two-file PE over multi-member gzip with merge + correction."""
    _replicate(R1, tmp_path / "p1.fq.gz", 4)
    _replicate(R2, tmp_path / "p2.fq.gz", 4)
    argv = ["-i", str(tmp_path / "p1.fq.gz"), "-I", str(tmp_path / "p2.fq.gz"),
            "-o", "out1.fq.gz", "-O", "out2.fq.gz", "-m",
            "--merge_output", "merged.fq.gz", "-c", "-d",
            "--failed_out", "failed.fq.gz"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / "mh2", 2)
    _assert_equal_outputs(tmp_path / "single", tmp_path / "mh2",
                          ("merged.fq.gz", "failed.fq.gz"))


def test_multihost_parallel_ingest_interleaved(tmp_path):
    """Interleaved PE input under the plan: each rank parses only its owned
    spans (round-3 parsed every pack on every rank)."""
    import gzip
    l1 = gzip.decompress(R1.read_bytes()).split(b"\n")
    l2 = gzip.decompress(R2.read_bytes()).split(b"\n")
    inter = []
    for i in range(len(l1) // 4):
        inter += l1[4 * i: 4 * i + 4] + l2[4 * i: 4 * i + 4]
    (tmp_path / "inter.fq").write_bytes(b"\n".join(inter) + b"\n")
    argv = ["-i", str(tmp_path / "inter.fq"), "--in_fq_interleaved",
            "-o", "out1.fq.gz", "-q"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / "mh2", 2)
    _assert_equal_outputs(tmp_path / "single", tmp_path / "mh2",
                          ("out1.fq.gz",))


def _assert_equal_split_files(single: Path, multi: Path, pattern: str,
                              json_name="report.json"):
    """Same numbered-split file set and identical bytes per file."""
    s_files = sorted(p.name for p in single.glob(pattern))
    m_files = sorted(p.name for p in multi.glob(pattern))
    assert s_files == m_files and s_files, (s_files, m_files)
    _assert_equal_outputs(single, multi, s_files, json_name=json_name)


def test_multihost_split_by_lines_se(tmp_path):
    """`-S` under multi-host: rotation counts PASSED
    reads, so the rank-0 replay needs every pack's read_passed from the
    manifest; gz split files must be byte-identical to single-process."""
    argv = ["-i", str(R1), "-o", "out.fq.gz", "-q", "-S",
            "--splie_file_line", "3000", "--max_item_in_pack", "2500",
            "--failed_out", "failed.fq.gz"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / "mh2", 2)
    _assert_equal_split_files(tmp_path / "single", tmp_path / "mh2",
                              "*.out.fq.gz")
    _assert_equal_outputs(tmp_path / "single", tmp_path / "mh2",
                          ("failed.fq.gz",))


def test_multihost_split_by_file_number_fill(tmp_path):
    """`-s` under multi-host with a file quota larger than the rotation
    reaches: rank 0 must create the trailing EMPTY split files exactly like
    SplitWriter.close (threadconfig.cpp:131-137), plain-text outputs."""
    argv = ["-i", str(R1), "-o", "out.fq", "-q", "-s",
            "--split_file_number", "10", "--max_item_in_pack", "4000"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / "mh3", 3)
    _assert_equal_split_files(tmp_path / "single", tmp_path / "mh3",
                              "*.out.fq")


def test_multihost_split_pe(tmp_path):
    """PE split: out1/out2 rotate in lockstep; unpaired/failed streams merge
    as plain per-pack-framed streams."""
    argv = ["-i", str(R1), "-I", str(R2), "-o", "out1.fq.gz",
            "-O", "out2.fq.gz", "-q", "-S", "--splie_file_line", "3000",
            "--max_item_in_pack", "2500",
            "--unpaired_read1", "up1.fq.gz", "--failed_out", "failed.fq.gz"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / "mh2", 2)
    _assert_equal_split_files(tmp_path / "single", tmp_path / "mh2",
                              "*.out1.fq.gz")
    _assert_equal_split_files(tmp_path / "single", tmp_path / "mh2",
                              "*.out2.fq.gz")
    _assert_equal_outputs(tmp_path / "single", tmp_path / "mh2",
                          ("up1.fq.gz", "failed.fq.gz"))


def test_multihost_split_interleaved(tmp_path):
    """Interleaved PE input + `-S` split under multi-host: the planned
    interleaved ingest (rec_per_unit=2) must agree with the split pack
    quantum, and out1/out2 split files must match single-process bytes."""
    import gzip
    l1 = gzip.decompress(R1.read_bytes()).split(b"\n")
    l2 = gzip.decompress(R2.read_bytes()).split(b"\n")
    inter = []
    for i in range(len(l1) // 4):
        inter += l1[4 * i: 4 * i + 4] + l2[4 * i: 4 * i + 4]
    (tmp_path / "inter.fq").write_bytes(b"\n".join(inter) + b"\n")
    argv = ["-i", str(tmp_path / "inter.fq"), "--in_fq_interleaved",
            "-o", "out1.fq.gz", "-q", "-S",
            "--splie_file_line", "3000", "--max_item_in_pack", "2500"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / "mh2", 2)
    _assert_equal_split_files(tmp_path / "single", tmp_path / "mh2",
                              "*.out1.fq.gz")


def test_multihost_corrupt_input_fails_fast(tmp_path):
    """Corrupt gzip input under multi-host: every rank must exit nonzero
    with the clean gzip error quickly -- never hang on the reduction
    socket waiting for a peer that died (main.py failure path)."""
    data = R1.read_bytes() * 4
    bad = tmp_path / "bad.fq.gz"
    bad.write_bytes(data[: len(data) // 2] + b"GARBAGE"
                    + data[len(data) // 2: len(data) // 2 + 1000])
    argv = ["-i", str(bad), "-o", "out.fq.gz", "-q"]
    workdir = tmp_path / "mh2"
    workdir.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = os.environ.copy()
        env.update(_CHUNK_ENV)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.update({
            "FQTOOL_TPU_COORDINATOR": f"127.0.0.1:{port}",
            "FQTOOL_TPU_NPROCS": "2",
            "FQTOOL_TPU_PROC_ID": str(rank),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fqtool_tpu.main", *argv], cwd=workdir,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    for rank, p in enumerate(procs):
        try:
            _out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"rank {rank} hung on corrupt input")
        assert p.returncode != 0, f"rank {rank} unexpectedly succeeded"
        assert "gzip" in err.lower(), err[-500:]


def test_multihost_ora_report_world_size_invariant(tmp_path):
    """Multi-host ORA reports are world-size invariant:
    post-filter ORA sampling is deferred and replayed against the exact
    global passing-prefix counts (host/ora_defer.py), so a 2-proc run's
    JSON -- INCLUDING the ORA sections -- is bit-equal to the 1-proc run.
    The former per-host-strided deviation (PARITY.md, now deleted) is gone.
    The ORA section must be non-empty so the assertion bites."""
    argv = ["-i", str(R1), "-o", "out.fq.gz", "-q", "--ora"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / "mh2", 2)
    with open(tmp_path / "mh2" / "report.json") as f:
        jm = json.load(f)
    assert any(
        isinstance(v, dict) and v.get("OverrepresentedSequences")
        for v in jm.values()), "ORA section missing or empty in 2-proc report"
    _assert_equal_outputs(tmp_path / "single", tmp_path / "mh2",
                          ("out.fq.gz",))


def test_multihost_ora_pe_merge_world_size_invariant(tmp_path):
    """PE merge-mode ORA invariance: the merged stream's post1 sampling
    interleaves merged-read content with unmerged-kept r1 content
    (peprocessor.cpp:361-379); the deferred replay must reproduce the exact
    single-process sampled set at world size 2."""
    argv = ["-i", str(R1), "-I", str(R2), "-o", "out1.fq.gz",
            "-O", "out2.fq.gz", "-m", "--merge_output", "merged.fq.gz",
            "-c", "--ora"]
    _run_single(argv, tmp_path / "single")
    _run_multihost(argv, tmp_path / "mh2", 2)
    with open(tmp_path / "mh2" / "report.json") as f:
        jm = json.load(f)
    assert any(
        isinstance(v, dict) and v.get("OverrepresentedSequences")
        for v in jm.values()), "ORA section missing or empty in 2-proc report"
    _assert_equal_outputs(tmp_path / "single", tmp_path / "mh2",
                          ("merged.fq.gz",))


def test_multihost_malformed_tail_surfaces_on_rank0(tmp_path):
    """A trailing seq/qual length mismatch must reach rank 0's stderr, not
    scroll past in one worker's log while rank 0 exits clean (ADVICE r4).

    Two paths can satisfy this: the region planner's strictness proof
    rejects the malformed file, so every rank falls back to the serial
    reader and reports the error locally (the path this input takes); and
    for errors that reach the planned materializer, the end-of-stream
    gather re-prints peers' messages on rank 0
    (ingest.drain_stream_errors / multihost.surface_stream_errors)."""
    import gzip as _gzip

    lines = _gzip.open(R1).read().split(b"\n")
    recs = [b"\n".join(lines[i : i + 4]) for i in range(0, 4 * 256, 4)]
    name, seq, strand, qual = recs[-1].split(b"\n")
    recs[-1] = b"\n".join((name, seq, strand, qual[:-1]))  # short quality
    inp = tmp_path / "bad.fq"
    inp.write_bytes(b"\n".join(recs) + b"\n")

    workdir = tmp_path / "mh"
    workdir.mkdir()
    port = _free_port()
    procs = []
    for rank in range(2):
        env = os.environ.copy()
        env.update(_CHUNK_ENV)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.update({
            "FQTOOL_TPU_COORDINATOR": f"127.0.0.1:{port}",
            "FQTOOL_TPU_NPROCS": "2",
            "FQTOOL_TPU_PROC_ID": str(rank),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
            # small units so the 256-record input spans both ranks' plans
            "FQTOOL_TPU_WRITE_UNIT": "64",
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fqtool_tpu.main",
             "-i", str(inp), "-o", "out.fq.gz", "-q"], cwd=workdir,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    errs = []
    for rank, p in enumerate(procs):
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"rank {rank} rc={p.returncode}:\n{err}"
        errs.append(err)
    msg = "base sequnce and quality sequence have different length"
    assert msg in errs[1], "owning rank did not report the malformed tail"
    assert msg in errs[0], \
        "rank 0 did not surface the malformed-input error:\n" + errs[0]
