"""Run the CLI's SE and PE paths on one NVIDIA GPU and check the results.

    python chip_smoke.py            # one card: five configs + kernel checks
    python chip_smoke.py --four     # four cards: se_qualtrim and pe_full only

Phases, each fatal on failure:

1. the device: ``nvidia-smi`` name and power limit, JAX's platform (must be
   ``gpu``; ``JAX_PLATFORMS=cuda`` makes a missing card an error instead of a
   silent CPU run), device kind and count, and whether the native host core
   built;
2. seeded Illumina-like input (``fqtool_tpu.synth``): 400,000 SE reads and
   200,000 pairs of 2x151 bp, gzip;
3. each config through ``fqtool_tpu.main.main`` twice, cold then warm, with
   compile seconds (cold wall minus warm wall), warm wall and reads/s;
4. the same configs in a child process on JAX's CPU backend (the card stays
   with this process): decompressed FASTQ streams must be byte-identical and
   the JSON reports equal apart from their ``Software`` section;
5. ``overlap.analyze``, ``stats.stat_batch`` and ``stats.kmer_counts`` on
   the card at full chunk rows and width 152 against the NumPy references
   in ``tests/reference_ops.py``, exactly.

The last stdout line is ``{"ok": true, "device": {...}}``.  ``--cpu-rehearsal``
runs everything on the CPU backend at whatever ``--reads``/``--pairs`` are
given; it exists for tests and dry runs and is never the default.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ADAPTER_R1 = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
# name -> (paired, flags); the five benchmark configs
CONFIGS = {
    "se_qualtrim": (False, ["-q", "-f", "3", "-t", "2"]),
    "se_polygx": (False, ["-g", "-x"]),
    "se_adapter": (False, ["-a", "--adapter_of_read1", ADAPTER_R1]),
    "pe_merge_corr": (True, ["-m", "--merge_output", "{out}/merged.fq.gz",
                             "-c"]),
    "pe_full": (True, ["-q", "--kmer", "--kmer_length", "6", "-d", "-a",
                       "--detect_pe_adapter"]),
}
FOUR_CONFIGS = ("se_qualtrim", "pe_full")
SE_ROWS, PE_ROWS = 65536, 16384   # device chunk rows (pipeline/runner.py)
WIDTH = 152                       # 151 bp rounded up to 8 (io/fastq.py)
OVERLAP_SAMPLE = 1024
DIFF_LIMIT, OVERLAP_REQUIRE = 5, 30   # CLI defaults


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(devices) -> None:
    """Refuse to go on unless JAX's first device is a GPU."""
    check(bool(devices) and devices[0].platform == "gpu",
          f"no GPU: JAX reports {devices[0].platform if devices else 'none'}")


def config_argv(name: str, inputs: dict, out: str) -> list:
    paired, flags = CONFIGS[name]
    if paired:
        io_args = ["-i", inputs["pe1"], "-I", inputs["pe2"],
                   "-o", f"{out}/out1.fq.gz", "-O", f"{out}/out2.fq.gz"]
    else:
        io_args = ["-i", inputs["se"], "-o", f"{out}/out.fq.gz"]
    return io_args + [f.format(out=out) for f in flags] + [
        "-J", f"{out}/report.json", "-H", f"{out}/report.html"]


def run_config(name: str, inputs: dict, out: str) -> float:
    """One CLI run through the user's entry point; returns its wall."""
    from fqtool_tpu.main import main

    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    rc = main(config_argv(name, inputs, out))
    wall = time.perf_counter() - t0
    check(rc == 0, f"{name}: fqtool_tpu.main.main returned {rc}")
    return wall


def compare_outputs(name: str, got: str, want: str) -> str:
    """Byte equality of every decompressed FASTQ stream and equality of the
    JSON reports outside ``Software``."""
    streams = sorted(f for f in os.listdir(want) if f.endswith(".fq.gz"))
    check(streams == sorted(f for f in os.listdir(got)
                            if f.endswith(".fq.gz")),
          f"{name}: output streams differ: {streams}")
    for f in streams:
        with gzip.open(os.path.join(got, f)) as a, \
                gzip.open(os.path.join(want, f)) as b:
            check(a.read() == b.read(), f"{name}: {f} differs from CPU")
    reports = []
    for d in (got, want):
        with open(os.path.join(d, "report.json")) as fh:
            rep = json.load(fh)
        rep.pop("Software", None)
        reports.append(rep)
    diff = sorted(k for k in set(reports[0]) | set(reports[1])
                  if reports[0].get(k) != reports[1].get(k))
    check(not diff, f"{name}: report.json differs from CPU in {diff}")
    return f"{name}: {', '.join(streams)} and report.json equal CPU"


def make_inputs(workdir: str, seed: int, reads: int, pairs: int,
                names) -> dict:
    from fqtool_tpu import synth

    inputs = {"se": f"{workdir}/se.fq.gz", "pe1": f"{workdir}/pe1.fq.gz",
              "pe2": f"{workdir}/pe2.fq.gz"}
    if any(not CONFIGS[n][0] for n in names):
        synth.write_se(inputs["se"], reads, seed)
    if any(CONFIGS[n][0] for n in names):
        synth.write_pe(inputs["pe1"], inputs["pe2"], pairs, seed)
    return inputs


def _pad(x: np.ndarray, width: int) -> np.ndarray:
    return np.pad(x, ((0, 0), (0, width - x.shape[1])))


def check_kernels(seed: int, se_rows: int, pe_rows: int,
                  sample: int) -> list:
    """The three ops on the default device against tests/reference_ops.py,
    at ``[pe_rows, WIDTH]`` (overlap) and ``[se_rows, WIDTH]`` (stats)."""
    import jax

    from fqtool_tpu import synth
    from fqtool_tpu.ops import overlap, stats
    from tests import reference_ops as ref

    lines = []
    rng = np.random.default_rng(seed)
    pe = synth.make_reads(pe_rows, seed + 1, paired=True)
    s1, s2 = _pad(pe["seq1"], WIDTH), _pad(pe["seq2"], WIDTH)
    rl = np.full(pe_rows, synth.READ_LEN, np.int32)
    got = jax.jit(overlap.analyze, static_argnums=(4, 5))(
        s1, rl, s2, rl, DIFF_LIMIT, OVERLAP_REQUIRE)
    idx = np.sort(rng.choice(pe_rows, sample, replace=False))
    want = ref.overlap_analyze(s1[idx], rl[idx], s2[idx], rl[idx],
                               DIFF_LIMIT, OVERLAP_REQUIRE)
    for f in got._fields:
        bad = int((np.asarray(getattr(got, f))[idx] != want[f]).sum())
        check(bad == 0, f"overlap.analyze: {bad} of {sample} pairs differ "
                        f"from the scalar reference in {f}")
    lines.append(f"overlap.analyze [{pe_rows}, {WIDTH}]: {sample} sampled "
                 f"pairs equal the scalar reference "
                 f"({int(want['overlapped'].sum())} overlapped, "
                 f"{int((want['offset'] < 0).sum())} read-through)")

    se = synth.make_reads(se_rows, seed + 2, paired=False)
    seq, qual = _pad(se["seq1"], WIDTH), _pad(se["qual1"], WIDTH)
    rlen = rng.integers(20, synth.READ_LEN + 1, se_rows).astype(np.int32)
    select = rng.random(se_rows) < 0.9
    got = jax.jit(stats.stat_batch)(seq, qual, rlen, select)
    want = ref.stat_batch(seq, qual, rlen, select)
    for f in got._fields:
        check(np.array_equal(np.asarray(getattr(got, f)), want[f]),
              f"stats.stat_batch: {f} differs from the np.add.at reference")
    lines.append(f"stats.stat_batch [{se_rows}, {WIDTH}]: equal to the "
                 "np.add.at reference")

    got = jax.jit(stats.kmer_counts, static_argnums=2)(seq, rlen, 6, select)
    want = ref.kmer_counts(seq, rlen, 6, select)
    check(np.array_equal(np.asarray(got), want),
          "stats.kmer_counts: k=6 histogram differs from np.bincount")
    lines.append(f"stats.kmer_counts k=6 [{se_rows}, {WIDTH}]: equal to the "
                 f"np.bincount reference ({int(want.sum())} k-mers)")
    return lines


class _Tee(io.TextIOBase):
    """A stream that copies what it is given into a buffer."""

    def __init__(self, stream):
        self.stream = stream
        self.buf = io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def start_cpu_reference(workdir: str, names) -> subprocess.Popen:
    """This script in a child on JAX's CPU backend, with no card visible.
    It keeps its own compile cache in the work directory, so the card's
    process finds only its own programs in the checkout's cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               JAX_COMPILATION_CACHE_DIR=f"{workdir}/cpu_jax_cache")
    env.pop("XLA_FLAGS", None)
    log = open(f"{workdir}/cpu_reference.log", "wb")
    try:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-reference",
             workdir, "--configs", ",".join(names)],
            stdout=log, stderr=subprocess.STDOUT, env=env)
    finally:
        log.close()


def cpu_reference(workdir: str, names) -> None:
    inputs = {"se": f"{workdir}/se.fq.gz", "pe1": f"{workdir}/pe1.fq.gz",
              "pe2": f"{workdir}/pe2.fq.gz"}
    for name in names:
        wall = run_config(name, inputs, f"{workdir}/cpu/{name}")
        print(f"cpu {name}: {wall:.3f} s", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--reads", type=int, default=400_000,
                    help="single-end reads")
    ap.add_argument("--pairs", type=int, default=200_000,
                    help="read pairs")
    ap.add_argument("--four", action="store_true",
                    help="run se_qualtrim and pe_full data-parallel over "
                         "four cards, and nothing else")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run on the CPU backend (tests and dry runs only)")
    ap.add_argument("--cpu-reference", metavar="WORKDIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--configs", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.cpu_reference:
        cpu_reference(args.cpu_reference, args.configs.split(","))
        return 0
    rehearsal = args.cpu_rehearsal
    os.environ["JAX_PLATFORMS"] = "cpu" if rehearsal else "cuda"

    # 1. the device
    if rehearsal:
        card = "CPU rehearsal, no card"
    else:
        card = nvidia_smi()
        print(card, flush=True)
    import jax

    devices = jax.devices()
    if not rehearsal:
        require_gpu(devices)
    print(f"jax {jax.__version__}: platform {devices[0].platform}, "
          f"{len(devices)} x {devices[0].device_kind}", flush=True)
    from fqtool_tpu.io import native
    from fqtool_tpu.main import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)

    lib = native.get_lib()
    print("native host core: " + ("loaded" if lib is not None else
          f"NOT loaded, pure-Python host path ({native.load_error()})"),
          flush=True)

    names = FOUR_CONFIGS if args.four else tuple(CONFIGS)
    if args.four:
        check(len(devices) == 4, f"--four needs 4 devices, JAX has "
                                 f"{len(devices)}")
    tag = card.splitlines()[0]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    child = None
    try:
        # 2. input
        t0 = time.perf_counter()
        inputs = make_inputs(workdir, args.seed, args.reads, args.pairs,
                             names)
        print(f"input: {args.reads} SE reads, {args.pairs} pairs, seed "
              f"{args.seed}, generated in {time.perf_counter() - t0:.1f} s",
              flush=True)
        child = start_cpu_reference(workdir, names)

        # 3. the configs on the device, cold then warm
        for name in names:
            out = f"{workdir}/dev/{name}"
            tee = _Tee(sys.stderr)
            with contextlib.redirect_stderr(tee):
                cold = run_config(name, inputs, out + "_cold")
                warm = run_config(name, inputs, out)
            if args.four:
                check("data-parallel over 4 devices" in tee.buf.getvalue(),
                      f"{name}: the run did not go data-parallel")
            paired = CONFIGS[name][0]
            n_reads = 2 * args.pairs if paired else args.reads
            print(f"{name}: compile {cold - warm:.3f} s, warm wall "
                  f"{warm:.3f} s, {n_reads / warm:.1f} reads/s "
                  f"({len(devices)} x {devices[0].device_kind}; {tag})",
                  flush=True)

        # 5. the kernels against plain references (before waiting on 4)
        if not args.four:
            for line in check_kernels(args.seed, min(SE_ROWS, args.reads),
                                      min(PE_ROWS, args.pairs),
                                      min(OVERLAP_SAMPLE, args.pairs)):
                print(line, flush=True)

        # 4. the CPU backend's records
        t0 = time.perf_counter()
        rc = child.wait(timeout=900)
        with open(f"{workdir}/cpu_reference.log", "rb") as fh:
            log = fh.read().decode(errors="replace")
        check(rc == 0, f"CPU reference run failed (rc {rc}):\n{log[-4000:]}")
        walls = [ln for ln in log.splitlines() if ln.startswith("cpu ")]
        print(f"CPU reference finished (waited {time.perf_counter() - t0:.1f}"
              f" s): " + "; ".join(walls), flush=True)
        for name in names:
            print(compare_outputs(name, f"{workdir}/dev/{name}",
                                  f"{workdir}/cpu/{name}"), flush=True)
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(workdir, ignore_errors=True)

    result = {"ok": True, "device": {"platform": devices[0].platform,
                                     "kind": devices[0].device_kind,
                                     "count": len(devices)}}
    if rehearsal:
        result["rehearsal"] = "cpu"
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
