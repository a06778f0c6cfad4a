"""Throughput benchmark: the five driver configs from BASELINE.md.

Measures end-to-end CLI throughput (gzip in -> device pipeline -> gzip out ->
reports) on replicated copies of the reference testdata, steady-state (a
small warm-up run absorbs JIT compilation; the reference binary has no
comparable startup cost, and steady-state is the honest comparison for a
streaming tool).

Output contract (the driver tails stdout and parses the LAST line):
  * stderr: progress + the per-stage timing dump (host/tracing.py), flushed
    BEFORE the final line so it can never land after the metric.
  * ``bench_details.json`` (repo root): full per-config walls, stage splits,
    device-only ablation, link probe.
  * stdout, final line: ONE slim JSON object in the driver schema --
    ``{metric, value, unit, vs_baseline, configs, device_only, link_mbps}``
    where ``configs``/``device_only`` are flat ``{name: reads_per_sec}``.

Two throughput views per config:
  * end-to-end reads/s: the full CLI run (what a user sees), best of reps.
  * device-only reads/s: the jitted pipeline kernel looped on device-resident
    inputs via ``lax.scan`` (optimization barriers pin the body inside the
    loop), isolating the device from host transfers.

Baselines: the reference binary measured in this container (BASELINE.md),
plus the polyG config's oracle re-measured on the representative generated
input (see gen_polyg_input; the original input was 400k copies of one read).
"""

from __future__ import annotations

import atexit
import gzip
import json
import os
import shutil
import sys
import tempfile
import time

os.environ.setdefault("FQTOOL_TPU_TRACE", "1")

TESTDATA = "/root/reference/testdata"
REPO = os.path.dirname(os.path.abspath(__file__))
QUICK = os.environ.get("FQTOOL_TPU_BENCH_QUICK", "") == "1"

# (name, baseline reads/s, reps, paired, n_records, argv)
# Baselines: BASELINE.md (1-vCPU oracle, best of 3).  se_polygx: oracle
# measured in THIS container (-w 4) on the generated representative input
# (12.5k distinct polyG-tailed reads x 32).
CONFIGS = [
    ("se_qualtrim", 16_700, 5, False, 400_000,
     ["-q", "-f", "3", "-t", "2"]),
    ("se_polygx", 128_000, 4, False, 400_000,
     ["-g", "-x"]),
    ("se_adapter", 21_000, 4, False, 400_000,
     ["-a", "--adapter_of_read1", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"]),
    ("pe_merge_corr", 20_600, 4, True, 100_000,
     ["-m", "--merge_output", "merged.fq.gz", "-c"]),
    ("pe_full", 10_000, 4, True, 100_000,
     ["-q", "--kmer", "--kmer_length", "6", "-d", "-a", "--detect_pe_adapter"]),
]

# device-only loop geometry: rows per kernel invocation and scan length
DEVICE_ROWS = {"se_qualtrim": 65_536, "se_polygx": 65_536,
               "se_adapter": 65_536, "pe_merge_corr": 16_384,
               "pe_full": 16_384}
DEVICE_ITERS = {"se_qualtrim": 32, "se_polygx": 32, "se_adapter": 32,
                "pe_merge_corr": 8, "pe_full": 8}


def replicate(src: str, dst: str, n: int) -> None:
    data = open(src, "rb").read()
    with open(dst, "wb") as out:
        for _ in range(n):
            out.write(data)  # concatenated gzip members form one valid stream


def ensure_oracle() -> str:
    """Path to the compiled reference binary, building it from
    the reference sources if absent (the fair baseline is measured in the
    same session as our numbers).  Returns '' when neither the binary
    nor the reference sources are available."""
    import subprocess

    path = os.path.join(REPO, "build", "fqtool_oracle")
    if os.path.isfile(path) and os.access(path, os.X_OK):
        return path
    src = "/root/reference/src"
    if not os.path.isdir(src):
        return ""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    import glob as _glob
    cmd = ["g++", "-std=c++11", "-O2", "-w", "-I", src] + \
        sorted(_glob.glob(f"{src}/*.cpp")) + ["-o", path, "-lz", "-pthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except Exception:
        return ""
    return path


def oracle_fair_rate(oracle: str, workdir: str, paired: bool, name: str,
                     n_records: int, argv: List[str], reps: int) -> float:
    """Reads/s of the reference binary on the SAME inputs with a full-core
    worker pool (-w nproc) -- the honest baseline for this box.  Best of
    ``reps`` walls."""
    import subprocess

    nproc = os.cpu_count() or 1
    if paired:
        io = ["-i", "pe1.fq.gz", "-I", "pe2.fq.gz",
              "-o", "ro1.fq.gz", "-O", "ro2.fq.gz"]
    elif name == "se_polygx":
        io = ["-i", "polyg.fq", "-o", "ro.fq.gz"]
    else:
        io = ["-i", "se.fq.gz", "-o", "ro.fq.gz"]
    argv = [(a.replace("merged", "rmerged") if "merged" in a else a)
            for a in argv]
    cmd = [oracle] + io + argv + ["-w", str(nproc),
                                  "-J", "rref.json", "-H", "rref.html"]
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=workdir, capture_output=True, timeout=900)
        dt = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"oracle rc={r.returncode}: {r.stderr[-200:]}")
        best = min(best, dt)
    return round(n_records * (2 if paired else 1) / best, 1)


def gen_polyg_input(dst: str, reps: int = 32) -> int:
    """Representative polyG/polyX input: every r1.fq.gz read (12,500 distinct
    sequences) truncated and given a varied-length polyG tail with occasional
    single mismatches -- content diversity the original one-read-x-400k input
    lacked.  Deterministic.  Returns the record count written."""
    import numpy as np

    rng = np.random.default_rng(20260819)
    records = []
    with gzip.open(f"{TESTDATA}/r1.fq.gz", "rb") as f:
        lines = f.read().split(b"\n")
    n_rec = len(lines) // 4
    for i in range(n_rec):
        name, seq, strand, qual = lines[4 * i : 4 * i + 4]
        tail = int(rng.integers(15, 41))
        keep = max(len(seq) - tail, 30)
        g = bytearray(b"G" * tail)
        if rng.random() < 0.3:  # one mismatch, still within the 1-per-10 budget
            g[int(rng.integers(0, tail))] = int(rng.choice(list(b"ACT")))
        seq2 = seq[:keep] + bytes(g)
        qual2 = qual[: len(seq2)].ljust(len(seq2), b"F")
        records.append(b"\n".join((name, seq2, strand, qual2, b"")))
    blob = b"".join(records)
    with open(dst, "wb") as out:
        for _ in range(reps):
            out.write(blob)
    return n_rec * reps


def _backend() -> str:
    try:
        import jax
        return jax.default_backend()
    except Exception:
        return "unknown"


def link_probe_mbps() -> float:
    from fqtool_tpu.host.linkprobe import _probe_mbps
    try:
        return round(_probe_mbps(), 1)
    except Exception:
        return -1.0


def _device_args(name: str, paired: bool, argv: list, workdir: str):
    """(body, args, static_kw, rows) for the device-only loop, built the same
    way the production runners build their kernel invocations."""
    import numpy as np
    from fqtool_tpu.config.cli import parse_args
    from fqtool_tpu.host import evaluator
    from fqtool_tpu.io.fastq import iter_packs, iter_packs_paired

    rows = DEVICE_ROWS[name]
    if paired:
        opt = parse_args(["-i", f"{TESTDATA}/r1.fq.gz", "-I", f"{TESTDATA}/r2.fq.gz",
                          "-o", "dev1.fq", "-O", "dev2.fq"] + argv)
        evaluator.evaluate_read_len(opt)
        if opt.adapter.enable_detect_for_pe:
            evaluator.evaluate_adapter_seq(opt, False)
            evaluator.evaluate_adapter_seq(opt, True)
        from fqtool_tpu.pipeline.pe import pe_pipeline
        from fqtool_tpu.pipeline.pe_runner import PairEndRunner

        r = PairEndRunner(opt)
        pack1, pack2 = next(iter_packs_paired(
            f"{workdir}/pe1.fq.gz", f"{workdir}/pe2.fq.gz", False, rows,
            opt.phred64))
        zeros = np.zeros(rows, np.int32)
        ones = np.ones(rows, bool)
        args = (pack1.seq, pack1.qual, pack1.lens.astype(np.int32),
                pack2.seq, pack2.qual, pack2.lens.astype(np.int32),
                zeros, zeros, ones, ones)
        kw = dict(p=r.p1, p2=r.p2, adapter_r1=r.adapter_r1,
                  adapter_r2=r.adapter_r2, use_start0=False,
                  with_kmer=bool(opt.kmer.enabled),
                  discard_unmerged=bool(opt.merge_pe.discard_unmerged))
        return pe_pipeline.__wrapped__, args, kw, rows
    src = f"{workdir}/polyg.fq" if name == "se_polygx" else f"{workdir}/se.fq.gz"
    opt = parse_args(["-i", f"{TESTDATA}/r1.fq.gz", "-o", "dev.fq"] + argv)
    evaluator.evaluate_read_len(opt)
    from fqtool_tpu.pipeline.runner import SingleEndRunner
    from fqtool_tpu.pipeline.se import se_pipeline

    r = SingleEndRunner(opt)
    pack = next(iter_packs(src, rows, opt.phred64))
    zeros = np.zeros(rows, np.int32)
    ones = np.ones(rows, bool)
    args = (pack.seq, pack.qual, pack.lens.astype(np.int32), zeros, ones, ones)
    kw = dict(p=r.params, adapter_r1=r.adapter_r1, use_start0=False,
              with_kmer=bool(opt.kmer.enabled))
    return se_pipeline.__wrapped__, args, kw, rows


def device_only_rate(name: str, paired: bool, argv: list, workdir: str) -> float:
    """Chip-isolated reads/s: the pipeline kernel looped N times over
    device-resident inputs.  Two-point measurement (N vs 2N iterations, same
    compiled function, dynamic fori_loop bound) so the fixed per-call fetch /
    dispatch latency cancels exactly and only the marginal
    per-iteration pipeline cost remains."""
    import numpy as np

    import jax
    import jax.numpy as jnp
    from fqtool_tpu.pipeline.blob import blobify

    body, args, kw, rows = _device_args(name, paired, argv, workdir)

    def run(a, n):
        def step(i, c):
            # roll the pack by the (dynamic) iteration index: a genuine data
            # dependency per iteration, so XLA cannot hoist the pipeline out
            # of the loop or CSE iterations (rows are independent reads, so
            # the work stays representative; the roll itself is ~us of HBM
            # traffic against ~ms of pipeline)
            a2 = jax.tree_util.tree_map(
                lambda x: jnp.roll(x, i, axis=0) if x.ndim >= 1 else x, a)
            out = body(*a2, **kw)
            return c + jnp.sum(blobify(out), dtype=jnp.int32)
        return jax.lax.fori_loop(0, n, step, jnp.int32(0))

    f = jax.jit(run)
    dev = jax.device_put(args)
    n1 = DEVICE_ITERS[name]
    int(np.asarray(f(dev, n1)))  # compile + warm
    walls = []
    for n in (n1, 2 * n1):
        best = float("inf")
        for _ in range(2 if QUICK else 3):
            t0 = time.perf_counter()
            int(np.asarray(f(dev, n)))
            best = min(best, time.perf_counter() - t0)
        walls.append(best)
    dt = max(walls[1] - walls[0], 1e-9)
    reads = rows * n1 * (2 if paired else 1)
    return round(reads / dt, 1)


def transfer_split(name: str, paired: bool, argv: list,
                   workdir: str) -> dict:
    """Per-config transfer anatomy: one
    production chunk's host->device upload, device compute, and
    device->host result fetch, each measured in isolation.

    upload: a jitted reduce-to-scalar over the input arrays, called with
    HOST numpy arrays so every call pays the full transfer (one input byte
    is mutated per rep to defeat any caching).  compute: the two-point
    fori_loop marginal cost (device_only_rate).  download: the blob fetch
    delta -- wall of dispatch+np.asarray minus wall of
    dispatch+block_until_ready (result left on device)."""
    import numpy as np

    import jax
    import jax.numpy as jnp
    from fqtool_tpu.pipeline.blob import blobify

    body, args, kw, rows = _device_args(name, paired, argv, workdir)

    def best_of(f, n=3):
        f()
        best = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            f()
            best = min(best, time.perf_counter() - t0)
        return best

    # ---- upload: consume every input into one scalar
    up = jax.jit(lambda a: sum(
        jnp.sum(x.astype(jnp.int32) if x.dtype != jnp.int32 else x,
                dtype=jnp.int32)
        for x in jax.tree_util.tree_leaves(a) if getattr(x, "ndim", 0)))
    host_args = [np.array(a) for a in args]
    rep = [0]

    def do_upload():
        a0 = host_args[0]
        a0.flat[rep[0] % a0.size] ^= 1  # defeat transfer caching
        rep[0] += 1
        int(np.asarray(up(host_args)))
    upload_s = best_of(do_upload)

    # ---- production-transport upload: the b5 dictionary encoding replaces
    # the (seq, qual) planes with 0.625-byte/base packed planes on the wire
    # (runner.encode_packs); measure the same reduce over those bytes so the
    # probe reflects what production actually uploads
    b5_s = b5_bytes = None
    try:
        from fqtool_tpu.ops.packed import encode5_host, encode_host
        # from the PRISTINE args: do_upload's cache-busting bit flips write
        # non-ACGTN bytes into host_args' seq plane, which b5 rightly rejects
        pristine = [np.array(a) for a in args]
        planes = [a for a in pristine if a.ndim == 2 and a.dtype == np.uint8]
        rest = [a for a in pristine if not (a.ndim == 2 and a.dtype == np.uint8)]
        encs = []
        for k in range(0, len(planes), 2):
            enc = encode_host(planes[k], planes[k + 1])
            e5 = encode5_host(enc) if enc is not None else None
            if e5 is None:
                raise ValueError("pack not b5-encodable")
            encs += [e5[0], e5[1]]
        b5_args = encs + rest
        b5_bytes = sum(a.nbytes for a in b5_args)
        rep5 = [0]

        def do_upload_b5():
            a0 = b5_args[0]
            a0.flat[rep5[0] % a0.size] ^= 1
            rep5[0] += 1
            int(np.asarray(up(b5_args)))
        b5_s = best_of(do_upload_b5)
    except Exception:
        pass

    # ---- compute + download: device-resident inputs, rolled per rep
    dev = jax.device_put(args)
    g = jax.jit(lambda a, i: blobify(body(
        *jax.tree_util.tree_map(
            lambda x: jnp.roll(x, i, axis=0) if x.ndim >= 1 else x, a),
        **kw)))
    i = [0]

    def do_block():
        i[0] += 1
        jax.block_until_ready(g(dev, i[0]))

    def do_fetch():
        i[0] += 1
        np.asarray(g(dev, i[0]))
    block_s = best_of(do_block)
    fetch_s = best_of(do_fetch)
    blob_bytes = int(np.asarray(g(dev, 0)).nbytes)
    in_bytes = sum(a.nbytes for a in host_args)
    res = {
        "chunk_rows": rows,
        "input_mb": round(in_bytes / 1e6, 2),
        "blob_mb": round(blob_bytes / 1e6, 2),
        "upload_ms": round(upload_s * 1e3, 1),
        "compute_plus_rt_ms": round(block_s * 1e3, 1),
        "download_ms": round(max(fetch_s - block_s, 0.0) * 1e3, 1),
    }
    if b5_s is not None:
        res["b5_input_mb"] = round(b5_bytes / 1e6, 2)
        res["b5_upload_ms"] = round(b5_s * 1e3, 1)
    return res


def b5_fallback_probe(workdir: str) -> dict:
    """Transport fallback anatomy: legacy 40-level
    quality data exceeds the 32-entry b5 dictionary (ops/packed.py
    encode5_host returns None), so the wire falls back to the 1-byte joint
    encoding.  Measure that path's actual upload next to the binned b5
    upload on the same rows.  The 'two-plane' alternative is settled by
    arithmetic, not built: a 3-bit seq plane + 6-bit dictionary qual plane
    costs 9 bits/base, MORE than the 8 bits/base the fallback already pays
    (5 bases x 40 quals = 200 joint symbols <= 256, so the 1-byte joint
    code is already within 8/7.64 of the entropy bound for uniform data)."""
    import numpy as np

    import jax
    import jax.numpy as jnp
    from fqtool_tpu.io.fastq import iter_packs
    from fqtool_tpu.ops.packed import encode5_host, encode_host

    rows = 65_536
    pack = next(iter_packs(f"{workdir}/se.fq.gz", rows, False))
    rng = np.random.default_rng(20260820)
    # synthetic legacy quality: 40 distinct levels, '!'+2 .. '!'+41
    qual40 = np.where(pack.qual > 0,
                      rng.integers(35, 75, size=pack.qual.shape,
                                   dtype=np.uint8),
                      0).astype(np.uint8)
    enc40 = encode_host(np.ascontiguousarray(pack.seq),
                        np.ascontiguousarray(qual40))
    assert enc40 is not None
    assert encode5_host(enc40) is None, "40-level pack unexpectedly b5-able"
    enc_real = encode_host(np.ascontiguousarray(pack.seq),
                           np.ascontiguousarray(pack.qual))
    b5_real = encode5_host(enc_real)
    assert b5_real is not None

    up = jax.jit(lambda a: jnp.sum(a.astype(jnp.int32), dtype=jnp.int32))

    def best_upload(arr, n=3):
        rep = [0]

        def go():
            arr.flat[rep[0] % arr.size] ^= 1
            rep[0] += 1
            int(np.asarray(up(arr)))
        go()
        best = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            go()
            best = min(best, time.perf_counter() - t0)
        return best

    return {
        "chunk_rows": rows,
        "fallback_mb": round(enc40.nbytes / 1e6, 2),
        "fallback_upload_ms": round(best_upload(enc40) * 1e3, 1),
        "b5_mb": round(b5_real[0].nbytes / 1e6, 2),
        "b5_upload_ms": round(best_upload(np.ascontiguousarray(b5_real[0]))
                              * 1e3, 1),
        "distinct_vals_40level": int(len(np.unique(enc40))),
    }


def cold_start(workdir: str) -> dict:
    """Cold CLI walls: the steady-state e2e numbers
    exclude the ~3-4 s python+jax+XLA-cache process startup that a cold
    ``python -m fqtool_tpu.main`` invocation pays and the C++ oracle does
    not (~ms).  Measure it honestly: two cold subprocess runs per headline
    config (the first may also pay persistent-cache compilation; the second
    is the steady cold-start regime), and report the break-even read count
    where the steady-state rate advantage amortizes the startup.

    Runs before the parent process touches the device, so that one process
    holds the card at a time; bench.main() calls this first."""
    import subprocess

    out = {}
    env = os.environ.copy()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["FQTOOL_TPU_TRACE"] = "0"
    # the raw 12.5k-read testdata: cold wall is startup-dominated by
    # construction
    for name, argv, io in (
        ("se_qualtrim", ["-q", "-f", "3", "-t", "2"],
         ["-i", f"{TESTDATA}/r1.fq.gz", "-o", "cold.fq.gz"]),
        ("pe_full", ["-q", "--kmer", "--kmer_length", "6", "-d", "-a",
                     "--detect_pe_adapter"],
         ["-i", f"{TESTDATA}/r1.fq.gz", "-I", f"{TESTDATA}/r2.fq.gz",
          "-o", "cold1.fq.gz", "-O", "cold2.fq.gz"]),
    ):
        walls = []
        try:
            for _ in range(2):
                t0 = time.perf_counter()
                r = subprocess.run(
                    [sys.executable, "-m", "fqtool_tpu.main"] + io + argv,
                    cwd=workdir, env=env, capture_output=True, timeout=300)
                walls.append(round(time.perf_counter() - t0, 3))
                if r.returncode != 0:
                    sys.stderr.write(f"[bench] cold {name} rc={r.returncode}:"
                                     f" {r.stderr[-200:]}\n")
                    walls[-1] = None
                    break
        except subprocess.TimeoutExpired:
            sys.stderr.write(f"[bench] cold {name}: timed out "
                             "(>300s); skipping\n")
            walls.append(None)
        out[name] = {"cold_first_wall_s": walls[0],
                     "cold_wall_s": walls[-1]}
    return out


def golden_on_device(oracle_bin: str, workdir: str, paired: bool, name: str,
                     argv: list) -> bool:
    """Record-diff a run executed on the accelerator backend against the
    oracle at ``-w 1`` on the same replicated bench inputs (the test suite
    runs on the CPU backend, so this is the diff that exercises the device
    lowering).  Returns
    True when every output FASTQ stream is record-identical and the JSON
    reports match modulo the documented exceptions (tests/oracle.py)."""
    import subprocess

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from fqtool_tpu.main import main as fq_main
    from tests.oracle import compare_json, read_fastq

    if paired:
        ours_io = ["-i", "pe1.fq.gz", "-I", "pe2.fq.gz",
                   "-o", "gto1.fq.gz", "-O", "gto2.fq.gz"]
        ref_io = ["-i", "pe1.fq.gz", "-I", "pe2.fq.gz",
                  "-o", "gtr1.fq.gz", "-O", "gtr2.fq.gz"]
        pairs = [("gto1.fq.gz", "gtr1.fq.gz"), ("gto2.fq.gz", "gtr2.fq.gz")]
    elif name == "se_polygx":
        ours_io = ["-i", "polyg.fq", "-o", "gto.fq.gz"]
        ref_io = ["-i", "polyg.fq", "-o", "gtr.fq.gz"]
        pairs = [("gto.fq.gz", "gtr.fq.gz")]
    else:
        ours_io = ["-i", "se.fq.gz", "-o", "gto.fq.gz"]
        ref_io = ["-i", "se.fq.gz", "-o", "gtr.fq.gz"]
        pairs = [("gto.fq.gz", "gtr.fq.gz")]
    argv_ours = [(a.replace("merged", "gtomerged") if "merged" in a else a)
                 for a in argv]
    argv_ref = [(a.replace("merged", "gtrmerged") if "merged" in a else a)
                for a in argv]
    if "--merge_output" in argv:
        pairs.append(("gtomerged.fq.gz", "gtrmerged.fq.gz"))

    rc = fq_main(ours_io + argv_ours + ["-J", "gto.json", "-H", "gto.html"])
    if rc != 0:
        sys.stderr.write(f"[bench] {name}: golden run rc={rc}\n")
        return False
    r = subprocess.run(
        [oracle_bin] + ref_io + argv_ref
        + ["-w", "1", "-J", "gtr.json", "-H", "gtr.html"],
        cwd=workdir, capture_output=True, timeout=900)
    if r.returncode != 0:
        sys.stderr.write(f"[bench] {name}: golden oracle rc={r.returncode}\n")
        return False
    ok = True
    for o, rf in pairs:
        a = read_fastq(os.path.join(workdir, o))
        b = read_fastq(os.path.join(workdir, rf))
        if a != b:
            first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
            sys.stderr.write(f"[bench] {name}: {o} differs from oracle "
                             f"({len(a)} vs {len(b)} records, first diff at "
                             f"record {first})\n")
            ok = False
    with open(os.path.join(workdir, "gto.json")) as f:
        ja = json.load(f)
    with open(os.path.join(workdir, "gtr.json")) as f:
        jb = json.load(f)
    diffs = compare_json(ja, jb)
    if diffs:
        sys.stderr.write(f"[bench] {name}: JSON diffs vs oracle: "
                         + "; ".join(diffs[:5]) + "\n")
        ok = False
    return ok


def multihost_scaling(workdir: str, config: str = "se_qualtrim") -> dict:
    """Localhost multi-host scaling (BASELINE.md north star: >=90% linear
    reads/s scaling to N hosts **on SE and PE pipelines**): 1/2/4 processes
    over 1.6M reads, each rank PINNED to one core with taskset so per-host
    resources stay fixed as hosts are added.  Outputs are asserted
    byte-identical to the 1-proc run; the rank-0 merge is pure concatenation
    of rank-side-deflated spans (dist/multihost.py).

    ``config`` selects the pipeline: ``se_qualtrim`` (no evaluation
    pre-pass beyond read length) or ``pe_full`` (adapter auto-detection
    pre-pass -- runs ONCE on rank 0 and broadcasts, main.py::_prepass_multihost,
    mirroring the reference's once-only startup, main.cpp:128-143).

    Efficiency definition.  ``efficiency_N`` compares the N-process
    multihost steady wall against the *measured parallel control*: N
    CONCURRENT INDEPENDENT single-process runs, each on a disjoint 1/N of
    the input, pinned to the same N cores.  The control carries zero
    coordination cost, so the ratio isolates the multihost machinery's own
    overhead (plan pass, ownership skew, stat reduction, rank-0 merge) from
    this box's shared memory-bandwidth contention, which separate real
    hosts would not share (measured here: 4 independent quarter-runs take
    1.37x one quarter of the 1-proc wall purely from LLC/DRAM contention --
    no implementation could scale past that on one box).
    ``efficiency_N_vs_serial`` keeps the naive serial-baseline ratio
    (T_1proc / (N * T_Nproc), steady walls) for transparency, and
    ``efficiency_N_full`` the same over full process walls including the
    ~3-4s/process constant python+jax startup.

    Returns {procs: steady reads/s, ideal_N: control reads/s, ...}."""
    import socket
    import subprocess

    # 1.6M reads: big enough that the ~3-5s per-process startup (python +
    # jax import + XLA cache load, constant in N) stays under 10% of the
    # 2-proc wall -- the quantity BASELINE.md's north star describes is
    # steady-state streaming, not process launch
    if config == "pe_full":
        # 400k pairs: the CPU-backend PE pipeline streams ~6.5k reads/s per
        # pinned core, so 800k reads keeps the whole PE block under ~8 min
        # while steady walls stay 6-30x the ~4 s startup
        for side in (1, 2):
            replicate(f"{TESTDATA}/r{side}.fq.gz",
                      f"{workdir}/mhp{side}.fq.gz", 32)
            for n in (2, 4):
                replicate(f"{TESTDATA}/r{side}.fq.gz",
                          f"{workdir}/mhp{side}_part{n}.fq.gz", 32 // n)
        pipe_args = ["-q", "--kmer", "--kmer_length", "6", "-d", "-a",
                     "--detect_pe_adapter"]
        argv = ["-i", "mhp1.fq.gz", "-I", "mhp2.fq.gz",
                "-o", "out.fq.gz", "-O", "out2.fq.gz"] + pipe_args
        n_reads = 800_000  # 400k pairs

        def control_args(nprocs, r):
            return ["-i", f"mhp1_part{nprocs}.fq.gz",
                    "-I", f"mhp2_part{nprocs}.fq.gz",
                    "-o", f"ctl{nprocs}_{r}.fq.gz",
                    "-O", f"ctl{nprocs}_{r}_2.fq.gz"] + pipe_args
        compare_outs = ["out.fq.gz", "out2.fq.gz"]
        # PE ownership quantum is the device chunk; halve it so 400k pairs
        # split into ~49 units instead of ~24 (the ceil-at-region-boundary
        # skew is ~1 unit per rank).  Applied to every run in the comparison.
        config_env = {"FQTOOL_TPU_PE_CHUNK": "8192"}
    else:
        replicate(f"{TESTDATA}/r1.fq.gz", f"{workdir}/mh.fq.gz", 128)
        for n in (2, 4):
            replicate(f"{TESTDATA}/r1.fq.gz", f"{workdir}/mh_part{n}.fq.gz",
                      128 // n)
        pipe_args = ["-q", "-f", "3", "-t", "2"]
        argv = ["-i", "mh.fq.gz", "-o", "out.fq.gz"] + pipe_args
        n_reads = 1_600_000

        def control_args(nprocs, r):
            return ["-i", f"mh_part{nprocs}.fq.gz",
                    "-o", f"ctl{nprocs}_{r}.fq.gz"] + pipe_args
        compare_outs = ["out.fq.gz"]
        config_env = {}

    def free_port():
        with socket.socket() as s:
            s.bind(("", 0))
            return s.getsockname()[1]

    def spawn(rank: int, nprocs: int, args: List[str], tag: str,
              extra_env: dict):
        env = os.environ.copy()
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
            "FQTOOL_TPU_NO_JAX_DIST": "1",
            "FQTOOL_TPU_TRACE": "0",
            "FQTOOL_TPU_TIMING_JSON": f"timing_{tag}_{rank}.json",
            # finer ownership quantum for the scaling measurement: region
            # boundaries ceil to whole units (a rank cannot read backward
            # into a peer's byte region), so quantization skew is ~1 unit
            # per rank -- 8192 halves it vs the 16384 default.  Applied to
            # every run in the comparison (1-proc, N-proc, controls), so
            # outputs stay byte-identical across world sizes.
            "FQTOOL_TPU_WRITE_UNIT": "8192",
            "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
        })
        env.update(config_env)
        env.update(extra_env)
        pin = (["taskset", "-c", str(rank % (os.cpu_count() or 1))]
               if shutil.which("taskset") else [])
        cmd = pin + [sys.executable, "-m", "fqtool_tpu.main"] + args
        return subprocess.Popen(cmd, cwd=workdir, env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)

    def walls(procs, tag: str, nprocs: int):
        """(full_wall, steady_wall): full = spawn to last exit (includes the
        ~3-4s/process python+jax startup, constant in input size and world);
        steady = first run() entry to last completion across ranks (the
        streaming work: pre-passes, main pass, reduction, rank-0 merge) --
        the quantity BASELINE.md's reads/s north star describes."""
        import json
        t0 = time.perf_counter()
        rcs = [p.wait(timeout=900) for p in procs]
        full = time.perf_counter() - t0
        if any(rcs):
            raise RuntimeError(f"scaling run {tag} rcs={rcs}")
        stamps = []
        for rank in range(nprocs):
            with open(os.path.join(workdir,
                                   f"timing_{tag}_{rank}.json")) as f:
                stamps.append(json.load(f))
        steady = (max(s["t_done"] for s in stamps)
                  - min(s["t_run_begin"] for s in stamps))
        return full, steady

    def run_group(nprocs: int):
        """One multihost group of nprocs ranks over the full input."""
        port = free_port()
        mh_env = {} if nprocs == 1 else {
            "FQTOOL_TPU_COORDINATOR": f"127.0.0.1:{port}",
            "FQTOOL_TPU_NPROCS": str(nprocs)}
        args = [a.replace("out", f"out_mh{nprocs}") if a.startswith("out")
                else a for a in argv] if nprocs > 1 else argv
        procs = [spawn(r, nprocs, args, f"{config}_mh{nprocs}",
                       mh_env | ({"FQTOOL_TPU_PROC_ID": str(r)}
                                 if nprocs > 1 else {}))
                 for r in range(nprocs)]
        return walls(procs, f"{config}_mh{nprocs}", nprocs)

    def run_control(nprocs: int):
        """The parallel control: nprocs concurrent INDEPENDENT 1-proc runs,
        each over a disjoint 1/nprocs of the input, same core pinning."""
        procs = [spawn(r, nprocs, control_args(nprocs, r),
                       f"{config}_ctl{nprocs}", {})
                 for r in range(nprocs)]
        return walls(procs, f"{config}_ctl{nprocs}", nprocs)

    res = {}
    base = None
    warmed = False
    for nprocs in (1, 2, 4):
        if not warmed:
            warmed = True
            run_group(nprocs)      # warm-up: persistent-cache compiles
        if nprocs > 1:
            # INTERLEAVE group and control reps: shared-infra transients
            # (observed: a ~2-min slowdown hitting only the back-to-back
            # group reps skewed one capture's efficiency_4 from ~1.0 to
            # 0.71) then bias both sides equally under the min
            walls_g = [run_group(nprocs)]
            walls_c = [run_control(nprocs)]
            walls_g.append(run_group(nprocs))
            walls_c.append(run_control(nprocs))
            full, steady = min(walls_g)
            _, ctl = min(walls_c)
            res[f"ideal_{nprocs}"] = round(n_reads / ctl, 1)
        else:
            full, steady = min(run_group(nprocs) for _ in range(2))
        res[str(nprocs)] = round(n_reads / steady, 1)
        res[f"full_{nprocs}"] = round(n_reads / full, 1)
        outs = [os.path.join(workdir,
                             o if nprocs == 1 else o.replace("out", f"out_mh{nprocs}"))
                for o in compare_outs]
        blobs = [open(o, "rb").read() for o in outs]
        if base is None:
            base = blobs
        else:
            assert blobs == base, \
                f"multihost {nprocs}-proc output differs from single-process"
    for n in (2, 4):
        res[f"efficiency_{n}"] = round(res[str(n)] / res[f"ideal_{n}"], 3)
        res[f"efficiency_{n}_vs_serial"] = round(
            res[str(n)] / (n * res["1"]), 3)
        res[f"efficiency_{n}_full"] = round(
            res[f"full_{n}"] / (n * res["full_1"]), 3)
    return res


def main() -> None:
    workdir = tempfile.mkdtemp(prefix="fqtool_bench_")
    # inputs: 400k SE reads, 100k PE pairs, 400k distinct-content polyG reads
    replicate(f"{TESTDATA}/r1.fq.gz", f"{workdir}/se.fq.gz", 32)
    replicate(f"{TESTDATA}/r1.fq.gz", f"{workdir}/pe1.fq.gz", 8)
    replicate(f"{TESTDATA}/r2.fq.gz", f"{workdir}/pe2.fq.gz", 8)
    n_polyg = gen_polyg_input(f"{workdir}/polyg.fq", reps=32)

    # cold-start walls FIRST: the subprocesses need the device before this
    # process claims it (one process per card)
    cold = {}
    if not QUICK and os.environ.get("FQTOOL_TPU_BENCH_COLD", "1") == "1":
        try:
            cold = cold_start(workdir)
            sys.stderr.write(f"[bench] cold start: {cold}\n")
        except Exception as e:
            sys.stderr.write(f"[bench] cold start failed: {e}\n")

    from fqtool_tpu.host import tracing
    from fqtool_tpu.main import main as fq_main

    link_mbps = link_probe_mbps()
    oracle_bin = ensure_oracle()
    if not oracle_bin:
        sys.stderr.write("[bench] reference oracle unavailable; "
                         "vs_fair omitted\n")
    results = {}
    stages = {}
    device_only = {}
    splits = {}
    golden = {}
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        only = {s for s in os.environ.get(
            "FQTOOL_TPU_BENCH_ONLY", "").split(",") if s}
        for name, baseline, reps, paired, n_records, argv in CONFIGS:
            if only and name not in only:
                continue
            if QUICK:
                reps = 1
            if paired:
                small = ["-i", f"{TESTDATA}/r1.fq.gz", "-I", f"{TESTDATA}/r2.fq.gz",
                         "-o", "w1.fq.gz", "-O", "w2.fq.gz"]
                big = ["-i", "pe1.fq.gz", "-I", "pe2.fq.gz",
                       "-o", "o1.fq.gz", "-O", "o2.fq.gz"]
            elif name == "se_polygx":
                small = ["-i", f"{TESTDATA}/polygr1.fq", "-o", "w.fq.gz"]
                big = ["-i", "polyg.fq", "-o", "o.fq.gz"]
                n_records = n_polyg
            else:
                small = ["-i", f"{TESTDATA}/r1.fq.gz", "-o", "w.fq.gz"]
                big = ["-i", "se.fq.gz", "-o", "o.fq.gz"]
            argv_w = [(a.replace("merged", "wmerged") if "merged" in a else a)
                      for a in argv]
            # one config failing must not take down the whole bench: every other config's numbers
            # and the final JSON line still have to reach the driver
            try:
                fq_main(small + argv_w)  # warm-up: compile cache
                tracing.reset()  # stage dump: steady state, not compiles
                best = float("inf")
                for _ in range(reps):
                    snap = dict(tracing._totals)
                    t0 = time.perf_counter()
                    fq_main(big + argv)
                    dt = time.perf_counter() - t0
                    if dt < best:
                        best = dt
                        stages[name] = {
                            k: round(tracing._totals[k] - snap.get(k, 0.0), 3)
                            for k in tracing._totals}
            except Exception as e:
                sys.stderr.write(f"[bench] {name}: e2e run failed: {e!r}\n")
                continue
            reads = n_records * (2 if paired else 1)
            results[name] = {
                "reads_per_sec": round(reads / best, 1),
                "wall_s": round(best, 3),
                "vs_baseline": round(reads / best / baseline, 3),
            }
            if oracle_bin:
                try:
                    fair = oracle_fair_rate(oracle_bin, workdir, paired, name,
                                            n_records, argv,
                                            1 if QUICK else 2)
                    results[name]["fair_baseline"] = fair
                    results[name]["vs_fair"] = round(
                        results[name]["reads_per_sec"] / fair, 3)
                except Exception as e:
                    sys.stderr.write(f"[bench] {name}: oracle fair baseline "
                                     f"failed: {e}\n")
            sys.stderr.write(f"[bench] {name}: {results[name]['reads_per_sec']:.0f}"
                             f" reads/s (x{results[name]['vs_baseline']:.2f}"
                             + (f", x{results[name]['vs_fair']:.2f} vs fair"
                                if "vs_fair" in results[name] else "") + ")\n")
            try:
                device_only[name] = device_only_rate(name, paired, argv, workdir)
                sys.stderr.write(f"[bench] {name}: device-only "
                                 f"{device_only[name]:.0f} reads/s\n")
            except Exception as e:  # the e2e numbers still stand alone
                sys.stderr.write(f"[bench] {name}: device-only failed: {e}\n")
            try:
                splits[name] = transfer_split(name, paired, argv, workdir)
                sys.stderr.write(f"[bench] {name}: transfer split "
                                 f"{splits[name]}\n")
            except Exception as e:
                sys.stderr.write(f"[bench] {name}: transfer split failed: {e}\n")
            if oracle_bin:
                try:
                    golden[name] = golden_on_device(oracle_bin, workdir,
                                                    paired, name, argv)
                    sys.stderr.write(f"[bench] {name}: golden on "
                                     f"{_backend()}: {golden[name]}\n")
                except Exception as e:
                    golden[name] = False
                    sys.stderr.write(f"[bench] {name}: golden diff failed: "
                                     f"{e!r}\n")
        if not QUICK:
            try:
                splits["b5_fallback"] = b5_fallback_probe(workdir)
                sys.stderr.write(f"[bench] b5 fallback probe: "
                                 f"{splits['b5_fallback']}\n")
            except Exception as e:
                sys.stderr.write(f"[bench] b5 fallback probe failed: {e!r}\n")

        # cold-start break-even: the read count where the steady-state rate
        # advantage over the fair oracle amortizes our process startup
        for cname, c in cold.items():
            r = results.get(cname)
            if not (r and c.get("cold_wall_s") and "fair_baseline" in r):
                continue
            reads = (12_500 if cname.startswith("se") else 25_000)
            ours, fair = r["reads_per_sec"], r["fair_baseline"]
            c["startup_s"] = round(max(c["cold_wall_s"] - reads / ours, 0.0), 3)
            if ours > fair:
                c["break_even_reads"] = int(
                    c["startup_s"] / (1.0 / fair - 1.0 / ours))
            sys.stderr.write(f"[bench] {cname}: cold wall {c['cold_wall_s']}s"
                             f" startup {c['startup_s']}s break-even "
                             f"{c.get('break_even_reads', 'n/a')} reads\n")

        scaling = {}
        if not QUICK and os.environ.get("FQTOOL_TPU_BENCH_MH", "1") == "1":
            # SE keeps the legacy flat keys; the PE pipeline (north star
            # names both) nests under "pe_full"
            try:
                scaling = multihost_scaling(workdir, "se_qualtrim")
                sys.stderr.write(f"[bench] multihost scaling (SE): {scaling}\n")
            except Exception as e:
                sys.stderr.write(f"[bench] multihost scaling failed: {e}\n")
            try:
                scaling["pe_full"] = multihost_scaling(workdir, "pe_full")
                sys.stderr.write("[bench] multihost scaling (PE): "
                                 f"{scaling['pe_full']}\n")
            except Exception as e:
                sys.stderr.write(f"[bench] PE multihost scaling failed: {e}\n")
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)

    details = {
        "configs": results,
        "stages": stages,
        "device_only_reads_per_sec": device_only,
        "transfer_split": splits,
        "link_mbps": link_mbps,
        "multihost_scaling": scaling,
        "golden_on_device": golden,
        "golden_backend": _backend(),
        "cold_start": cold,
    }
    try:
        with open(os.path.join(REPO, "bench_details.json"), "w") as f:
            json.dump(details, f, indent=2)
    except OSError:
        pass

    # stage dump NOW (stderr), so nothing can print after the metric line
    atexit.unregister(tracing.dump)
    tracing.dump()
    sys.stderr.flush()

    # headline: se_qualtrim, falling back to any config that completed so a
    # single-config failure still yields a parseable metric line
    head = results.get("se_qualtrim") or \
        (next(iter(results.values())) if results else
         {"reads_per_sec": None, "vs_baseline": None})
    print(json.dumps({
        "metric": "se_reads_per_sec",
        "value": head["reads_per_sec"],
        "unit": "reads/s",
        "vs_baseline": head["vs_baseline"],
        "vs_fair": head.get("vs_fair"),
        "configs": {k: v["reads_per_sec"] for k, v in results.items()},
        "fair_baseline": {k: v["fair_baseline"] for k, v in results.items()
                          if "fair_baseline" in v},
        "vs_fair_configs": {k: v["vs_fair"] for k, v in results.items()
                            if "vs_fair" in v},
        "device_only": device_only,
        "transfer_split": splits,
        "link_mbps": link_mbps,
        "multihost_scaling": scaling,
        "golden_on_device": golden,
        "golden_backend": _backend(),
        "cold_start": cold,
    }))
    sys.stdout.flush()


if __name__ == "__main__":
    sys.exit(main())
