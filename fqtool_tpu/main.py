"""Program entry point.

Mirrors the reference startup sequence (reference: src/main.cpp:7-147):
CLI parse -> options update/validate -> evaluation pre-passes (read length,
read number, split sizing, ORS, PE adapter detection) -> SE/PE processing.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

from .config.cli import parse_args
from .config.options import Options
from .host import evaluator
from .pipeline.runner import SingleEndRunner, loginfo

# the checkout this package runs from: the compile cache lives inside it
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    ``JAX_COMPILATION_CACHE_DIR`` when set, else at the fixed
    ``<checkout>/.jax_cache``, and return the directory.  Goes through
    ``jax.config`` so it holds even when ``jax`` was imported first."""
    import jax

    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    if "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS" not in os.environ:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def _spool_stdin(opt: Options) -> Optional[str]:
    """Spool /dev/stdin to a temp file so the pre-passes and the main pass
    can each open the input independently.

    The reference shares the single ``stdin`` FILE* between the evaluator
    pre-passes and the processor (fqreader.cpp:51-53); the pre-pass consumes
    and closes the stream, and the main pass segfaults — stdin input is
    effectively broken there.  Spooling once makes every feature (split
    sizing, ORA, adapter detection, getBytes totals) work from a pipe.
    Gzip is sniffed from the magic bytes rather than the filename.

    Only the literal path "/dev/stdin" is recognized (matching the
    reference's literal check, main.cpp / fqreader.cpp); aliases like
    /dev/fd/0 bypass the spool and will be drained by the pre-passes.
    """
    if opt.in1 != "/dev/stdin" and opt.in2 != "/dev/stdin":
        return None
    from .config.options import OptionError
    from .dist import multihost
    if multihost.active() is not None:
        # each rank has its own stdin; striping one stream across hosts
        # needs a shared file path
        raise OptionError("stdin input is not supported in multi-host runs")
    if opt.in1 == "/dev/stdin" and opt.in2 == "/dev/stdin":
        # one stream cannot carry two reads of a pair
        raise OptionError("-i and -I cannot both read from /dev/stdin")
    import shutil
    import tempfile

    src = sys.stdin.buffer
    head = src.read(2)
    suffix = ".fq.gz" if head == b"\x1f\x8b" else ".fq"
    tmp = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    try:
        tmp.write(head)
        shutil.copyfileobj(src, tmp, 1 << 20)
        tmp.close()
    except BaseException:
        # ENOSPC / broken pipe mid-spool: don't leak the partial temp file
        tmp.close()
        os.unlink(tmp.name)
        raise
    if opt.in1 == "/dev/stdin":
        opt.in1 = tmp.name
    if opt.in2 == "/dev/stdin":
        opt.in2 = tmp.name
    return tmp.name


def run(opt: Options) -> None:
    # -w sizes the shared host pool (deflate/format/encode); must precede
    # any pool use (reference worker threads: seprocessor.cpp:160-180)
    from .io.fastq import set_worker_threads
    set_worker_threads(opt.thread)

    # multi-host process group, if configured: jax.distributed.initialize
    # must run before any backend use, so this precedes the pre-passes
    from .dist import multihost
    multihost.active()
    _log_devices()

    # steady-state timing probe (bench.py multihost scaling): wall-clock
    # stamps around the streaming work -- run start (pre-passes + main pass
    # + merge all inside) vs. interpreter/jax startup, which is constant in
    # the input and in the world size
    timing_path = os.environ.get("FQTOOL_TPU_TIMING_JSON")
    t_run_begin = time.time()

    spooled = _spool_stdin(opt)
    try:
        if spooled is not None:
            try:
                _run(opt)
            finally:
                os.unlink(spooled)
        else:
            _run(opt)
    finally:
        if timing_path:
            import json

            from .host import tracing
            with open(timing_path, "w") as f:
                json.dump({"t_run_begin": t_run_begin,
                           "t_done": time.time(),
                           "marks": tracing.marks()}, f)


def _log_devices() -> None:
    import jax

    devices = jax.devices()
    loginfo(f"backend {jax.default_backend()}: {len(devices)} x "
            f"{devices[0].device_kind}")


def _activate_headcache(opt: Options) -> None:
    """Open one pack reader per input and cache the head packs the
    evaluation pre-passes consume, framed exactly as the main pass will
    read them -- the main runner then drains the cache and continues the
    same reader, so every input byte is inflated and tokenized once
    (io/headcache.py; beats the reference's 4-5 head re-scans,
    src/main.cpp:128-143).

    Skipped for multi-host runs (inputs go through the region planner,
    dist/ingest.py) and interleaved PE (record-framed, not pack-framed).
    """
    if os.environ.get("FQTOOL_TPU_HEADCACHE", "1") != "1":
        return
    from .dist import multihost
    if multihost.active() is not None:
        return
    if opt.interleaved_input:
        return
    # only worth it when a pre-pass actually consumes a substantial head
    # (ORS prefix / PE adapter detection / split-sizing record count);
    # read_len alone touches 1000 records, cheaper than filling the cache
    if not (opt.over_rep.enabled or opt.adapter.enable_detect_for_pe
            or opt.split.by_file_number):
        return
    from .io import headcache
    if opt.is_paired():
        from .pipeline.pe_runner import main_pack_reads
    else:
        from .pipeline.runner import main_pack_reads
    pack_reads = main_pack_reads(opt)
    headcache.activate(opt.in1, pack_reads, opt.phred64)
    if opt.in2:
        headcache.activate(opt.in2, pack_reads, opt.phred64)


def _run(opt: Options) -> None:
    from .io import headcache
    try:
        _activate_headcache(opt)
        _run_inner(opt)
    finally:
        # drop any cache a pipeline did not drain (framing mismatch, error
        # unwind): a stale entry would alias a reused path in a later
        # in-process run
        headcache.discard_all()


def _prepass(opt: Options, skip_r2_detect: bool = False) -> None:
    """Evaluation pre-passes (main.cpp:128-143).  The read-number estimate
    scans up to 512Ki records but is consumed only by -s split sizing
    (main.cpp:132-135), so it runs only when needed.  ``skip_r2_detect``:
    a multi-host peer is running the R2 adapter scan concurrently
    (_prepass_multihost)."""
    evaluator.evaluate_read_len(opt)
    if opt.split.by_file_number:
        evaluator.evaluate_read_num(opt)
        opt.split.size = max(opt.est.reads_num // max(opt.split.number, 1), 1)
        loginfo(f"total reds: {opt.est.reads_num} split size: {opt.split.size}")
    if opt.over_rep.enabled:
        evaluator.evaluate_over_rep_seqs(opt)
    if opt.adapter.enable_detect_for_pe:
        if skip_r2_detect:
            evaluator.evaluate_adapter_seq(opt, False)
            return
        # independent full-prefix scans of R1 and R2 (the reference runs
        # them back to back, main.cpp:141-142); each writes only its own
        # opt.adapter field and the scan path is matrix/native code that
        # releases the GIL, so two threads overlap cleanly
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=2) as ex:
            f1 = ex.submit(evaluator.evaluate_adapter_seq, opt, False)
            f2 = ex.submit(evaluator.evaluate_adapter_seq, opt, True)
            f1.result()
            f2.result()


# every option field the pre-passes write -- the broadcast payload of the
# rank-0-only multihost prepass (anything missing here would silently
# diverge between ranks, so keep in sync with _prepass)
_PREPASS_FIELDS = (
    ("est", "seq_len1"), ("est", "seq_len2"), ("est", "reads_num"),
    ("est", "illumina_adapter"), ("split", "size"),
    ("over_rep", "over_rep_seq_count_r1"), ("over_rep", "over_rep_seq_count_r2"),
    ("adapter", "detected_adapter_seq_r1"), ("adapter", "detected_adapter_seq_r2"),
)


def _prepass_multihost(opt: Options, mh) -> None:
    """The pre-passes scan a bounded input head; running them on every rank
    would duplicate that scan O(world) times (and contend for the same
    storage/CPU).  The reference runs them exactly once before its worker
    threads start (main.cpp:128-143) -- the multi-host equivalent is the
    pre-pass work runs once ACROSS the group and the handful of derived
    values (two read lengths, a record-count estimate, two ORS count
    dicts, two adapter strings) is broadcast.

    The one splittable piece -- PE adapter detection is two independent
    full-prefix scans of R1 and R2 -- runs on ranks 0 and 1 concurrently
    (real separate hosts halve the serial prepass wall that gates every
    rank's stream start); rank 0 merges rank 1's two fields in the gather
    before broadcasting."""
    from .host import tracing
    split_detect = opt.adapter.enable_detect_for_pe and mh.world >= 2
    if mh.rank == 0:
        _prepass(opt, skip_r2_detect=split_detect)
        part = None
    elif mh.rank == 1 and split_detect:
        evaluator.evaluate_adapter_seq(opt, True)
        part = {"adapter.detected_adapter_seq_r2":
                opt.adapter.detected_adapter_seq_r2,
                "est.illumina_adapter": opt.est.illumina_adapter}
    else:
        part = None
    gathered = mh.gather(part)
    if mh.rank == 0:
        if split_detect and gathered[1]:
            opt.adapter.detected_adapter_seq_r2 = \
                gathered[1]["adapter.detected_adapter_seq_r2"]
            opt.est.illumina_adapter = (opt.est.illumina_adapter
                                        or gathered[1]["est.illumina_adapter"])
        mh.broadcast({f"{s}.{f}": getattr(getattr(opt, s), f)
                      for s, f in _PREPASS_FIELDS})
    else:
        for key, val in mh.broadcast().items():
            s, f = key.split(".")
            setattr(getattr(opt, s), f, val)
    tracing.mark("prepass_broadcast_done")


def _run_inner(opt: Options) -> None:
    from .dist import multihost
    from .host.tracing import stage
    mh = multihost.active()
    with stage("prepass"):
        if mh is not None:
            _prepass_multihost(opt, mh)
        else:
            _prepass(opt)

    # SE/PE dispatch (processor.cpp:10-19)
    if opt.is_paired():
        from .pipeline.pe_runner import PairEndRunner
        PairEndRunner(opt).run()
    else:
        SingleEndRunner(opt).run()


def main(argv: Optional[List[str]] = None) -> int:
    from .config.options import OptionError
    from .io.fastq import FastqIOError
    enable_compile_cache()
    try:
        opt = parse_args(argv)
        run(opt)
    except (OptionError, FastqIOError) as e:
        # reference: util::errorExit prints and exits -1 (util.h:303-306)
        sys.stderr.write(f"error: {e}\n")
        return 255
    except ConnectionError as e:
        # a multihost peer died (e.g. clean FastqIOError exit on its rank):
        # fail this rank cleanly instead of dumping a socket traceback
        sys.stderr.write(f"error: multihost peer failure: {e}\n")
        return 255
    return 0


if __name__ == "__main__":
    sys.exit(main())
