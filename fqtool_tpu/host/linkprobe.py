"""Transport auto-tuning.

The packed one-byte transport (ops/packed.py) halves host->device upload
bytes at the cost of one host encode pass (~GB/s).  Whether that trades well
depends on the host->device link: over a local PCIe link the encode pass
is pure loss, while a link of tens of MB/s makes the upload dominate the
whole pipeline (the reference has no analog -- its reader hands strings to
pthread workers in the same address space, src/fqreader.cpp:160-195).

``use_packed()`` decides once per process: ``FQTOOL_TPU_PACKED=1/0``
forces the choice, otherwise a one-shot 4 MiB probe isolates the H2D
upload bandwidth (packing only reduces upload bytes) and enables packing
below ``PACKED_THRESHOLD_MBPS``: the encode saves one of every two
uploaded bytes, so packing wins only when the upload runs slower than
the host encode pass.  The probe is pure transfer -- no jit
compilation.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

PACKED_THRESHOLD_MBPS = 200.0
_PROBE_BYTES = 4 << 20

_cached: bool | None = None


def _probe_mbps() -> float:
    """Estimated host->device upload bandwidth in MB/s.

    Packing only reduces upload bytes, so the gate must measure H2D alone:
    the first materialization of a device_put pays upload+download, a second
    fetch of the same (now device-resident) buffer pays download only, and
    the difference isolates the upload.  No jit compilation involved.
    """
    import jax

    buf = np.zeros((_PROBE_BYTES,), np.uint8)
    # warm the transfer path (lazy backend init, pinned buffers)
    np.asarray(jax.device_put(buf))
    t0 = time.perf_counter()
    dev = jax.device_put(buf)
    np.asarray(dev)              # upload + download
    t1 = time.perf_counter()
    np.asarray(dev)              # download only
    t2 = time.perf_counter()
    up = max((t1 - t0) - (t2 - t1), 1e-9)
    return (_PROBE_BYTES / (1 << 20)) / up


def use_packed() -> bool:
    """True when seq+qual chunks should ride the packed one-byte transport."""
    global _cached
    env = os.environ.get("FQTOOL_TPU_PACKED", "")
    if env == "1":
        return True
    if env == "0":
        return False
    if _cached is None:
        try:
            mbps = _probe_mbps()
        except Exception:
            _cached = False
            return False
        _cached = mbps < PACKED_THRESHOLD_MBPS
        if _cached:
            sys.stderr.write(
                f"[fqtool_tpu] link probe {mbps:.0f} MB/s upload -> "
                "packed transport enabled\n")
    return _cached
