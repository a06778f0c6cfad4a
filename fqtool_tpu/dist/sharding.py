"""Multi-chip data-parallel execution.

The reference's only parallelism axis is the read axis (1 reader thread + N
worker pthreads over read packs, SURVEY.md section 2.3); the device
equivalent is data parallelism over a 1-D device mesh: packs are
sharded along the batch dimension, per-read kernels run fully parallel, and
the statistics reductions (per-cycle histograms, k-mer counts, filter fates)
become XLA all-reduces between the devices, inserted automatically by ``jit`` under the
sharding constraints.

Per-read outputs (spans, result codes) stay sharded along the read axis so
each host can materialize its deterministic record range; with a
deterministic shard -> record-range assignment the merged output equals the
single-host ordering.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config.options import KernelParams
from ..pipeline.pe import pe_pipeline
from ..pipeline.se import se_pipeline

READ_AXIS = "reads"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the read (data-parallel) axis."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (READ_AXIS,))


def shard_batch(mesh: Mesh, *arrays):
    """Place host arrays sharded along axis 0 of the mesh."""
    sharding = NamedSharding(mesh, P(READ_AXIS))
    return tuple(jax.device_put(np.asarray(a), sharding) for a in arrays)


def pad_to_multiple(a: np.ndarray, m: int) -> np.ndarray:
    b = a.shape[0]
    target = -(-b // m) * m
    if target == b:
        return a
    pad = [(0, target - b)] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def run_se_sharded(mesh: Mesh, seq, qual, lens, start0, keep, p: KernelParams,
                   **kw):
    """Run the SE pipeline with inputs sharded over the mesh.

    ``jit`` propagates the read-axis sharding through every per-read kernel
    and inserts cross-device reductions for the stat sums.
    """
    n = mesh.devices.size
    b0 = np.asarray(seq).shape[0]
    seq = pad_to_multiple(np.asarray(seq), n)
    qual = pad_to_multiple(np.asarray(qual), n)
    lens = pad_to_multiple(np.asarray(lens), n)
    start0 = pad_to_multiple(np.asarray(start0), n)
    keep_p = np.zeros(seq.shape[0], bool)
    keep_p[: len(keep)] = keep
    real = np.zeros(seq.shape[0], bool)
    real[:b0] = True
    seq, qual, lens, start0, keep_p, real = shard_batch(
        mesh, seq, qual, lens, start0, keep_p, real)
    return se_pipeline(seq, qual, lens, start0, keep_p, real, p, **kw)


def run_pe_sharded(mesh: Mesh, seq1, qual1, lens1, seq2, qual2, lens2,
                   start1, start2, keep, real, p: KernelParams, p2: KernelParams,
                   **kw):
    n = mesh.devices.size
    arrays = [np.asarray(a) for a in
              (seq1, qual1, lens1, seq2, qual2, lens2, start1, start2)]
    b0 = arrays[0].shape[0]
    arrays = [pad_to_multiple(a, n) for a in arrays]
    keep_p = np.zeros(arrays[0].shape[0], bool)
    keep_p[:b0] = keep
    real_p = np.zeros(arrays[0].shape[0], bool)
    real_p[:b0] = real
    placed = shard_batch(mesh, *arrays, keep_p, real_p)
    return pe_pipeline(*placed, p, p2, **kw)
