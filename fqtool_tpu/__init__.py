"""fqtool_tpu: a FASTQ preprocessing engine on JAX accelerators.

A from-scratch JAX/XLA rebuild with full feature parity to fqtool (a fastp
fork): per-read trimming/filtering pipelines run as vectorized device kernels
over fixed-shape read packs; host-side streaming I/O, evaluation pre-passes,
and reporting mirror the reference behavior record-for-record.
"""

__version__ = "0.1.0"
