"""chip_smoke.py: its device guard, its kernel checks at a small size on the
CPU, the same checks at full chunk rows on a card, and the compile-cache
rule of the CLI's start-up."""

from __future__ import annotations

import os

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_to_run_without_a_gpu():
    import jax

    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU: JAX reports cpu"):
        chip_smoke.require_gpu(jax.devices())


def test_kernel_checks_pass_on_cpu():
    lines = chip_smoke.check_kernels(seed=3, se_rows=512, pe_rows=256,
                                     sample=64)
    assert len(lines) == 3 and "64 sampled pairs" in lines[0]


@pytest.mark.gpu
def test_kernel_checks_pass_on_gpu_at_chunk_rows(gpu):
    chip_smoke.check_kernels(seed=3, se_rows=chip_smoke.SE_ROWS,
                             pe_rows=chip_smoke.PE_ROWS,
                             sample=chip_smoke.OVERLAP_SAMPLE)


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_dir_rule(env_dir, monkeypatch, tmp_path):
    import jax

    from fqtool_tpu import main

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert main.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
