"""Test configuration: JAX on the CPU backend with a virtual 8-device mesh,
so the multi-device sharding paths are testable without accelerators.
``JAX_PLATFORMS=cuda pytest -m gpu`` runs the tests that need a card."""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session", autouse=True)
def _compile_cache():
    from fqtool_tpu.main import enable_compile_cache
    enable_compile_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided here, at run
    time, so every xdist worker collects the same tests)."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda pytest -m gpu")


@pytest.fixture(scope="session")
def oracle():
    from .oracle import Oracle
    return Oracle.build()


# ---------------------------------------------------------------------------
# quick tier: `pytest -m quick` is the <3-minute smoke path (fast unit /
# kernel / writer tests plus two end-to-end goldens); the full oracle-golden
# and mesh e2e modules are marked slow.
# ---------------------------------------------------------------------------

_SLOW_MODULES = {
    "test_golden_se", "test_golden_pe", "test_golden_matrix",
    "test_golden_fuzz", "test_golden_random", "test_golden_kitchen_sink",
    "test_golden_features", "test_golden_edge", "test_golden_malformed",
    "test_sharded_e2e", "test_multihost", "test_html_dom", "test_reports",
    "test_cli_rejection", "test_dist", "test_headcache",
}

# end-to-end smoke goldens promoted into the quick tier (one SE, one PE)
_QUICK_SMOKE = {
    "test_se_quality_filter_trims",   # tests/test_golden_se.py
    "test_pe_quality_filter",         # tests/test_golden_pe.py
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        name = item.name.split("[")[0]
        if mod in _SLOW_MODULES and name not in _QUICK_SMOKE:
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.quick)
