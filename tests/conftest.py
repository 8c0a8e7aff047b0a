"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices by default, so that mesh
sharding, halo exchange and collectives are exercised deterministically
without an accelerator (SURVEY.md §4). ``JAX_PLATFORMS`` is only a default:
``chip_smoke.py`` runs the ``gpu``-marked tests on the card. Environment
must be set before JAX is imported.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Persistent compilation cache: XLA-CPU compiles of big scatter/scan programs
# are slow; cache them across test sessions.
from astro_sph_tools_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

use_compile_cache()


@pytest.fixture()
def gpu():
    """The first GPU device; skips the test where JAX sees none. Tests that
    need the card take this fixture and carry the ``gpu`` marker."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card by chip_smoke.py)")
    return jax.devices()[0]


@pytest.fixture()
def rng(request) -> np.random.Generator:
    """Per-test deterministic generator: the seed derives from the test id
    (stable CRC32, not the randomized builtin hash) so streams never depend
    on execution order or which other tests ran."""
    import zlib

    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


def pytest_addoption(parser):
    parser.addoption(
        "--slow",
        action="store_true",
        default=False,
        help="also run the compile-heavy slow lane (full suite)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: compile-heavy (interpret-mode Pallas / shard_map); "
        "excluded from the default fast lane — run with --slow",
    )


def pytest_collection_modifyitems(config, items):
    """Fast lane by default: the full suite costs tens of minutes of XLA-CPU
    compiles; the default lane keeps every subsystem covered at smoke depth.
    `pytest --slow` runs everything."""
    if config.getoption("--slow"):
        return
    skip = pytest.mark.skip(reason="slow lane: pass --slow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
