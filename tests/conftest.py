"""Test configuration.

The suite runs on the CPU backend with 8 virtual devices, so multi-device
sharding logic is exercised without accelerators. CPU stays JAX's default
backend even where a GPU is present; tests marked `gpu` reach the card
through the `gpu` fixture and skip without one:

    JAX_PLATFORMS=cpu,cuda python -m pytest -m gpu tests/
"""

import os
import pathlib

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# CPU first (the default backend); any other listed platform stays
# reachable by name for the gpu-marked tests
_platforms = [p for p in os.environ.get("JAX_PLATFORMS", "").split(",")
              if p and p != "cpu"]
os.environ["JAX_PLATFORMS"] = ",".join(["cpu"] + _platforms)
# several test workers may share one card
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")

import pytest  # noqa: E402

REFERENCE = pathlib.Path("/root/reference")
FIXTURES = REFERENCE / "tests" / "files"


@pytest.fixture(scope="session")
def fixtures():
    if not FIXTURES.is_dir():
        pytest.skip("reference fixture corpus not available")
    return FIXTURES


def requires_fixtures(func):
    return pytest.mark.skipif(
        not FIXTURES.is_dir(), reason="reference fixture corpus not available"
    )(func)


@pytest.fixture
def gpu():
    """The first GPU JAX can reach; skips the test when there is none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")
