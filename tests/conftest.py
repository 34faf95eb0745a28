"""Test configuration: force the CPU backend with 8 virtual devices.

The suite runs on the local CPU backend with a virtual 8-device mesh for
the sharding tests (the standard way to exercise shard_map without a
multi-device host).  Backends initialize lazily, so overriding here —
before any jax.devices() call — is safe.  Checks that need a GPU live in
``chip_smoke.py`` and run on the card.
"""
import os

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    + os.environ.get("XLA_FLAGS", "")
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


# Representative wavelets covering every family and both parities of the
# half-filter length (which select different inverse phase paths):
#   haar (hlen=2), db2 (4), db3 (6), sym8 (16), coif2 (12), db20 (40),
#   bior3.1 (4), bior4.4 (10), bior6.8 (18), rbio2.6 (14).
REPRESENTATIVE = [
    "haar", "db2", "db3", "sym8", "coif2", "db20",
    "bior3.1", "bior4.4", "bior6.8", "rbio2.6",
]


@pytest.fixture(params=REPRESENTATIVE)
def wname(request):
    return request.param
