"""Test config: CPU backend with 8 virtual devices (for mesh/sharding tests)
and float64 enabled, so parity checks against the float64 reference formulas
are exact. Set env BEFORE jax initializes."""

import os

# The suite runs on the CPU unless JAX_PLATFORMS says otherwise: the
# card-only tests (marker "gpu") run with JAX_PLATFORMS=cuda on a GPU host.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a CUDA GPU (decided here, at
    run time, never at import: every xdist worker must collect the same
    tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs this on the card")


@pytest.fixture(scope="session")
def bxd_like():
    """Synthetic dataset with BXD-like structure (small, fast).

    n strains, p markers, m traits with genuine heritability so h2 estimation
    paths are exercised away from the boundary.
    """
    rng = np.random.default_rng(2026)
    n, p, m = 60, 120, 16
    # genotype probabilities with linkage-like column correlation
    base = rng.uniform(0, 1, (n, p // 4))
    G = np.clip(
        np.repeat(base, 4, axis=1) + 0.15 * rng.normal(size=(n, p)), 0.0, 1.0
    )
    X = G - 0.5
    K = 2.0 * X @ X.T / p + 0.5
    np.fill_diagonal(K, 1.0)
    Lc = np.linalg.cholesky(K + 1e-9 * np.eye(n))
    h2s = rng.uniform(0.2, 0.8, m)
    U = Lc @ rng.normal(size=(n, m))
    E = rng.normal(size=(n, m))
    Y = np.sqrt(h2s) * U + np.sqrt(1 - h2s) * E
    # a couple of real marker effects for non-trivial LOD peaks
    Y[:, 0] += 0.8 * (G[:, 17] - G[:, 17].mean())
    Y[:, 1] += 0.6 * (G[:, 63] - G[:, 63].mean())
    return dict(G=G, K=K, Y=Y, n=n, p=p, m=m)
