"""The fused kernels compiled for the card (no interpret mode) against the
XLA engines at a small shape. Marked ``gpu``: they skip on the CPU, and
chip_smoke.py runs the same comparison at full BXD width.

Run on a GPU host: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernels.py
"""

import jax.numpy as jnp
import numpy as np
import pytest

import bulklmm_tpu as bl
from bulklmm_tpu.models.bulkscan import _alt_grid_impl
from bulklmm_tpu.pallas.altgrid_fused import fused_alt_grid
from bulklmm_tpu.utils.config import BALANCED

pytestmark = pytest.mark.gpu


def _data(n=53, p=300, m=70, seed=5):
    rng = np.random.default_rng(seed)
    G = rng.uniform(0, 1, (n, p))
    K = np.asarray(bl.calc_kinship(G))
    Y = rng.normal(size=(n, m))
    return G, K, Y


def test_compiled_alt_grid_kernel_matches_xla(gpu):
    rng = np.random.default_rng(3)
    n, p, m = 53, 300, 70
    args = (
        jnp.asarray(rng.normal(size=(n, m))),
        jnp.asarray(rng.normal(size=(n, p))),
        jnp.ones((n, 1)),
        jnp.asarray(np.sort(rng.uniform(0.05, 3.0, n))),
        jnp.arange(0.0, 0.91, 0.1),
    )
    L_ref, h2_ref = _alt_grid_impl(
        *args, prior=(1.0, 0.0), reml=False, method="qr", precision=BALANCED,
    )
    L, h2 = fused_alt_grid(*args, prior=(1.0, 0.0), precision=BALANCED)
    assert float(jnp.max(jnp.abs(L - L_ref))) < 5e-5
    assert float(jnp.mean((h2 != h2_ref).astype(jnp.float32))) < 1e-3


def test_compiled_perm_kernel_matches_xla(gpu):
    G, K, Y = _data()
    a = bl.bulkscan_perms(Y, G, K, nperms=50, engine="xla",
                          precision=BALANCED)
    b = bl.bulkscan_perms(Y, G, K, nperms=50, engine="pallas",
                          precision=BALANCED)
    assert np.max(np.abs(np.asarray(a.maxlods) - np.asarray(b.maxlods))) < 5e-5
