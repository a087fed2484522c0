"""Fused alt-grid Pallas kernel (pallas/altgrid_fused.py, Triton route)
vs the XLA ``lax.scan`` formulation, in interpreter mode on CPU.

The compiled kernel is checked on the GPU by chip_smoke.py's alt-grid
phase (engine="auto" selects it there) against the XLA engine at EXACT64
and a CPU float64 golden.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bulklmm_tpu.models.bulkscan import _alt_grid_impl, bulkscan
from bulklmm_tpu.pallas.altgrid_fused import fused_alt_grid
from bulklmm_tpu.utils.config import BALANCED


@pytest.fixture(scope="module")
def rotated():
    rng = np.random.default_rng(3)
    n, p, m, c = 40, 96, 48, 2
    return dict(
        Y0=jnp.asarray(rng.normal(size=(n, m))),
        X0m=jnp.asarray(rng.normal(size=(n, p))),
        C0=jnp.asarray(np.column_stack([np.ones(n), rng.normal(size=n)])),
        lam=jnp.asarray(np.sort(rng.uniform(0.05, 3.0, n))),
    )


@pytest.mark.parametrize("reml", [False, True])
def test_fused_matches_xla_impl(rotated, reml):
    h2_grid = jnp.arange(0.0, 0.91, 0.1)
    prior = (1.0, 0.0)
    L_ref, h2_ref = _alt_grid_impl(
        rotated["Y0"], rotated["X0m"], rotated["C0"], rotated["lam"], h2_grid,
        prior=prior, reml=reml, method="qr", precision=BALANCED,
    )
    L_pl, h2_pl = fused_alt_grid(
        rotated["Y0"], rotated["X0m"], rotated["C0"], rotated["lam"], h2_grid,
        prior=prior, reml=reml, precision=BALANCED, interpret=True,
        tile_p=32, tile_m=16,
    )
    # f32 kernel vs f64 XLA combine: f32-level agreement
    assert float(jnp.max(jnp.abs(L_pl - L_ref))) < 5e-5
    assert float(jnp.mean((h2_pl != h2_ref).astype(jnp.float32))) == 0.0


def test_fused_throughput_tier(rotated):
    """THROUGHPUT (gemm Precision.HIGH) maps to the three-pass bf16 dot
    algorithm, HIGHEST to the six-pass one: screening-tier agreement with
    the exact kernel, finite everywhere."""
    from bulklmm_tpu.pallas.altgrid_fused import kernel_dot_precision
    from bulklmm_tpu.utils.config import THROUGHPUT

    assert kernel_dot_precision(THROUGHPUT.gemm_precision) == (
        jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    )
    assert kernel_dot_precision(BALANCED.gemm_precision) == (
        jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X6
    )
    h2_grid = jnp.arange(0.0, 0.91, 0.1)
    prior = (1.0, 0.0)
    L_hi, h2_hi = fused_alt_grid(
        rotated["Y0"], rotated["X0m"], rotated["C0"], rotated["lam"], h2_grid,
        prior=prior, reml=False, precision=BALANCED, interpret=True,
        tile_p=32, tile_m=16,
    )
    L_tp, h2_tp = fused_alt_grid(
        rotated["Y0"], rotated["X0m"], rotated["C0"], rotated["lam"], h2_grid,
        prior=prior, reml=False, precision=THROUGHPUT, interpret=True,
        tile_p=32, tile_m=16,
    )
    err = float(jnp.max(jnp.abs(L_tp - L_hi)))
    assert jnp.all(jnp.isfinite(L_tp))
    assert err < 2e-2  # screening tier, not the 1e-5 parity bar
    # argmax panel may flip only where the grid profile is near-flat
    assert float(jnp.mean((h2_tp != h2_hi).astype(jnp.float32))) < 0.2


def test_fused_single_grid_point(rotated):
    """g=1: the in-block grid loop runs once."""
    h2_grid = jnp.asarray([0.3])
    L_ref, _ = _alt_grid_impl(
        rotated["Y0"], rotated["X0m"], rotated["C0"], rotated["lam"], h2_grid,
        prior=(1.0, 0.0), reml=False, method="qr", precision=BALANCED,
    )
    L_pl, h2_pl = fused_alt_grid(
        rotated["Y0"], rotated["X0m"], rotated["C0"], rotated["lam"], h2_grid,
        prior=(1.0, 0.0), reml=False, precision=BALANCED, interpret=True,
        tile_p=32, tile_m=16,
    )
    assert float(jnp.max(jnp.abs(L_pl - L_ref))) < 5e-5
    assert float(jnp.max(jnp.abs(h2_pl - 0.3))) < 1e-12


def test_engine_kwarg_validation():
    rng = np.random.default_rng(0)
    n = 20
    Y = rng.normal(size=(n, 4))
    G = rng.uniform(0, 1, (n, 8))
    K = np.eye(n) * 0.9 + 0.1
    with pytest.raises(ValueError, match="engine"):
        bulkscan(Y, G, K, method="alt-grid", engine="banana")
    with pytest.raises(ValueError, match="alt-grid"):
        bulkscan(Y, G, K, method="null-grid", engine="pallas")
    # engine="xla" always valid; "auto" on CPU resolves to XLA
    a = bulkscan(Y, G, K, method="alt-grid", engine="xla")
    b = bulkscan(Y, G, K, method="alt-grid", engine="auto")
    assert float(jnp.max(jnp.abs(a.L - b.L))) == 0.0


def test_grid_longer_than_int8_rejected(rotated):
    with pytest.raises(ValueError, match="127"):
        fused_alt_grid(
            rotated["Y0"], rotated["X0m"], rotated["C0"], rotated["lam"],
            jnp.linspace(0.0, 0.9, 128), prior=(1.0, 0.0),
            precision=BALANCED, interpret=True,
        )


def test_fused_no_panel_variant(rotated):
    """output_h2_panel=False skips the argmin store: identical LODs,
    panel None."""
    h2_grid = jnp.arange(0.0, 0.91, 0.1)
    prior = (1.0, 0.0)
    L_full, panel = fused_alt_grid(
        rotated["Y0"], rotated["X0m"], rotated["C0"], rotated["lam"],
        h2_grid, prior=prior, reml=False, precision=BALANCED,
        interpret=True, tile_p=32, tile_m=16,
    )
    L_min, none = fused_alt_grid(
        rotated["Y0"], rotated["X0m"], rotated["C0"], rotated["lam"],
        h2_grid, prior=prior, reml=False, precision=BALANCED,
        interpret=True, tile_p=32, tile_m=16, output_h2_panel=False,
    )
    assert none is None and panel is not None
    assert float(jnp.max(jnp.abs(L_full - L_min))) == 0.0


def test_bulkscan_output_h2_panel_flag(rotated):
    """bulkscan(..., output_h2_panel=False) on the XLA path returns the
    same L with h2_panel=None (the flag elides the kernel's argmin store;
    XLA computes the panel either way and just drops it)."""
    import numpy as np

    import bulklmm_tpu as bl

    rng = np.random.default_rng(4)
    n, p, m = 40, 30, 6
    G = rng.uniform(0, 1, (n, p))
    K = np.asarray(bl.calc_kinship(G))
    Y = rng.normal(size=(n, m))
    a = bl.bulkscan(Y, G, K, method="alt-grid")
    b = bl.bulkscan(Y, G, K, method="alt-grid", output_h2_panel=False)
    assert b.h2_panel is None and a.h2_panel is not None
    assert float(jnp.max(jnp.abs(jnp.asarray(a.L) - jnp.asarray(b.L)))) == 0.0


@pytest.mark.parametrize("n,p,m,c", [(37, 53, 29, 1), (23, 19, 70, 3)])
def test_fused_ragged_shapes(n, p, m, c):
    """n, p and m that are not powers of two (nor tile multiples) pad and
    slice back exactly; the n-tile loop runs more than once."""
    rng = np.random.default_rng(n)
    C0 = np.column_stack([np.ones(n)] + [rng.normal(size=n) for _ in range(c - 1)])
    args = (
        jnp.asarray(rng.normal(size=(n, m))),
        jnp.asarray(rng.normal(size=(n, p))),
        jnp.asarray(C0),
        jnp.asarray(np.sort(rng.uniform(0.05, 3.0, n))),
        jnp.arange(0.0, 0.91, 0.3),
    )
    L_ref, h2_ref = _alt_grid_impl(
        *args, prior=(1.0, 0.0), reml=False, method="qr", precision=BALANCED,
    )
    L_pl, h2_pl = fused_alt_grid(
        *args, prior=(1.0, 0.0), precision=BALANCED, interpret=True,
        tile_p=16, tile_m=16,
    )
    assert L_pl.shape == (p, m) and h2_pl.shape == (p, m)
    assert float(jnp.max(jnp.abs(L_pl - L_ref))) < 5e-5
    assert float(jnp.mean((h2_pl != h2_ref).astype(jnp.float32))) == 0.0


def test_fused_masks_degenerate_marker(rotated):
    """A monomorphic marker (collinear with the intercept) gets LOD 0 on
    the kernel path exactly as on the XLA path (COMPAT.md #15)."""
    X = rotated["X0m"].at[:, 5].set(rotated["C0"][:, 0] * 0.5)
    h2_grid = jnp.arange(0.0, 0.91, 0.1)
    L_ref, _ = _alt_grid_impl(
        rotated["Y0"], X, rotated["C0"], rotated["lam"], h2_grid,
        prior=(1.0, 0.0), reml=False, method="qr", precision=BALANCED,
    )
    L_pl, _ = fused_alt_grid(
        rotated["Y0"], X, rotated["C0"], rotated["lam"], h2_grid,
        prior=(1.0, 0.0), precision=BALANCED, interpret=True,
        tile_p=32, tile_m=16,
    )
    assert float(jnp.max(jnp.abs(L_pl[5]))) < 1e-6
    assert float(jnp.max(jnp.abs(L_pl - L_ref))) < 5e-5
