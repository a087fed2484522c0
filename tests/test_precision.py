"""Numerics pins: the accurate-f32 log10, the precision presets against
EXACT64, and HIGHEST on every f32 product of the flagship core."""

import jax.numpy as jnp
import numpy as np

from bulklmm_tpu.ops.lod import log10_f32_accurate
from bulklmm_tpu.utils.config import (
    BALANCED, EXACT64, FAST32, MIXED, f32_dots_below_highest,
)


def test_log10_f32_accurate():
    x = np.random.default_rng(0).uniform(1e-7, 1.0, 50000).astype(np.float32)
    y = np.asarray(log10_f32_accurate(jnp.asarray(x)))
    assert np.max(np.abs(y - np.log10(x.astype(np.float64)))) < 2e-6
    # domain guard
    bad = np.asarray(log10_f32_accurate(jnp.asarray([-1.0, 0.0], dtype=jnp.float32)))
    assert np.isnan(bad).all()


def test_precision_presets_agree(bxd_like):
    """FAST32 and MIXED must track EXACT64 within their documented bars."""
    from bulklmm_tpu import bulkscan

    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    exact = bulkscan(Y, G, K, precision=EXACT64)
    mixed = bulkscan(Y, G, K, precision=MIXED)
    balanced = bulkscan(Y, G, K, precision=BALANCED)
    fast = bulkscan(Y, G, K, precision=FAST32)
    assert float(jnp.max(jnp.abs(mixed.L - exact.L))) < 1e-4
    assert float(jnp.max(jnp.abs(balanced.L - exact.L))) < 1e-4
    assert float(jnp.max(jnp.abs(fast.L.astype(jnp.float64) - exact.L))) < 1e-3
    # h2 grid selection must be identical across the f64-grid precisions
    assert np.array_equal(
        np.asarray(mixed.h2_null_list), np.asarray(exact.h2_null_list)
    )
    assert np.array_equal(
        np.asarray(balanced.h2_null_list), np.asarray(exact.h2_null_list)
    )


def _flagship_hlo(bxd_like, precision):
    from bulklmm_tpu.models.bulkscan import _null_grid_pipeline
    from bulklmm_tpu.ops.rotation import resolve_kinship

    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    Ut, lam = resolve_kinship(K, "eigen", jnp.float64)
    return _null_grid_pipeline.lower(
        jnp.asarray(Y), jnp.asarray(G), jnp.ones((Y.shape[0], 1)), Ut, lam,
        jnp.arange(0.0, 0.91, 0.1), prior=(1.0, 0.0), reml=False,
        method="qr", precision=precision,
    ).as_text()


def test_flagship_core_f32_dots_at_highest(bxd_like):
    """Every f32 product of the BALANCED flagship core lowers at HIGHEST
    (on a GPU the default would be single-pass TF32, ~1e-3 LOD)."""
    text = _flagship_hlo(bxd_like, BALANCED)
    assert "xf32>" in text and "stablehlo.dot_general" in text
    assert f32_dots_below_highest(text) == []


def test_f32_dot_pin_detector():
    """The detector flags an f32 dot without HIGHEST and ignores f64 ones."""
    lines = [
        "%0 = stablehlo.dot_general %a, %b, contracting_dims = [1] x [0], "
        "precision = [DEFAULT, DEFAULT] : (tensor<4x3xf32>, "
        "tensor<3x4xf32>) -> tensor<4x4xf32>",
        "%1 = stablehlo.dot_general %a, %b, contracting_dims = [1] x [0], "
        "precision = [HIGHEST, HIGHEST] : (tensor<4x3xf32>, "
        "tensor<3x4xf32>) -> tensor<4x4xf32>",
        "%2 = stablehlo.dot_general %c, %d, contracting_dims = [1] x [0] : "
        "(tensor<4x3xf64>, tensor<3x4xf64>) -> tensor<4x4xf64>",
    ]
    assert f32_dots_below_highest("\n".join(lines)) == [lines[0]]


def test_decovariate_removes_covariate_span_and_zeroes_collinear():
    from bulklmm_tpu.ops.smallchol import decovariate

    rng = np.random.default_rng(3)
    n = 40
    C = np.column_stack([np.ones(n), rng.normal(size=n)])
    M = np.column_stack([
        rng.uniform(0, 1, n),        # genuine
        np.full(n, 0.5),             # monomorphic
        3.0 * C[:, 1] + 2.0,         # in span(C)
        np.zeros(n),                 # all-zero (padding)
    ])
    R = np.asarray(decovariate(jnp.asarray(M), jnp.asarray(C)))
    assert np.max(np.abs(C.T @ R)) < 1e-12
    assert np.all(R[:, 1:] == 0.0)
    # the genuine column keeps its residual about the covariates
    beta = np.linalg.lstsq(C, M[:, 0], rcond=None)[0]
    np.testing.assert_allclose(R[:, 0], M[:, 0] - C @ beta, atol=1e-12)


def test_balanced_holds_uncentered_markers_and_traits(bxd_like):
    """Genotypes and traits far from zero mean: BALANCED's f32 combines
    see only the covariate-free part, so an offset changes nothing."""
    from bulklmm_tpu import bulkscan, bulkscan_perms

    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    exact = np.asarray(bulkscan(Y, G, K, precision=EXACT64).L)
    shifted = np.asarray(
        bulkscan(Y + 40.0, G + 50.0, K, precision=BALANCED).L
    )
    assert np.max(np.abs(shifted - exact)) < 1e-5
    pe = np.asarray(bulkscan_perms(Y, G, K, nperms=20, precision=EXACT64,
                                   engine="xla").maxlods)
    ps = np.asarray(bulkscan_perms(Y + 40.0, G + 50.0, K, nperms=20,
                                   precision=BALANCED, engine="xla").maxlods)
    assert np.max(np.abs(ps - pe)) < 1e-5
