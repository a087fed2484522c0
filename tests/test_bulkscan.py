"""Multi-trait scan consistency tests (reference test/bulkscan_test.jl):
fast paths vs exact paths, h2-injection trick, wrapper == method."""

import jax.numpy as jnp
import numpy as np

from bulklmm_tpu import bulkscan, bulkscan_alt_grid, bulkscan_null, bulkscan_null_grid, scan


def test_null_exact_column_equals_scan(bxd_like):
    """bulkscan(null-exact) trait column == scan() LOD (reference
    test/bulkscan_test.jl:60-80, tolerance 1e-7)."""
    out = bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"],
                   method="null-exact", prior_variance=0.0)
    for j in (0, 3, 7):
        single = scan(bxd_like["Y"][:, j], bxd_like["G"], bxd_like["K"])
        d = np.asarray(out.L[:, j]) - np.asarray(single.lod)
        assert np.sum(d * d) < 1e-7
        assert abs(float(out.h2_null_list[j]) - float(single.h2_null)) < 1e-6


def test_null_grid_with_injected_h2_equals_scan(bxd_like):
    """Injecting each trait's exact h2-hat into the grid makes null-grid equal
    the exact scan (reference test/bulkscan_test.jl:86-107). Some traits have
    bimodal profile likelihoods, so the exact scans use optim_interval=10
    (the reference's gridbrent guard) to find the global optimum the grid
    argmax would also find."""
    exact_h2 = [
        float(scan(bxd_like["Y"][:, j], bxd_like["G"], bxd_like["K"],
                   optim_interval=10).h2_null)
        for j in range(bxd_like["m"])
    ]
    grid = np.unique(np.concatenate([np.arange(0.0, 0.91, 0.1), exact_h2]))
    out = bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"],
                   method="null-grid", h2_grid=grid, prior_variance=0.0)
    for j in (0, 5, 11):
        single = scan(bxd_like["Y"][:, j], bxd_like["G"], bxd_like["K"],
                      optim_interval=10)
        d = np.asarray(out.L[:, j]) - np.asarray(single.lod)
        assert np.sum(d * d) < 1e-7


def test_null_grid_approximates_exact(bxd_like):
    """Default 0.1-spaced grid approximates null-exact loosely. The exact path
    uses optim_interval=10 so its Brent finds the same global optimum the grid
    argmax sees on bimodal profiles (both use the default prior_variance=1.0,
    which regularizes the h2->1 boundary)."""
    g = bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"], method="null-grid")
    e = bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"], method="null-exact",
                 optim_interval=10)
    assert np.mean((np.asarray(g.L) - np.asarray(e.L)) ** 2) < 0.01
    assert np.max(np.abs(np.asarray(g.h2_null_list) - np.asarray(e.h2_null_list))) <= 0.1 + 1e-9


def test_alt_grid_approximates_scan_alt(bxd_like):
    """bulkscan(alt-grid) ~ scan(alt) with the reference's loose tolerances
    (test/bulkscan_test.jl:113-137: mean |dh2| <= 0.05, mean dLOD^2 <= 0.01)."""
    G = bxd_like["G"][:, :40]
    # near-boundary knots cover markers whose exact alt h2-hat sits at h2->1
    grid = np.concatenate([np.arange(0.0, 0.96, 0.05), [0.98, 0.995]])
    out = bulkscan(bxd_like["Y"], G, bxd_like["K"], method="alt-grid",
                   h2_grid=grid, prior_variance=0.0)
    for j in (0, 2):
        single = scan(bxd_like["Y"][:, j], G, bxd_like["K"], assumption="alt")
        dlod = np.asarray(out.L[:, j]) - np.asarray(single.lod)
        dh2 = np.asarray(out.h2_panel[:, j]) - np.asarray(single.h2_each_marker)
        assert np.mean(np.abs(dh2)) <= 0.05
        assert np.mean(dlod * dlod) <= 0.01


def test_wrapper_equals_methods(bxd_like):
    """bulkscan wrapper dispatches to the same engines (reference
    test/bulkscan_test.jl:139-178)."""
    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    a = bulkscan(Y, G, K, method="null-grid")
    b = bulkscan_null_grid(Y, G, K)
    assert np.array_equal(np.asarray(a.L), np.asarray(b.L))
    c = bulkscan(Y, G, K, method="null-exact")
    d = bulkscan_null(Y, G, K)
    assert np.array_equal(np.asarray(c.L), np.asarray(d.L))
    e = bulkscan(Y, G, K, method="alt-grid")
    f = bulkscan_alt_grid(Y, G, K)
    assert np.array_equal(np.asarray(e.L), np.asarray(f.L))
    assert np.array_equal(np.asarray(e.h2_panel), np.asarray(f.h2_panel))


def test_bulkscan_output_pvals(bxd_like):
    from scipy.stats import chi2

    out = bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"], output_pvals=True)
    lrs = np.asarray(out.L) * 2 * np.log(10)
    assert np.allclose(out.log10Pvals_mat, -chi2.logsf(lrs, 1) / np.log(10))
    assert out.chisq_df == 1


def test_bulkscan_with_covariates(bxd_like):
    rng = np.random.default_rng(2)
    covar = rng.normal(size=(bxd_like["n"], 2))
    out = bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"], covar=covar,
                   method="null-exact", prior_variance=0.0)
    single = scan(bxd_like["Y"][:, 6], bxd_like["G"], bxd_like["K"], covar=covar)
    d = np.asarray(out.L[:, 6]) - np.asarray(single.lod)
    assert np.sum(d * d) < 1e-7


def test_trait_chunking_matches_unchunked(bxd_like):
    """trait_chunk bounds memory via lax.map; results must be identical,
    including when m is not a chunk multiple."""
    import jax.numpy as jnp

    from bulklmm_tpu import bulkscan

    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    for method in ("null-grid", "null-exact", "alt-grid"):
        full = bulkscan(Y, G, K, method=method)
        chunked = bulkscan(Y, G, K, method=method, trait_chunk=5)  # 16 % 5 != 0
        assert chunked.L.shape == full.L.shape
        assert float(jnp.max(jnp.abs(chunked.L - full.L))) < 1e-12
        # chunk larger than m: single padded block
        big = bulkscan(Y, G, K, method=method, trait_chunk=64)
        assert float(jnp.max(jnp.abs(big.L - full.L))) < 1e-12


def test_precision_presets_accuracy_bounds(bxd_like):
    """Every shipped precision preset must stay within its documented
    absolute-LOD bound of the f64 reference path (utils/config.py preset
    docs). On CPU the GEMM precision knob is a no-op, so this pins the
    preset *plumbing* and the f32 floor; the bounds on the card are
    enforced by chip_smoke.py and benchmarks/chip_validation.py."""
    from bulklmm_tpu.utils.config import BALANCED, EXACT64, FAST32, MIXED, THROUGHPUT

    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    ref = bulkscan(Y, G, K, precision=EXACT64)
    bounds = {
        "fast32": (FAST32, 1e-3),
        "mixed": (MIXED, 1e-5),
        "balanced": (BALANCED, 1e-5),
        "throughput": (THROUGHPUT, 4e-3),
    }
    for name, (preset, bound) in bounds.items():
        out = bulkscan(Y, G, K, precision=preset)
        err = float(np.max(np.abs(np.asarray(out.L, dtype=np.float64)
                                  - np.asarray(ref.L))))
        assert err < bound, (name, err)
        # grid h2 selection must be identical across presets at 0.1 spacing
        assert np.allclose(np.asarray(out.h2_null_list, dtype=np.float64),
                           np.asarray(ref.h2_null_list))


def test_bulkscan_invalid_engine_and_method(bxd_like):
    """engine/method validation happens up front for every method — a typo
    must never be silently ignored (also for LowRankKinship inputs)."""
    import pytest

    from bulklmm_tpu import bulkscan
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact

    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    with pytest.raises(ValueError, match="engine"):
        bulkscan(Y, G, K, method="null-grid", engine="palas")
    with pytest.raises(ValueError, match="alt-grid"):
        bulkscan(Y, G, K, method="null-grid", engine="pallas")
    with pytest.raises(ValueError, match="method"):
        bulkscan(Y, G, K, method="banana")
    lr = kinship_lowrank_exact(K, 10)
    with pytest.raises(ValueError, match="LowRank"):
        bulkscan(Y, G, lr, method="alt-grid", engine="pallas")


def test_bulkscan_degenerate_trait_isolated(bxd_like):
    """An all-zero trait column must not raise (device sigma2 floors at
    dtype tiny, ops/wls.py) and must not perturb the other traits' LODs."""
    from bulklmm_tpu import bulkscan

    G, K = bxd_like["G"], bxd_like["K"]
    Y = bxd_like["Y"][:, :6].copy()
    ref = {m: np.asarray(bulkscan(Y, G, K, method=m).L)
           for m in ("null-grid", "null-exact", "alt-grid")}
    Yz = np.concatenate([Y, np.zeros((Y.shape[0], 1))], axis=1)
    for m, refL in ref.items():
        L = np.asarray(bulkscan(Yz, G, K, method=m).L)  # must not raise
        assert np.array_equal(L[:, :6], refL), m
