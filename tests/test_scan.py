"""Single-trait scan tests: golden cross-implementation vs the numpy oracle
(which follows the reference's per-marker RSS-loop path), covariates,
eigen/svd equivalence, p-value output, kinship properties.

Mirrors reference test/scan_test_lmmlite.jl (golden cross-implementation) and
test/scan_covar_test.jl (consistency under options)."""

import jax.numpy as jnp
import numpy as np

import oracle
from bulklmm_tpu import calc_kinship, scan

TOL = 1e-8


def test_kinship_properties(bxd_like):
    K = np.asarray(calc_kinship(jnp.asarray(bxd_like["G"])))
    assert np.allclose(K, bxd_like["K"], atol=1e-12)
    assert np.allclose(K, K.T)
    assert np.allclose(np.diag(K), 1.0)
    lam = np.linalg.eigvalsh(K)
    assert lam.min() > -1e-7


def test_scan_null_matches_oracle_ml_and_reml(bxd_like):
    """The engine computes LODs via the correlation identity; the oracle
    uses the reference's RSS swap loop. Agreement here is the analogue of the
    reference's lmmlite golden test (maxSqDiff <= 1e-9)."""
    y = bxd_like["Y"][:, 0]
    for reml in (False, True):
        mine = scan(y, bxd_like["G"], bxd_like["K"], reml=reml)
        ref = oracle.scan_null(y, bxd_like["G"], bxd_like["K"], reml=reml)
        assert abs(float(mine.h2_null) - ref["h2_null"]) < 1e-5
        assert abs(float(mine.sigma2_e) - ref["sigma2_e"]) < 1e-7
        d = np.asarray(mine.lod) - ref["lod"]
        assert np.max(d * d) < 1e-9
        assert np.sum(d * d) < np.sqrt(1e-9)


def test_scan_alt_matches_oracle(bxd_like):
    y = bxd_like["Y"][:, 1]
    G = bxd_like["G"][:, :30]  # alt path is p Brent fits; keep the test fast
    mine = scan(y, G, bxd_like["K"], assumption="alt")
    ref = oracle.scan_alt(y, G, bxd_like["K"])
    assert np.max(np.abs(np.asarray(mine.lod) - ref["lod"])) < 1e-6
    assert np.max(np.abs(np.asarray(mine.h2_each_marker) - ref["h2_each_marker"])) < 1e-4
    # alt LOD >= null LOD at the same markers (extra free parameter h2)
    null = scan(y, G, bxd_like["K"])
    assert np.all(np.asarray(mine.lod) >= np.asarray(null.lod) - 1e-6)


def test_scan_alt_compat_sqrt_weights(bxd_like):
    """compat_sqrt_weights=True reproduces the reference's sqrt-weights quirk
    (reference src/scan.jl:432-440) exactly, against an oracle implementing
    the quirk — making alt-path parity vs real reference output falsifiable."""
    # trait 6: interior GLOBAL optimum (h2 ~0.86), so the quirk bites.
    # (Trait 5's profile is globally maximized at h2=0 — its former ~0.52
    # fit was a LOCAL optimum that the round-5 endpoint guard now
    # correctly rejects, making the quirk a no-op there.)
    y = bxd_like["Y"][:, 6]
    G = bxd_like["G"][:, :30]
    mine = scan(y, G, bxd_like["K"], assumption="alt", compat_sqrt_weights=True)
    ref = oracle.scan_alt_compat(y, G, bxd_like["K"])
    assert np.mean(ref["h2_each_marker"]) > 0.05  # quirk is not a no-op here
    assert np.max(np.abs(np.asarray(mine.lod) - ref["lod"])) < 1e-6
    assert np.max(np.abs(np.asarray(mine.h2_each_marker) - ref["h2_each_marker"])) < 1e-4
    # h2 estimates agree between modes (only the LOD evaluation changes);
    # the LODs themselves genuinely differ
    default = scan(y, G, bxd_like["K"], assumption="alt")
    assert np.allclose(
        np.asarray(mine.h2_each_marker), np.asarray(default.h2_each_marker),
        atol=1e-9,
    )
    assert np.max(np.abs(np.asarray(mine.lod) - np.asarray(default.lod))) > 1e-4


def test_scan_alt_compat_reml_reeval_is_ml(bxd_like):
    """Under reml=True the quirk path still re-evaluates with ML (the
    reference's re-evaluating wls calls leave reml at its default false)."""
    y = bxd_like["Y"][:, 9]  # interior fitted h2 (~0.71)
    G = bxd_like["G"][:, :20]
    mine = scan(y, G, bxd_like["K"], assumption="alt", reml=True,
                compat_sqrt_weights=True)
    ref = oracle.scan_alt_compat(y, G, bxd_like["K"], reml=True)
    assert np.max(np.abs(np.asarray(mine.lod) - ref["lod"])) < 1e-6


def test_scan_vector_vs_matrix_input(bxd_like):
    y = bxd_like["Y"][:, 2]
    a = scan(y, bxd_like["G"], bxd_like["K"])
    b = scan(y[:, None], bxd_like["G"], bxd_like["K"])
    assert np.array_equal(np.asarray(a.lod), np.asarray(b.lod))


def test_scan_eigen_vs_svd(bxd_like):
    y = bxd_like["Y"][:, 3]
    a = scan(y, bxd_like["G"], bxd_like["K"], decomp_scheme="eigen")
    b = scan(y, bxd_like["G"], bxd_like["K"], decomp_scheme="svd")
    assert abs(float(a.h2_null) - float(b.h2_null)) < 1e-6
    assert np.max(np.abs(np.asarray(a.lod) - np.asarray(b.lod))) < 1e-7


def test_scan_with_covariates(bxd_like):
    rng = np.random.default_rng(1)
    n = bxd_like["n"]
    covar = rng.normal(size=(n, 2))
    y = bxd_like["Y"][:, 4]
    mine = scan(y, bxd_like["G"], bxd_like["K"], covar=covar)
    assert np.all(np.isfinite(np.asarray(mine.lod)))
    # oracle with covariates: residual check via its own machinery
    y0, X0, lam = oracle.rotate(y, np.concatenate([covar, bxd_like["G"]], axis=1),
                                bxd_like["K"], add_intercept=True)
    fit = oracle.fit_lmm(y0, X0[:, :3], lam)
    assert abs(float(mine.h2_null) - fit["h2"]) < 1e-5
    sw = np.sqrt(oracle.make_weights(fit["h2"], lam))
    y0w, X0w = y0 * sw[:, None], X0 * sw[:, None]
    rss0 = oracle.rss(y0w, X0w[:, :3])[0]
    n_ = len(y)
    lod17 = (n_ / 2) * (
        np.log10(rss0)
        - np.log10(oracle.rss(y0w, np.concatenate([X0w[:, :3], X0w[:, 3 + 17 : 4 + 17]], axis=1))[0])
    )
    assert abs(float(mine.lod[17]) - lod17) < 1e-8


def test_scan_no_intercept_requires_covar(bxd_like):
    import pytest

    with pytest.raises(ValueError):
        scan(bxd_like["Y"][:, 0], bxd_like["G"], bxd_like["K"], add_intercept=False)


def test_scan_output_pvals(bxd_like):
    from scipy.stats import chi2

    y = bxd_like["Y"][:, 0]
    out = scan(y, bxd_like["G"], bxd_like["K"], output_pvals=True, chisq_df=1)
    lrs = np.asarray(out.lod) * 2 * np.log(10)
    assert np.allclose(out.log10pvals, -chi2.logsf(lrs, 1) / np.log(10))


def test_scan_prior_regularization(bxd_like):
    """Nonzero prior shrinks sigma2 toward prior_variance and keeps LODs finite."""
    y = bxd_like["Y"][:, 5]
    out0 = scan(y, bxd_like["G"], bxd_like["K"])
    out1 = scan(y, bxd_like["G"], bxd_like["K"], prior_variance=1.0, prior_sample_size=3.0)
    assert np.all(np.isfinite(np.asarray(out1.lod)))
    ref = oracle.scan_null(y, bxd_like["G"], bxd_like["K"], prior=(1.0, 3.0))
    assert abs(float(out1.h2_null) - ref["h2_null"]) < 1e-5
    assert np.max(np.abs(np.asarray(out1.lod) - ref["lod"])) < 1e-7
    # the prior demonstrably changes the fit (sigma2 shrinks toward
    # prior_variance; h2 alone is a weak discriminator — both fits may
    # land on the exact same endpoint, e.g. h2 = 0 for this trait)
    assert not np.allclose(float(out0.sigma2_e), float(out1.sigma2_e))


def test_kinship_decomposition_cache(bxd_like):
    """Passing a precomputed KinshipDecomposition must give identical
    results to passing the raw kinship matrix, and reject the weights path."""
    import pytest

    from bulklmm_tpu import bulkscan, decompose_kinship, scan

    K = bxd_like["K"]
    dec = decompose_kinship(K)
    y, G = bxd_like["Y"][:, 0], bxd_like["G"]
    a = scan(y, G, K)
    b = scan(y, G, dec)
    assert np.allclose(np.asarray(a.lod), np.asarray(b.lod))
    ra = bulkscan(bxd_like["Y"], G, K)
    rb = bulkscan(bxd_like["Y"], G, dec)
    assert np.allclose(np.asarray(ra.L), np.asarray(rb.L))
    with pytest.raises(ValueError, match="cached decomposition"):
        scan(y, G, dec, weights=np.ones(bxd_like["n"]))


def test_scan_degenerate_zero_trait_no_crash(bxd_like):
    """An all-zero phenotype (rss0 == 0) must return a degenerate result,
    not raise from inside the host float64 Brent (ops/hostfit.py floors
    sigma2 at float64 tiny so math.log stays defined)."""
    from bulklmm_tpu import scan, scan_perms_lite

    G, K, n = bxd_like["G"], bxd_like["K"], bxd_like["n"]
    res = scan(np.zeros(n), G, K)  # must not raise
    assert np.asarray(res.lod).shape == (bxd_like["p"],)
    res2 = scan_perms_lite(np.zeros(n), G, np.ones((n, 0)), K, nperms=4)
    assert np.asarray(res2.L_perms).shape[1] == 4


def test_scan_perms_lite_h2_matches_scan(bxd_like):
    """scan_perms_lite and scan(permutation_test=True) share the
    backend-deterministic host float64 null fit — with the same prior the
    fitted h2/sigma2 must agree bit-exactly."""
    from bulklmm_tpu import scan, scan_perms_lite

    y, G, K = bxd_like["Y"][:, 3], bxd_like["G"], bxd_like["K"]
    a = scan(y, G, K, permutation_test=True, nperms=8, prior_variance=1.0)
    b = scan_perms_lite(y, G, np.ones((bxd_like["n"], 0)), K, nperms=8)
    assert float(a.h2_null) == float(b.h2_null)
    assert float(a.sigma2_e) == float(b.sigma2_e)


def test_perms_host_fit_untruncated_without_x64(tmp_path):
    """With x64 OFF (JAX's default), scan_perms_lite and
    scan_perms_sharded must still feed the host float64 null fit the
    untruncated phenotype — h2/sigma2 bit-equal to scan()'s."""
    import subprocess
    import sys
    import textwrap

    script = textwrap.dedent("""
        import os
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax
        jax.config.update("jax_platforms", "cpu")  # x64 stays OFF
        import numpy as np
        import bulklmm_tpu as bl
        from bulklmm_tpu.parallel import make_mesh, scan_perms_sharded

        rng = np.random.default_rng(11)
        n, p = 40, 16
        G = rng.choice([0.0, 1.0], size=(n, p))
        K = np.asarray(bl.calc_kinship(G))
        # f64 phenotype with digits beyond f32 precision
        y = rng.normal(size=n) * (1.0 + 1e-9 * rng.normal(size=n))
        a = bl.scan(y, G, K, permutation_test=True, nperms=4,
                    prior_variance=1.0)
        b = bl.scan_perms_lite(y, G, np.ones((n, 0)), K, nperms=4)
        c = scan_perms_sharded(y, G, K, mesh=make_mesh(8), nperms=4)
        assert float(a.h2_null) == float(b.h2_null), (a.h2_null, b.h2_null)
        assert float(a.h2_null) == float(c.h2_null), (a.h2_null, c.h2_null)
        print("OK", float(a.h2_null))
    """)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK" in r.stdout



def test_scan_perms_monomorphic_marker_no_nan(bxd_like):
    """A marker collinear with the intercept (monomorphic) must yield
    finite permutation LODs — an unguarded 0/0 in the normalization would
    NaN a whole L_perms row and poison the max-over-markers thresholds."""
    import bulklmm_tpu as bl

    y = bxd_like["Y"][:, 0]
    G2 = np.array(bxd_like["G"], copy=True)
    G2[:, 5] = 0.5  # monomorphic: exactly collinear with the intercept
    res = scan(y, G2, bxd_like["K"], permutation_test=True, nperms=32,
               rndseed=3)
    L = np.asarray(res.L_perms)
    assert np.isfinite(L).all()
    assert np.isfinite(np.asarray(res.lod)).all()
    # the degenerate marker residualizes to rounding noise: its LOD is a
    # small random value (noise-direction correlation), never huge or NaN
    assert abs(float(res.lod[5])) < 2.0
    thr = bl.get_thresholds(L, [0.10, 0.05])
    assert np.isfinite(np.asarray(thr.thrs)).all()
    # non-perm path too
    res2 = scan(y, G2, bxd_like["K"])
    assert np.isfinite(np.asarray(res2.lod)).all()


def test_scan_profile_ll_default_and_validation(bxd_like):
    import pytest

    y = bxd_like["Y"][:, 0]
    G, K = bxd_like["G"], bxd_like["K"]
    # default marker_id=1 profiles the FIRST marker (1-based, like the
    # reference); the old default 0 silently profiled the wrong column
    res, prof = scan(y, G, K, profile_ll=True)
    assert np.isfinite(np.asarray(prof.ll_list_null)).all()
    assert np.isfinite(np.asarray(prof.ll_list_alt)).all()
    with pytest.raises(ValueError, match="1-based"):
        scan(y, G, K, profile_ll=True, marker_id=0)
    with pytest.raises(ValueError, match="1-based"):
        scan(y, G, K, profile_ll=True, marker_id=G.shape[1] + 1)


def test_scan_alt_reml_lod_is_ml_lrt(bxd_like):
    """Under REML the alt-path LOD must come from ML likelihoods at the
    fitted h2s (REML log-likelihoods are not comparable across designs
    with different fixed effects): reml=True and reml=False alt LODs may
    differ only through the slightly different h2 estimates, not through
    a non-cancelling REML term."""
    y = bxd_like["Y"][:, 1]
    G = bxd_like["G"][:, :25]
    a = scan(y, G, bxd_like["K"], assumption="alt", reml=False)
    b = scan(y, G, bxd_like["K"], assumption="alt", reml=True)
    la, lb = np.asarray(a.lod), np.asarray(b.lod)
    assert np.isfinite(lb).all()
    # LRT of nested models: nonnegative up to optimizer tolerance
    assert lb.min() > -1e-3
    assert np.max(np.abs(la - lb)) < 0.2
