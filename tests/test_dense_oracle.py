"""Engine vs the independent-ALGORITHM dense-Sigma oracle (tests/oracle_dense.py).

Closes the parity gap left by the LFS-missing R lmmlite goldens (reference
test/scan_test_lmmlite.jl:16-31): every other cross-check in the suite shares
the FaST-LMM eigen-rotation algorithm with the engine under test. The oracle
here maximizes the Kang-2008 likelihood on the DENSE covariance
Sigma = sigma2 (h2 K + (1-h2) I) via explicit Cholesky at every candidate h2
— no eigendecomposition anywhere — so agreement validates the whole pipeline
(rotation, weights, Brent, WLS, LOD) against a genuinely different
computational path.

Bars (EXACT64): |dh2| <= 1e-6 and, at matched h2, max|dLOD| <= 1e-8 (measured
~1e-14). The fully-independent LOD comparison (each side fitting its own h2)
carries a fundamental floor: near the optimum the profile likelihood is flat
(d_ell ~ curvature * dh2^2), so ANY function-value optimizer — the engine's
Brent, scipy's bounded Brent, Optim.jl's — can only localize h2 to
~sqrt(eps_f64 / curvature) ~ 1e-8, and the null-scan LOD depends LINEARLY on
the plugged-in h2_null, giving |dLOD| ~ |dLOD/dh2| * 1e-8 regardless of
tolerance settings (verified: the oracle at xatol=1e-11 still sits 3e-8 from
the tightly-refined optimum). The independent-fit bar is therefore 1e-6 —
still ~30x tighter than the reference's own lmmlite bar (maxSqDiff <= 1e-9,
i.e. |dLOD| <= ~3e-5 per marker, scan_test_lmmlite.jl:27-31). The alt path
evaluates LOD at per-model STATIONARY points (dh2^2 error), so it meets 1e-8
with fully independent fits.
"""

from pathlib import Path

import numpy as np
import pytest

import bulklmm_tpu as bl
from bulklmm_tpu.utils.config import EXACT64

import oracle_dense as od

HELIUM = Path("/root/reference/test/ref_data_for_tests/kinship_ref.he")

LOD_TOL = 1e-8
H2_TOL = 1e-6


def _dataset(seed, n, p, real_k=False):
    rng = np.random.default_rng(seed)
    if real_k:
        K = np.asarray(bl.read_helium_matrix(HELIUM), dtype=np.float64)
        n = K.shape[0]
    else:
        A = rng.normal(size=(n, n + 8))
        K = A @ A.T / (n + 8)
        K /= np.diag(K).mean()
    G = rng.uniform(0.0, 1.0, (n, p))
    if real_k:
        lam, U = np.linalg.eigh(K)
        Khalf = U @ np.diag(np.sqrt(np.clip(lam, 0.0, None))) @ U.T
    else:
        Khalf = np.linalg.cholesky(K + 1e-12 * np.eye(n))
    h2 = rng.uniform(0.3, 0.7)
    y = np.sqrt(h2) * (Khalf @ rng.normal(size=n)) + np.sqrt(1.0 - h2) * rng.normal(size=n)
    y += 0.9 * (G[:, 2] - G[:, 2].mean())
    return y, G, K


# three random datasets + the real BXD kinship spectrum
CASES = [
    ("rand-a", dict(seed=11, n=45, p=10)),
    ("rand-b", dict(seed=23, n=70, p=10)),
    ("rand-c", dict(seed=37, n=55, p=10)),
    pytest.param(
        "real-bxd", dict(seed=79, n=0, p=10, real_k=True),
        marks=pytest.mark.skipif(not HELIUM.is_file(), reason="kinship golden not mounted"),
    ),
]


@pytest.mark.parametrize("name,cfg", CASES)
@pytest.mark.parametrize("reml", [False, True])
def test_scan_null_matches_dense_sigma(name, cfg, reml):
    y, G, K = _dataset(**cfg)
    res = bl.scan(y, G, K, reml=reml, optim_interval=8, precision=EXACT64)
    ref = od.scan_null_dense(y, G, K, reml=reml, ninterval=8)
    # (1) independent optimizers locate the same h2 optimum
    assert abs(float(res.h2_null) - ref["h2_null"]) <= H2_TOL
    # (2) fully independent end-to-end (each side its own h2 fit): bounded
    # by the sqrt(eps) Brent localization floor — see module docstring
    assert np.max(np.abs(np.asarray(res.lod) - ref["lod"])) <= 1e-6
    # (3) whole LOD pipeline at matched h2: dense-Cholesky whitening + OLS
    # RSS ratios vs the engine's rotation + weighted GEMM path
    ref_at = od.scan_null_dense(y, G, K, reml=reml, h2_override=float(res.h2_null))
    assert np.max(np.abs(np.asarray(res.lod) - ref_at["lod"])) <= LOD_TOL


@pytest.mark.parametrize("name,cfg", CASES)
def test_scan_alt_matches_dense_sigma(name, cfg):
    y, G, K = _dataset(**cfg)
    G = G[:, :6]  # alt path refits h2 per marker on both sides — keep p small
    res = bl.scan(y, G, K, assumption="alt", optim_interval=8, precision=EXACT64)
    ref = od.scan_alt_dense(y, G, K, ninterval=8)
    assert np.max(np.abs(np.asarray(res.h2_each_marker) - ref["h2_each_marker"])) <= H2_TOL
    assert np.max(np.abs(np.asarray(res.lod) - ref["lod"])) <= LOD_TOL


def test_scan_covar_weights_prior_matches_dense_sigma():
    """Full-kwarg path: extra covariates + heteroskedastic weights + prior."""
    y, G, K = _dataset(seed=51, n=50, p=10)
    rng = np.random.default_rng(99)
    covar = rng.normal(size=(len(y), 2))
    w = rng.uniform(0.5, 2.0, len(y))
    prior = (0.8, 0.3)
    res = bl.scan(
        y, G, K, covar=covar, weights=w,
        prior_variance=prior[0], prior_sample_size=prior[1],
        reml=True, optim_interval=8, precision=EXACT64,
    )
    ref = od.scan_null_dense(
        y, G, K, covar=covar, weights=w, prior=prior, reml=True, ninterval=8
    )
    assert abs(float(res.h2_null) - ref["h2_null"]) <= H2_TOL
    assert np.max(np.abs(np.asarray(res.lod) - ref["lod"])) <= 1e-6
    ref_at = od.scan_null_dense(
        y, G, K, covar=covar, weights=w, prior=prior, reml=True,
        h2_override=float(res.h2_null),
    )
    assert np.max(np.abs(np.asarray(res.lod) - ref_at["lod"])) <= LOD_TOL


@pytest.mark.parametrize("name,cfg", CASES)
def test_bulkscan_null_grid_matches_dense_sigma(name, cfg):
    y, G, K = _dataset(**cfg)
    rng = np.random.default_rng(cfg["seed"] + 1)
    n = len(y)
    Y = np.column_stack([y, rng.normal(size=(n, 2)) + y[:, None] * 0.3])
    grid = np.arange(0.0, 1.0, 0.1)
    res = bl.bulkscan(
        Y, G, K, method="null-grid", h2_grid=grid,
        prior_variance=0.0, prior_sample_size=0.0, precision=EXACT64,
    )
    ref = od.bulkscan_null_grid_dense(Y, G, K, grid)
    assert np.max(np.abs(np.asarray(res.h2_null_list) - ref["h2_null"])) <= H2_TOL
    assert np.max(np.abs(np.asarray(res.L) - ref["lod"])) <= LOD_TOL


def test_effects_match_dense_sigma():
    """GLS effect sizes + Wald SEs vs the dense-Sigma path (the in-repo
    effects oracle shares the rotated-weights algebra with the engine;
    this one whitens by explicit Cholesky of V)."""
    y, G, K = _dataset(seed=71, n=50, p=12)
    res = bl.scan(y, G, K, output_effects=True, optim_interval=8,
                  precision=EXACT64)
    eb, es = od.effects_dense(y, G, K, float(res.h2_null))
    assert np.max(np.abs(np.asarray(res.beta) - eb)) <= 1e-8
    assert np.max(np.abs(np.asarray(res.beta_se) - es)) <= 1e-8
    # bulkscan effects column
    rng = np.random.default_rng(5)
    Y = np.column_stack([y, rng.normal(size=(len(y), 2))])
    rb = bl.bulkscan(Y, G, K, output_effects=True, prior_variance=0.0,
                     precision=EXACT64)
    for t in range(Y.shape[1]):
        eb, es = od.effects_dense(Y[:, t], G, K, float(rb.h2_null_list[t]))
        assert np.max(np.abs(np.asarray(rb.beta_mat[:, t]) - eb)) <= 1e-8, t
        assert np.max(np.abs(np.asarray(rb.beta_se_mat[:, t]) - es)) <= 1e-8, t


def test_loco_matches_dense_sigma():
    """LOCO engine vs per-chromosome dense-Sigma scans: each chromosome's
    columns must equal a dense scan against the leave-that-chromosome-out
    kinship (independent algorithm end to end)."""
    y, G, K = _dataset(seed=83, n=45, p=12)
    chrom = np.repeat(["1", "2", "3"], [5, 4, 3])
    res = bl.scan_loco(y, G, chrom, optim_interval=8, precision=EXACT64)
    for c in ("1", "2", "3"):
        mask = chrom == c
        Kc = np.asarray(bl.calc_kinship(G[:, ~mask]))
        ref = od.scan_null_dense(y, G[:, mask], Kc, ninterval=8)
        idx = np.flatnonzero(mask)
        got = np.asarray(res.lod)[idx]
        assert abs(float(res.h2_null_by_chrom[c]) - ref["h2_null"]) <= 1e-6, c
        assert np.max(np.abs(got - ref["lod"])) <= 1e-6, c
        ref_at = od.scan_null_dense(
            y, G[:, mask], Kc, h2_override=float(res.h2_null_by_chrom[c])
        )
        assert np.max(np.abs(got - ref_at["lod"])) <= 1e-8, c
