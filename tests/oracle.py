"""Independent numpy/scipy float64 oracle for cross-implementation tests.

This deliberately follows the *reference's* computational path (per-marker RSS
swap loop, scipy bounded-Brent h2 optimization, mapslices-style per-column
likelihoods — see reference src/wls.jl, src/lmm.jl, src/scan.jl) rather than
the engine's GEMM identities, so agreement between the two is a genuine
cross-check of independent algorithms, standing in for the reference's R
lmmlite golden files (test/scan_test_lmmlite.jl) which require the
LFS-missing BXD data.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize_scalar


def make_weights(h2, lam):
    delta = h2 / (1.0 - h2)
    return 1.0 / (delta * lam + 1.0)


def wls(y, X, w, prior=(0.0, 0.0), reml=False, method="qr"):
    y = np.atleast_2d(np.asarray(y, dtype=np.float64).T).T
    X = np.asarray(X, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    n, p = X.shape
    a, b = prior
    sw = np.sqrt(w)
    yy = y * sw[:, None]
    XX = X * sw[:, None]
    if method == "qr":
        Q, R = np.linalg.qr(XX)
        coef = np.linalg.solve(R, Q.T @ yy)
        logdet = 2.0 * np.sum(np.log(np.abs(np.diag(R))))
    else:
        Gm = XX.T @ XX
        coef = np.linalg.solve(Gm, XX.T @ yy)
        sign, logdet = np.linalg.slogdet(Gm)
    rss0 = np.sum((yy - XX @ coef) ** 2, axis=0)
    prior_df = b + 2 if b > 0 else b
    sigma2 = (rss0 + a * b) / ((n - p if reml else n) + prior_df)
    ell = -0.5 * ((n + b) * np.log(sigma2) - np.sum(np.log(w)) + (rss0 + a * b) / sigma2)
    if reml:
        ell = ell + 0.5 * (p * np.log(sigma2) - logdet)
    return coef, sigma2, ell, rss0


def rss(y, X):
    y = np.atleast_2d(np.asarray(y).T).T
    b, *_ = np.linalg.lstsq(X, y, rcond=None)
    r = y - X @ b
    return np.sum(r * r, axis=0)


def fit_lmm(y0, X0, lam, prior=(0.0, 0.0), reml=False, ninterval=1):
    """Grid-of-Brent h2 optimization via scipy bounded minimization."""

    def negll(h2):
        return -wls(y0, X0, make_weights(h2, lam), prior, reml=reml)[2][0]

    pts = np.linspace(0.0, 1.0, ninterval + 1)
    best = (np.inf, 0.5)
    for lo, hi in zip(pts[:-1], pts[1:]):
        r = minimize_scalar(
            negll, bounds=(lo, hi), method="bounded",
            options={"xatol": 1e-10, "maxiter": 500},
        )
        if r.fun < best[0]:
            best = (r.fun, r.x)
    # LOWER endpoint candidate, mirroring ops/brent.py::gridbrent —
    # bounded Brent never samples exactly at a bound, and multimodal
    # profiles can trap it at a local boundary optimum (COMPAT.md #19;
    # h2=1 is an open boundary and is deliberately NOT a candidate)
    f0 = negll(0.0)
    if np.isfinite(f0) and f0 < best[0]:
        best = (f0, 0.0)
    h2 = best[1]
    coef, sigma2, ell, _ = wls(y0, X0, make_weights(h2, lam), prior, reml=reml)
    return dict(b=coef, sigma2=sigma2[0], h2=h2, ell=ell[0])


def rotate(y, g, K, add_intercept=True):
    y = np.atleast_2d(np.asarray(y, dtype=np.float64).T).T
    n = y.shape[0]
    X = np.concatenate([np.ones((n, 1)), g], axis=1) if add_intercept else np.asarray(g)
    lam, U = np.linalg.eigh(np.asarray(K, dtype=np.float64))
    return U.T @ y, U.T @ X, lam


def scan_null(y, g, K, prior=(0.0, 0.0), reml=False, ninterval=1):
    """Reference-path single-trait null scan: per-marker RSS swap loop
    (reference src/scan.jl:411-459)."""
    g = np.asarray(g, dtype=np.float64)
    n, p = g.shape
    y0, X0, lam = rotate(y, g, K, add_intercept=True)
    X0_cov = X0[:, :1]
    fit = fit_lmm(y0, X0_cov, lam, prior, reml=reml, ninterval=ninterval)
    sw = np.sqrt(make_weights(fit["h2"], lam))
    y0w = y0 * sw[:, None]
    X0w = X0 * sw[:, None]
    rss0 = rss(y0w, X0w[:, :1])[0]
    lod = np.zeros(p)
    X = np.zeros((n, 2))
    X[:, 0] = X0w[:, 0]
    for i in range(p):
        X[:, 1] = X0w[:, 1 + i]
        rss1 = rss(y0w, X)[0]
        lod[i] = (n / 2.0) * (np.log10(rss0) - np.log10(rss1))
    return dict(sigma2_e=fit["sigma2"], h2_null=fit["h2"], lod=lod)


def scan_alt(y, g, K, prior=(0.0, 0.0), reml=False, ninterval=1):
    """Per-marker exact VC scan with correctly-scaled weights
    (the reference's intent, without its sqrt-weights quirk)."""
    g = np.asarray(g, dtype=np.float64)
    n, p = g.shape
    y0, X0, lam = rotate(y, g, K, add_intercept=True)
    X0_cov = X0[:, :1]
    fit0 = fit_lmm(y0, X0_cov, lam, prior, reml=reml, ninterval=ninterval)
    lod = np.zeros(p)
    h2s = np.zeros(p)
    for i in range(p):
        X = np.concatenate([X0_cov, X0[:, 1 + i : 2 + i]], axis=1)
        fit1 = fit_lmm(y0, X, lam, prior, reml=reml, ninterval=ninterval)
        lod[i] = (fit1["ell"] - fit0["ell"]) / np.log(10.0)
        h2s[i] = fit1["h2"]
    return dict(
        sigma2_e=fit0["sigma2"], h2_null=fit0["h2"], lod=lod, h2_each_marker=h2s
    )


def scan_alt_compat(y, g, K, prior=(0.0, 0.0), reml=False, ninterval=1):
    """Per-marker exact VC scan reproducing the reference's sqrt-weights
    quirk (reference src/scan.jl:432-440): h2 is fitted properly per model,
    but the final LOD re-evaluates both likelihoods with
    sqrt(makeweights(h2)) passed as the weights — and always ML (the
    re-evaluating wls calls leave reml at its default false)."""
    g = np.asarray(g, dtype=np.float64)
    n, p = g.shape
    y0, X0, lam = rotate(y, g, K, add_intercept=True)
    X0_cov = X0[:, :1]
    fit0 = fit_lmm(y0, X0_cov, lam, prior, reml=reml, ninterval=ninterval)
    sqrtw_null = np.sqrt(make_weights(fit0["h2"], lam))
    ell_null_q = wls(y0, X0_cov, sqrtw_null, prior, reml=False)[2][0]
    lod = np.zeros(p)
    h2s = np.zeros(p)
    for i in range(p):
        X = np.concatenate([X0_cov, X0[:, 1 + i : 2 + i]], axis=1)
        fit1 = fit_lmm(y0, X, lam, prior, reml=reml, ninterval=ninterval)
        sqrtw_alt = np.sqrt(make_weights(fit1["h2"], lam))
        ell_alt_q = wls(y0, X, sqrtw_alt, prior, reml=False)[2][0]
        lod[i] = (ell_alt_q - ell_null_q) / np.log(10.0)
        h2s[i] = fit1["h2"]
    return dict(
        sigma2_e=fit0["sigma2"], h2_null=fit0["h2"], lod=lod, h2_each_marker=h2s
    )
