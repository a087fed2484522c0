"""Weighted least squares with Scaled-Inv-Chi^2 prior regularization.

This is the likelihood evaluator every scan engine reduces to. Formulas match
the reference exactly (src/wls.jl:27-101, "formulas (2) and (3) of Kang
(2008)"):

  sqrtw   = sqrt(w)
  yy, XX  = rows of y, X scaled by sqrtw
  coef    = argmin ||yy - XX b||^2           (QR or normal-equations/Cholesky)
  rss     = ||yy - XX coef||^2
  prior_df = prior_b + 2 if prior_b > 0 else prior_b
  sigma2  = (rss + prior_a*prior_b) / ((n - p*reml) + prior_df)
  ell     = -1/2 [ (n + prior_b) log sigma2 - sum(log w)
                   + (rss + prior_a*prior_b)/sigma2 ]
  reml:  ell += 1/2 [ p log sigma2 - logdet(XX' XX) ]

Everything here is pure-functional jnp, jit/vmap-friendly: ``y`` may be a
single column or a multi-column matrix (the reference's ``wls_multivar``,
src/wls.jl:103-180, is the multi-column case of the same math). No in-place
mutation, no dynamic shapes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..utils.config import with_highest_matmul


class WLSResult(NamedTuple):
    """Estimates from one weighted LS fit.

    b:      (p, q) coefficients (q = number of y columns).
    sigma2: (q,) residual variance per y column.
    ell:    (q,) log-likelihood per y column.
    rss:    (q,) weighted residual sum of squares per y column.
    """

    b: jnp.ndarray
    sigma2: jnp.ndarray
    ell: jnp.ndarray
    rss: jnp.ndarray


def _solve_qr(XX: jnp.ndarray, yy: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Least-squares solve via reduced QR; returns (coef, logdet(XX'XX))."""
    q, r = jnp.linalg.qr(XX, mode="reduced")
    coef = solve_triangular(r, q.T @ yy, lower=False)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.abs(jnp.diagonal(r))))
    return coef, logdet


def _solve_cholesky(XX: jnp.ndarray, yy: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Least-squares solve via normal equations; returns (coef, logdet(XX'XX))."""
    gram = XX.T @ XX
    chol = jnp.linalg.cholesky(gram)
    rhs = XX.T @ yy
    coef = solve_triangular(
        chol.T, solve_triangular(chol, rhs, lower=True), lower=False
    )
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
    return coef, logdet


@with_highest_matmul
def wls(
    y: jnp.ndarray,
    X: jnp.ndarray,
    w: jnp.ndarray,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
    method: str = "qr",
) -> WLSResult:
    """Weighted least squares estimation (single- or multi-column ``y``).

    Args:
      y: (n,) or (n, q) outcomes.
      X: (n, p) design.
      w: (n,) positive weights (inverse-variance).
      prior: (prior_variance a, prior_sample_size b) of the Scaled-Inv-Chi^2
        prior on the residual variance.
      reml: REML (True) or ML (False) variance estimate / likelihood.
      method: "qr" (stable, default) or "cholesky" (normal equations).

    Matches reference ``wls`` / ``wls_multivar`` (src/wls.jl:27-180).
    """
    y = jnp.atleast_2d(y.T).T if y.ndim == 1 else y
    n, p = X.shape
    prior_a, prior_b = prior

    sqrtw = jnp.sqrt(w)
    yy = y * sqrtw[:, None]
    XX = X * sqrtw[:, None]

    if method == "qr":
        coef, logdet = _solve_qr(XX, yy)
    elif method == "cholesky":
        coef, logdet = _solve_cholesky(XX, yy)
    else:
        raise ValueError(f"unknown method {method!r}; use 'qr' or 'cholesky'")

    resid = yy - XX @ coef
    rss0 = jnp.sum(resid * resid, axis=0)

    prior_df = prior_b + 2.0 if prior_b > 0.0 else prior_b
    denom = (n - p if reml else n) + prior_df
    # degenerate traits (rss0 == 0 with a zero prior) floor at dtype tiny so
    # log/likelihood stay finite — mirrors the host fit (ops/hostfit.py)
    sigma2 = jnp.maximum(
        (rss0 + prior_a * prior_b) / denom, jnp.finfo(rss0.dtype).tiny
    )

    sum_log_w = jnp.sum(jnp.log(w))
    ell = -0.5 * (
        (n + prior_b) * jnp.log(sigma2)
        - sum_log_w
        + (rss0 + prior_a * prior_b) / sigma2
    )
    if reml:
        ell = ell + 0.5 * (p * jnp.log(sigma2) - logdet)

    return WLSResult(b=coef, sigma2=sigma2, ell=ell, rss=rss0)


@with_highest_matmul
def wls_ell(
    y: jnp.ndarray,
    X: jnp.ndarray,
    w: jnp.ndarray,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(ell, sigma2) per column of ``y`` — likelihood only, NO linalg
    primitive.

    Uses the projection identity ``rss = ||yy||^2 - ||L^{-1} X^T W y||^2``
    with ``L`` the unrolled Cholesky factor of the weighted Gram
    ``X^T W X`` (the covariate count is tiny and static). This matters
    twice: batched Householder QR inside every vmapped Brent/grid
    likelihood evaluation is a slow path on the exact scan paths, and a
    ``triangular_solve`` with a trait-sharded right-hand side forces an
    all-gather. Same formulas as :func:`wls` (reference src/wls.jl:69-93).
    """
    y = jnp.atleast_2d(y.T).T if y.ndim == 1 else y
    n, p = X.shape
    prior_a, prior_b = prior

    # Weighted Gram + the shared unrolled Cholesky (ops/smallchol.py;
    # p = #covariates is tiny & static): no jnp.linalg primitive at all —
    # batched Householder QR is a slow path that dominated the Brent
    # iterations in the null-exact path.
    from .smallchol import fwd_subst, residual_sq, unrolled_cholesky

    wy = y * w[:, None]
    G = {}
    for k in range(p):
        for l in range(k, p):
            G[(k, l)] = jnp.sum(X[:, k] * X[:, l] * w)
    t = [X[:, k] @ wy for k in range(p)]  # (q,) each

    Lc = unrolled_cholesky(G, p)
    zeta = fwd_subst(Lc, t, p)
    rss0 = residual_sq(jnp.sum(wy * y, axis=0), zeta)

    prior_df = prior_b + 2.0 if prior_b > 0.0 else prior_b
    denom = (n - p if reml else n) + prior_df
    sigma2 = jnp.maximum(
        (rss0 + prior_a * prior_b) / denom, jnp.finfo(rss0.dtype).tiny
    )

    ell = -0.5 * (
        (n + prior_b) * jnp.log(sigma2)
        - jnp.sum(jnp.log(w))
        + (rss0 + prior_a * prior_b) / sigma2
    )
    if reml:
        logdet = 0.0
        for k in range(p):
            logdet = logdet + 2.0 * jnp.log(Lc[(k, k)])
        ell = ell + 0.5 * (p * jnp.log(sigma2) - logdet)
    return ell, sigma2


def wls_multivar(
    Y: jnp.ndarray,
    X: jnp.ndarray,
    w: jnp.ndarray,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
    method: str = "qr",
) -> WLSResult:
    """Multi-trait WLS: one shared design, per-column sigma2/ell.

    Alias of :func:`wls` with matrix ``Y`` — the batched formulation already
    vectorizes over columns (reference src/wls.jl:103-180 loops via
    ``mapslices``; here it is one solve + one GEMM).
    """
    return wls(Y, X, w, prior, reml=reml, method=method)


@with_highest_matmul
def resid(y: jnp.ndarray, X: jnp.ndarray, *, method: str = "qr") -> jnp.ndarray:
    """Residuals of (possibly multi-column) ``y`` after OLS on ``X``.

    Parity: reference ``resid`` (src/wls.jl:221-263).
    """
    y2 = y[:, None] if y.ndim == 1 else y
    if method == "qr":
        q, _ = jnp.linalg.qr(X, mode="reduced")
        out = y2 - q @ (q.T @ y2)
    elif method == "cholesky":
        b = jnp.linalg.solve(X.T @ X, X.T @ y2)
        out = y2 - X @ b
    else:
        raise ValueError(f"unknown method {method!r}")
    return out[:, 0] if y.ndim == 1 else out


@with_highest_matmul
def rss(y: jnp.ndarray, X: jnp.ndarray, *, method: str = "qr") -> jnp.ndarray:
    """Residual sum of squares per column of ``y``.

    Parity: reference ``rss`` (src/wls.jl:191-218).
    """
    r = resid(y, X, method=method)
    r2 = r[:, None] if r.ndim == 1 else r
    return jnp.sum(r2 * r2, axis=0)
