"""LiteQTL correlation->LOD kernels, re-derived as static-shape GEMMs.

The reference computes, for each trait j with weight vector w_j, the
correlation of every (covariate-residualized, weighted) marker with the
(covariate-residualized, weighted) trait, then maps r -> LOD
(src/bulkscan_helpers.jl:47-64 ``computeR_LMM`` + :22-24 ``r2lod``). To batch
traits with *different* h2, the reference groups traits into h2-bins and runs
one CPU GEMM per bin (src/bulkscan_helpers.jl:271-288) — a dynamic-shape,
cache-locality trick that maps poorly to XLA.

Device reformulation (this module): every per-trait quantity is expressed
through (p x n)(n x m) GEMMs and tiny (c x c) per-trait solves — no batched
(m, n, c) tensors (a (..., 1) trailing axis is a padded, strided layout
that multiplies memory traffic). With weights W[n, j] = w_j[n]:

  t      = C^T (W*Y)                       (c, m)      thin GEMM
  G_j    = C^T diag(w_j) C                 (m, c, c)   c(c+1)/2 thin GEMMs
  alpha  = G_j^{-1} t_j                    (m, c)      batched tiny solve
  nrm2_j = sum_n w y^2 - t_j . alpha_j     (m,)        trait residual norm^2
  B      = X^T (W*Y)                       (p, m)      GEMM
  U_k    = (X*C_k)^T W                     (p, m)      c GEMMs
  D1     = (X*X)^T W                       (p, m)      GEMM
  N      = B - sum_k U_k * alpha_k
  D      = D1 - sum_kl Ginv_kl U_k U_l     (per-marker covariate projection)
  r      = N / sqrt(D * nrm2),   LOD = -(n/2) log10(1 - r^2)

So arbitrary per-trait weights cost (c+2) dense (p x m) GEMMs with static
shapes — exact per-trait h2 (no grid binning), and the same kernel serves
null-exact, null-grid, and the permutation scan. All matmuls run at
``Precision.HIGHEST`` — a GPU's default TF32 matmul loses ~1e-3 in LOD.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from .lod import r2lod
from .smallchol import (
    cancel_keep_mask, decovariate, fwd_subst, pair_indices,
    residual_keep_mask, residual_sq, unrolled_cholesky,
)
from .weights import make_weights


@with_highest_matmul
def _nd_parts_per_trait(
    Y0,
    X0m,
    C0,
    lam,
    h2_per_trait,
    *,
    precision: PrecisionConfig = DEFAULT_PRECISION,
):
    """Shared core: (N, D, nrm2) — the (p, m) partial covariance numerator,
    the (p, m) residualized marker norm^2, and the (m,) residualized trait
    norm^2, all in the weighted (per-trait h2) metric.

    Y0: (n, m) rotated traits; X0m: (n, p) rotated markers; C0: (n, c)
    rotated covariates; lam: (n,) eigenvalues; h2_per_trait: (m,).

    Weight guard mirrors the reference's ``sqrt.(abs.(makeweights(...)))``
    (src/bulkscan_helpers.jl:138) for slightly negative kinship eigenvalues.
    """
    gdt = precision.resolve_gemm()
    sdt = precision.resolve_kernel()
    pgp = precision.gemm_precision
    n, c = C0.shape

    # Elementwise/combining math runs in the kernel dtype; only the big
    # (p x n)(n x m) GEMM operands drop to the gemm dtype. Traits and
    # markers first lose their covariate span at the solve dtype
    # (decovariate): the normal-equations combines (D = D1 - sum Z^2,
    # N = B - sum Z zeta) then cancel only the small weighted remainder,
    # which an f32 kernel dtype (BALANCED) holds to the LOD bar.
    slv = precision.resolve_solve()
    W = jnp.abs(make_weights(h2_per_trait, lam)).T.astype(sdt)  # (n, m)
    C = C0.astype(slv)
    Y = decovariate(Y0.astype(slv), C).astype(sdt)
    X = decovariate(X0m.astype(slv), C).astype(sdt)
    C = C.astype(sdt)

    WY = W * Y  # (n, m)

    # Per-trait covariate Grams via thin (c-row) GEMMs, factored with the
    # shared unrolled Cholesky (ops/smallchol.py) — c is a tiny static int;
    # batched (m, c, c) linalg is a slow path on accelerators.
    t = jnp.matmul(C.T, WY, precision=pgp)  # (c, m)
    pairs = pair_indices(c)
    CC = jnp.stack([C[:, k] * C[:, l] for k, l in pairs], axis=1)  # (n, npair)
    Gv = jnp.matmul(CC.T, W, precision=pgp)  # (npair, m)
    Gd = {kl: Gv[i] for i, kl in enumerate(pairs)}
    Lc = unrolled_cholesky(Gd, c)

    # zeta = L^{-1} t  -> per-trait projection coefficients in the
    # orthonormalized covariate basis (same basis as Q = W^1/2 C L^{-T}).
    zeta = fwd_subst(Lc, [t[k] for k in range(c)], c)  # c x (m,)

    yty = jnp.sum(WY * Y, axis=0)  # (m,)
    nrm2 = residual_sq(yty, zeta)

    # Marker-side GEMMs in the gemm dtype, combined in the solve dtype.
    Xg = X.astype(gdt)
    Wg = W.astype(gdt)
    B = jnp.matmul(Xg.T, WY.astype(gdt), precision=pgp).astype(sdt)  # (p, m)
    U = [
        jnp.matmul((X * C[:, k][:, None]).astype(gdt).T, Wg, precision=pgp).astype(sdt)
        for k in range(c)
    ]  # c x (p, m)
    D1 = jnp.matmul((X * X).astype(gdt).T, Wg, precision=pgp).astype(sdt)  # (p, m)

    # Z = L^{-1} U (broadcast over markers): same orthonormal projection for
    # the marker side; then everything combines elementwise:
    #   N = B - sum_k Z_k zeta_k,  D = D1 - sum_k Z_k^2 (guarded)
    Z = fwd_subst(Lc, U, c)  # c x (p, m); Lc entries broadcast (m,) over rows
    N = B
    for k in range(c):
        N = N - Z[k] * zeta[k][None, :]
    D = residual_sq(D1, Z)

    # zero-information columns contribute r = 0 exactly, not normalized
    # rounding noise (COMPAT.md #15). Both D and nrm2 are normal-equations
    # differences of squares (residual_sq), so the keep test is the
    # linear-in-eps cancel_keep_mask at the eps of the least precise dtype
    # the operands passed through (gemm or kernel).
    eps = max(jnp.finfo(gdt).eps, jnp.finfo(sdt).eps)
    keep = (
        cancel_keep_mask(D, D1, eps=eps)
        * cancel_keep_mask(nrm2, yty, eps=eps)[None, :]
    )
    return N * keep, D, nrm2


def weighted_correlation_per_trait(
    Y0, X0m, C0, lam, h2_per_trait, *,
    precision: PrecisionConfig = DEFAULT_PRECISION,
) -> jnp.ndarray:
    """(p, m) partial correlations with a distinct h2 (weight vector) per
    trait (see :func:`_nd_parts_per_trait` for the kernel derivation)."""
    N, D, nrm2 = _nd_parts_per_trait(
        Y0, X0m, C0, lam, h2_per_trait, precision=precision
    )
    # floor: an ALL-ZERO column has D == 0 exactly (N is already masked to
    # 0 there — the floor keeps the ratio 0/tiny = 0 instead of 0/0 = NaN)
    den = jnp.maximum(D * nrm2[None, :], jnp.finfo(D.dtype).tiny)
    return N / jnp.sqrt(den)


def _effects_from_nd(N, D, nrm2, n, c):
    """beta = N / D; SE from the per-(marker, trait) unbiased residual
    variance (nrm2 - N^2/D) / (n - c - 1) — the convention of
    ``models/scan.py::_effects_from_whitened``."""
    D = jnp.maximum(D, jnp.finfo(D.dtype).tiny)
    beta = N / D
    rss = jnp.maximum(nrm2[None, :] - N * N / D, 0.0)
    dof = max(n - c - 1, 1)
    se = jnp.sqrt(rss / dof / D)
    return beta, se


def lods_and_effects_per_trait(
    Y0, X0m, C0, lam, h2_per_trait, *,
    precision: PrecisionConfig = DEFAULT_PRECISION,
):
    """(lod, beta, se) from ONE parts computation — for streamed engines
    where recomputing the (c+2) GEMMs per block would double the cost."""
    n, c = C0.shape
    N, D, nrm2 = _nd_parts_per_trait(
        Y0, X0m, C0, lam, h2_per_trait, precision=precision
    )
    den = jnp.maximum(D * nrm2[None, :], jnp.finfo(D.dtype).tiny)
    r = N / jnp.sqrt(den)
    lod = r2lod(r, n, fast_log=_fast_log(precision))
    beta, se = _effects_from_nd(N, D, nrm2, n, c)
    return lod, beta, se


@with_highest_matmul
def weighted_correlation_shared(
    Y0,
    X0m,
    C0,
    lam,
    h2: float,
    *,
    precision: PrecisionConfig = DEFAULT_PRECISION,
) -> jnp.ndarray:
    """(p, m) correlations with one shared h2 across all columns of Y0.

    Specialization of the per-trait kernel: markers are residualized and
    normalized once, so the whole scan is a single (p x m) GEMM — the
    reference's ``weighted_liteqtl`` (src/bulkscan_helpers.jl:175-201) and the
    permutation hot path (src/scan.jl:534-543) reduce to this.
    """
    gdt = precision.resolve_gemm()
    sdt = precision.resolve_kernel()
    pgp = precision.gemm_precision

    # Residualization/normalization in the kernel dtype (cancellation-prone);
    # only the final (p x m) correlation GEMM drops to the gemm dtype.
    w = jnp.abs(make_weights(h2, lam))  # (n,)
    s = jnp.sqrt(w).astype(sdt)
    Ct = C0.astype(sdt) * s[:, None]
    q, _ = jnp.linalg.qr(Ct, mode="reduced")  # (n, c)

    def residualize_normalize(M):
        Mw = M.astype(sdt) * s[:, None]
        proj = jnp.matmul(q.T, Mw, precision=pgp)
        Mr = Mw - jnp.matmul(q, proj, precision=pgp)
        # a column collinear with the covariates (monomorphic marker vs
        # the intercept) residualizes to rounding noise; 0/0 would NaN the
        # whole row, and normalizing the noise would fabricate O(1/sqrt(n))
        # correlations — the relative rank mask maps it to r = 0 exactly
        # (ops/smallchol.py::residual_keep_mask; COMPAT.md #15)
        nrm2 = jnp.sum(Mr * Mr, axis=0)
        keep = residual_keep_mask(
            nrm2, jnp.sum(Mw * Mw, axis=0), eps=jnp.finfo(sdt).eps
        )
        return (Mr * keep[None, :]) / jnp.sqrt(
            jnp.maximum(nrm2, jnp.finfo(sdt).tiny)
        )

    X00 = residualize_normalize(X0m).astype(gdt)
    Y00 = residualize_normalize(Y0).astype(gdt)
    return jnp.matmul(X00.T, Y00, precision=pgp).astype(sdt)


def _fast_log(precision) -> bool:
    """Use the accurate-f32 log whenever the pipeline is not f64 end-to-end:
    the accurate-f32 log keeps the (p, m) epilogue in f32 while holding the
    LOD bar (see ops/lod.py::log10_f32_accurate)."""
    return precision.resolve_gemm() == jnp.float32


def lods_per_trait(Y0, X0m, C0, lam, h2_per_trait, *, precision=DEFAULT_PRECISION):
    """(p, m) LOD scores with per-trait h2 — the bulk-scan throughput core."""
    n = Y0.shape[0]
    R = weighted_correlation_per_trait(Y0, X0m, C0, lam, h2_per_trait, precision=precision)
    return r2lod(R, n, fast_log=_fast_log(precision))


def lods_shared(Y0, X0m, C0, lam, h2, *, precision=DEFAULT_PRECISION):
    """(p, m) LOD scores with one shared h2 across traits."""
    n = Y0.shape[0]
    R = weighted_correlation_shared(Y0, X0m, C0, lam, h2, precision=precision)
    return r2lod(R, n, fast_log=_fast_log(precision))
