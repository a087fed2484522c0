"""Low-rank kinship engine: LMM scans without the n x n eigendecomposition.

The full-rank engines (ops/rotation.py + ops/liteqtl.py) decompose K on the
HOST (float64 LAPACK ``eigh``, O(n^3)) and upload the (n, n) eigenvector
matrix — at cohort scale (n >= 20k) that wall-clock wall (minutes of host
eigh, GBs of upload) dominates everything (SURVEY.md "hard parts"). This
module replaces the full decomposition with the top-k eigenpairs
``K ~= U diag(lam) U^T`` and evaluates the LMM *exactly for that rank-k
kinship* via the Woodbury-style identity (all quantities unrotated):

    (delta K + I)^{-1} = I + U diag(w - 1) U^T,   w_i = 1/(delta lam_i + 1)
    log|delta K + I|   = -sum_i log w_i

so every quadratic form the WLS/likelihood needs is a *base* (unweighted)
term plus a k-dimensional correction:

    a' (delta K + I)^{-1} b = a'b + (U'a)' diag(w - 1) (U'b)

This is a pure-GEMM reformulation of the per-trait correlation
kernel (ops/liteqtl.py): the h2-independent base Grams (X'Y, X'C, ...) are
computed ONCE, and the per-trait-weight corrections become (p, k)(k, m)
GEMMs with the per-trait weight factors folded elementwise into the
(k, m) projection — the same static-GEMM trick the full-rank kernel uses,
but with k in place of n. For k << n the scan is cheaper than full rank
AND the O(n^3) host eigh + (n, n) upload disappear entirely.

Top-k eigenpairs come from device-side randomized subspace iteration
(GEMM-only; Halko, Martinsson & Tropp 2011): panel orthonormalization by
CholeskyQR2 (Gram + small host Cholesky — tall-skinny Householder QR is
a slow path on accelerators), and one small host eigh of the (l, l)
projected matrix.
``kinship_lowrank_from_geno`` never materializes K at all — its matvec
applies the reference kinship definition (reference src/kinship.jl:4-13:
K = 2 X X'/p + 0.5 with unit diagonal) implicitly from the genotype
matrix, so n x n never exists anywhere.

Truncation semantics: results are the exact LMM for the truncated kinship
``U diag(lam) U'``; the deviation from the full-K LMM is controlled by the
discarded tail (weights differ by O(delta * lam_{k+1})).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from .lod import r2lod
from .smallchol import (
    cancel_keep_mask, fwd_subst, pair_indices, residual_keep_mask,
    residual_sq, unrolled_cholesky,
)

_LN10 = math.log(10.0)


class LowRankKinship(NamedTuple):
    """Top-k eigenpairs of a kinship matrix: ``K ~= U diag(lam) U^T``.

    U: (n, k) orthonormal columns; lam: (k,) nonnegative, descending.
    """

    U: jnp.ndarray
    lam: jnp.ndarray

    @property
    def n(self) -> int:
        return self.U.shape[0]

    @property
    def rank(self) -> int:
        return self.U.shape[1]


def _correction_weights(h2, lam):
    """(w - 1) correction factors: ``w_i = 1/(delta lam_i + 1)`` with the
    same h2 -> 1 clamp as the full-rank path — exactly
    :func:`ops.weights.make_weights` minus one (single home for the
    h2 -> weight convention and the delta clamp)."""
    from .weights import make_weights

    return make_weights(h2, lam) - 1.0


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def _cholqr2(Y, gemm_precision):
    """Orthonormalize the columns of a tall-skinny panel by CholeskyQR2.

    Two rounds of: (n, l) Gram on DEVICE -> tiny (l, l) float64 Cholesky +
    inverse on the HOST -> one device GEMM-apply ``Y @ inv(L)^T``. Only
    plain GEMMs run on device (tall-skinny Householder QR and large-RHS
    triangular solves are accelerator slow paths, and a monolithic jitted
    chol/solve pipeline measured minutes of compile); the host factors cost
    microseconds and one small fetch each.
    """
    l = Y.shape[1]
    eps = float(jnp.finfo(Y.dtype).eps)  # Gram accuracy is the COMPUTE dtype's
    for _ in range(2):
        G = np.asarray(
            jnp.matmul(Y.T, Y, precision=gemm_precision), dtype=np.float64
        )
        # jitter relative to the compute dtype: the Gram squares the panel's
        # condition number, and a spectrally-concentrated operator collapses
        # the panel toward its dominant eigenspace between orthonormalizations
        jitter = 100.0 * eps * (np.trace(G) / l)
        try:
            L = np.linalg.cholesky(G + jitter * np.eye(l))
            apply = np.linalg.inv(L).T
        except np.linalg.LinAlgError:
            # numerically semidefinite panel: eigh-based whitening
            # (Y V w^{-1/2} has orthonormal columns; floored eigenvalues
            # re-randomize the collapsed directions on the next matvec)
            w, V = np.linalg.eigh(0.5 * (G + G.T))
            w = np.maximum(w, eps * max(w.max(), 1.0))
            apply = V * (1.0 / np.sqrt(w))[None, :]
        Y = jnp.matmul(Y, jnp.asarray(apply, dtype=Y.dtype),
                       precision=gemm_precision)
    return Y


def _randomized_eigh(matvec, n, k, *, oversample, iters, seed, dtype, gemm_precision):
    """Top-k eigenpairs of an implicit symmetric PSD operator via subspace
    iteration (Halko et al. 2011). ``matvec`` maps (n, l) -> (n, l) on
    device; all heavy work is eager device GEMMs, the host handles only
    (l, l)-scale factorizations."""
    l = min(n, k + oversample)
    key = jax.random.PRNGKey(seed)
    Q = _cholqr2(jax.random.normal(key, (n, l), dtype=dtype), gemm_precision)
    for _ in range(iters):
        Q = _cholqr2(matvec(Q), gemm_precision)
    B = np.asarray(jnp.matmul(Q.T, matvec(Q), precision=gemm_precision), np.float64)
    B = 0.5 * (B + B.T)
    evals, evecs = np.linalg.eigh(B)  # (l, l) host eigh — small
    order = np.argsort(evals)[::-1][:k]
    lam = np.maximum(evals[order], 0.0)
    U = jnp.matmul(Q, jnp.asarray(evecs[:, order], dtype=dtype),
                   precision=gemm_precision)
    return LowRankKinship(U=U, lam=jnp.asarray(lam, dtype=dtype))


def kinship_lowrank(
    K,
    k: int,
    *,
    oversample: int = 10,
    iters: int = 4,
    seed: int = 0,
    precision: PrecisionConfig = DEFAULT_PRECISION,
) -> LowRankKinship:
    """Top-k eigenpairs of an explicit (n, n) kinship via device-side
    randomized subspace iteration — O(n^2 k) GEMMs instead of the host's
    O(n^3) eigh, no (n, n) eigenvector upload."""
    dtype = precision.resolve_solve()
    Kd = jnp.asarray(K, dtype=dtype)

    def matvec(Q):
        # HIGH (TF32 on a GPU) for range finding — self-correcting across
        # iterations; the final Rayleigh quotient runs at gemm_precision
        return jnp.matmul(Kd, Q, precision=jax.lax.Precision.HIGH)

    return _randomized_eigh(
        matvec, Kd.shape[0], k, oversample=oversample, iters=iters, seed=seed,
        dtype=dtype, gemm_precision=precision.gemm_precision,
    )


def kinship_lowrank_from_geno(
    geno,
    k: int,
    *,
    oversample: int = 10,
    iters: int = 4,
    seed: int = 0,
    precision: PrecisionConfig = DEFAULT_PRECISION,
) -> LowRankKinship:
    """Top-k eigenpairs of ``calc_kinship(geno)`` WITHOUT materializing the
    (n, n) kinship: the matvec applies the reference definition
    (2 X X'/p + 0.5, unit diagonal; reference src/kinship.jl:4-13) as
    genotype GEMMs + a rank-1 + diagonal term. Use when n^2 itself is the
    memory wall (n ~ 10^5)."""
    dtype = precision.resolve_solve()
    Gd = jnp.asarray(geno, dtype=dtype)
    n, p = Gd.shape
    # The -0.5 shift is folded in algebraically (X = G - 0.5 J is a rank-1
    # update), so the shifted (n, p) matrix is never materialized — at
    # cohort scale that is a full second copy of the genotype panel.
    # Subspace GEMMs run at Precision.HIGH: range-finding is
    # self-correcting across iterations, and a multi-pass HIGHEST
    # lowering's extra operand copies of the genotype panel can be the
    # difference between fitting in memory and OOM; the final Rayleigh
    # quotient and eigenvector assembly in
    # _randomized_eigh stay at the configured (HIGHEST) precision.
    iter_prec = jax.lax.Precision.HIGH
    xx = jax.jit(lambda A: jnp.sum((A - 0.5) ** 2, axis=1))(Gd)  # fused, no copy
    dfix = 1.0 - (2.0 * xx / p + 0.5)  # K_ii = 1 replaces 2|x_i|^2/p + 0.5

    def matvec(Q):
        csum = jnp.sum(Q, axis=0, keepdims=True)  # (1, l)
        XtQ = jnp.matmul(Gd.T, Q, precision=iter_prec) - 0.5 * csum  # (p, l)
        XXtQ = (
            jnp.matmul(Gd, XtQ, precision=iter_prec)
            - 0.5 * jnp.sum(XtQ, axis=0, keepdims=True)
        )
        return (2.0 / p) * XXtQ + 0.5 * csum + dfix[:, None] * Q

    return _randomized_eigh(
        matvec, n, k, oversample=oversample, iters=iters, seed=seed,
        dtype=dtype, gemm_precision=precision.gemm_precision,
    )


def kinship_lowrank_exact(K, k: int, *, dtype=None) -> LowRankKinship:
    """Top-k eigenpairs by host float64 eigh (exact; for tests and modest n)."""
    lam_all, U_all = np.linalg.eigh(np.asarray(K, dtype=np.float64))
    order = np.argsort(lam_all)[::-1][:k]
    dt = dtype if dtype is not None else jnp.asarray(K).dtype
    return LowRankKinship(
        U=jnp.asarray(U_all[:, order], dtype=dt),
        lam=jnp.asarray(np.maximum(lam_all[order], 0.0), dtype=dt),
    )


# ---------------------------------------------------------------------------
# likelihood grid + per-trait correlation kernel
# ---------------------------------------------------------------------------


def _wquad(base, corr):
    """Clamp a Woodbury-form quadratic total ``base + corr`` at zero.

    Every such total (``yWy = yty + sum(dm1 Q^2)``, marker norms
    ``dXX + sum(dm1 P^2)``, Gram diagonals) is a w-weighted squared norm —
    nonnegative in exact arithmetic — but the DIFFERENCE form can round
    negative in f32 for vectors (nearly) in span(U) as h2 -> 1 (dm1 -> -1).
    A negative total defeats ``residual_sq``'s relative floor: sigma2
    floors at dtype-tiny, the log-likelihood explodes to ~+1e35, and the
    h2 optimization locks onto the garbage probe (or the Cholesky of a
    negative diagonal goes NaN). The clamp restores the full-rank engine's
    structural nonnegativity (its totals are sums of w * x^2 >= 0)."""
    return jnp.maximum(base + corr, 0.0)


def _null_ell_sigma2_one(CtC, R, lam, CtY_j, Q_j, yty_j, h2, prior, *, n,
                         reml):
    """Null (ell, sigma2) of ONE trait at one h2 from the k-dim
    projections — the shared scalar core of :func:`null_sigma2_lowrank`
    and :func:`fit_h2_lowrank` (batched analog: :func:`null_ell_lowrank`)."""
    c = CtC.shape[0]
    dm1 = _correction_weights(h2, lam)  # (k,)
    Qd = dm1 * Q_j
    yWy = _wquad(yty_j, jnp.sum(Q_j * Qd))
    t = CtY_j + jnp.matmul(R.T, Qd)  # (c,)
    G = {}
    for a in range(c):
        for b in range(a, c):
            G[(a, b)] = CtC[a, b] + jnp.sum(R[:, a] * R[:, b] * dm1)
        G[(a, a)] = _wquad(G[(a, a)], 0.0)
    Lc = unrolled_cholesky(G, c)
    zeta = fwd_subst(Lc, [t[a] for a in range(c)], c)
    rss0 = residual_sq(yWy, zeta)
    logw_sum = jnp.sum(jnp.log1p(dm1))
    return _ell_from_parts(rss0, logw_sum, Lc, n, c, prior, reml)


def _ell_from_parts(rss0, logw_sum, Lc, n, c, prior, reml):
    """Same (RE)ML formulas as ops/wls.py::wls_ell, with sum(log w) supplied
    directly (= -log|delta K + I|, the complement directions contribute 0)."""
    prior_a, prior_b = prior
    prior_df = prior_b + 2.0 if prior_b > 0.0 else prior_b
    denom = (n - c if reml else n) + prior_df
    # same degenerate-trait floor as ops/wls.py / ops/hostfit.py
    sigma2 = jnp.maximum(
        (rss0 + prior_a * prior_b) / denom, jnp.finfo(rss0.dtype).tiny
    )
    ell = -0.5 * (
        (n + prior_b) * jnp.log(sigma2) - logw_sum + (rss0 + prior_a * prior_b) / sigma2
    )
    if reml:
        logdet = 2.0 * sum(jnp.log(jnp.abs(Lc[(i, i)])) for i in range(c))
        ell = ell + 0.5 * (c * jnp.log(sigma2) - logdet)
    return ell, sigma2


def null_ell_lowrank(parts, lam, h2, prior, *, n, reml=False):
    """(m,) null log-likelihoods of every trait at ONE h2, from precomputed
    base Grams + k-dim projections (see :func:`_base_parts`)."""
    CtC, CtY, yty, R, Q = (
        parts["CtC"], parts["CtY"], parts["yty"], parts["R"], parts["Q"]
    )
    c = CtC.shape[0]
    dm1 = _correction_weights(h2, lam)  # (k,)
    Qd = dm1[:, None] * Q  # (k, m)
    yWy = _wquad(yty, jnp.sum(Q * Qd, axis=0))
    t = CtY + jnp.matmul(R.T, Qd)  # (c, m)
    G = {}
    for a in range(c):
        for b in range(a, c):
            G[(a, b)] = CtC[a, b] + jnp.sum(R[:, a] * R[:, b] * dm1)
        G[(a, a)] = jnp.maximum(G[(a, a)], 0.0)
    Lc = unrolled_cholesky(G, c)
    zeta = fwd_subst(Lc, [t[a] for a in range(c)], c)
    rss0 = residual_sq(yWy, zeta)
    logw_sum = jnp.sum(jnp.log1p(dm1))
    ell, _ = _ell_from_parts(rss0, logw_sum, Lc, n, c, prior, reml)
    return ell


def grid_null_ell_lowrank(parts, lam, h2_grid, prior, *, n, reml=False):
    """(g, m) null log-likelihoods over the h2 grid (one vmapped batch)."""
    return jax.vmap(
        lambda h2: null_ell_lowrank(parts, lam, h2, prior, n=n, reml=reml)
    )(h2_grid)


def null_sigma2_lowrank(parts, lam, h2_list, prior, *, n, reml=False):
    """(m,) null-model ``sigma2_e`` of every trait at its OWN h2 (the
    per-trait analog of :func:`null_ell_lowrank`, vmapped over the
    (trait, h2) pairs)."""
    CtC, R = parts["CtC"], parts["R"]

    def one(CtY_j, Q_j, yty_j, h2_j):
        return _null_ell_sigma2_one(
            CtC, R, lam, CtY_j, Q_j, yty_j, h2_j, prior, n=n, reml=reml
        )[1]

    return jax.vmap(one, in_axes=(1, 1, 0, 0))(
        parts["CtY"], parts["Q"], parts["yty"], h2_list
    )


def fit_h2_lowrank(parts, lam, prior, *, n, reml=False, optim_interval=1):
    """(m,) per-trait exact-Brent null h2 on the rank-k likelihood.

    The full-rank null-exact engine vmaps Brent over traits on the ROTATED
    data (models/bulkscan.py::_null_exact_impl); here each likelihood
    evaluation is O(k + c^2) scalar work from the shared projections, so
    every Brent iteration advances all m trait optimizations in one device
    step with no (n,)-scale traffic at all.
    """
    from .brent import gridbrent

    CtC, R = parts["CtC"], parts["R"]

    def fit_one(CtY_j, Q_j, yty_j):
        def neg_ell(h2):
            return -_null_ell_sigma2_one(
                CtC, R, lam, CtY_j, Q_j, yty_j, h2, prior, n=n, reml=reml
            )[0]

        _, h2 = gridbrent(neg_ell, 0.0, 1.0, optim_interval, dtype=lam.dtype)
        return h2

    return jax.vmap(fit_one, in_axes=(1, 1, 0))(
        parts["CtY"], parts["Q"], parts["yty"]
    )


def _marker_side_parts(Xm, C, lr, *, gemm_dtype, kernel_dtype, gemm_precision):
    """Marker-dependent Grams and k-dim projections (per marker block)."""
    gd, sd, pgp = gemm_dtype, kernel_dtype, gemm_precision
    X, Cg, U = Xm.astype(gd), C.astype(gd), lr.U.astype(gd)
    return dict(
        XtC=jnp.matmul(X.T, Cg, precision=pgp).astype(sd),   # (p, c)
        dXX=jnp.sum((X * X).astype(sd), axis=0),             # (p,)
        P=jnp.matmul(U.T, X, precision=pgp).astype(sd),      # (k, p)
    )


def _shared_parts(C, lr, *, gemm_dtype, kernel_dtype, gemm_precision):
    """Covariate-only Grams/projections (marker- and trait-independent)."""
    gd, sd, pgp = gemm_dtype, kernel_dtype, gemm_precision
    Cg, U = C.astype(gd), lr.U.astype(gd)
    return dict(
        R=jnp.matmul(U.T, Cg, precision=pgp).astype(sd),     # (k, c)
        CtC=jnp.matmul(Cg.T, Cg, precision=pgp).astype(sd),  # (c, c)
    )


def _marker_parts(Xm, C, lr, *, gemm_dtype, kernel_dtype, gemm_precision):
    """Trait-independent Grams and k-dim projections (computed once per
    scan, shared by every trait chunk)."""
    kw = dict(gemm_dtype=gemm_dtype, kernel_dtype=kernel_dtype,
              gemm_precision=gemm_precision)
    return {**_marker_side_parts(Xm, C, lr, **kw), **_shared_parts(C, lr, **kw)}


def _trait_side_parts(Y, C, lr, *, gemm_dtype, kernel_dtype, gemm_precision):
    """Trait-dependent, marker-independent Grams and k-dim projections."""
    gd, sd, pgp = gemm_dtype, kernel_dtype, gemm_precision
    Yg, Cg, U = Y.astype(gd), C.astype(gd), lr.U.astype(gd)
    return dict(
        Q=jnp.matmul(U.T, Yg, precision=pgp).astype(sd),     # (k, m)
        CtY=jnp.matmul(Cg.T, Yg, precision=pgp).astype(sd),  # (c, m)
        yty=jnp.sum((Yg * Yg).astype(sd), axis=0),           # (m,)
    )


def _trait_parts(Y, Xm, C, lr, *, gemm_dtype, kernel_dtype, gemm_precision):
    """Per-trait(-chunk) Grams and k-dim projections."""
    gd, sd, pgp = gemm_dtype, kernel_dtype, gemm_precision
    kw = dict(gemm_dtype=gemm_dtype, kernel_dtype=kernel_dtype,
              gemm_precision=gemm_precision)
    X, Yg = Xm.astype(gd), Y.astype(gd)
    return dict(
        XtY=jnp.matmul(X.T, Yg, precision=pgp).astype(sd),   # (p, m)
        **_trait_side_parts(Y, C, lr, **kw),
    )


def _base_parts(Y, Xm, C, lr, *, gemm_dtype, kernel_dtype, gemm_precision):
    """h2-independent Grams and k-dim projections (each computed once)."""
    kw = dict(gemm_dtype=gemm_dtype, kernel_dtype=kernel_dtype,
              gemm_precision=gemm_precision)
    return {**_marker_parts(Xm, C, lr, **kw), **_trait_parts(Y, Xm, C, lr, **kw)}


def _nd_parts_lowrank(
    parts, lam, h2_per_trait, *, precision: PrecisionConfig = DEFAULT_PRECISION
):
    """Shared rank-k core: (N, D, nrm2) in the per-trait weighted metric —
    same quantities as ops/liteqtl.py::_nd_parts_per_trait with rank-k
    Woodbury corrections in place of rotation.
    """
    pgp = precision.gemm_precision
    P, Q, R = parts["P"], parts["Q"], parts["R"]
    c = parts["CtC"].shape[0]

    Dm1 = _correction_weights(h2_per_trait, lam).T  # (k, m)
    Qd = Dm1 * Q  # (k, m)

    # trait-side scalars (Woodbury totals clamped nonnegative, see _wquad)
    yWy = _wquad(parts["yty"], jnp.sum(Q * Qd, axis=0))  # (m,)
    t = parts["CtY"] + jnp.matmul(R.T, Qd, precision=pgp)  # (c, m)
    pairs = pair_indices(c)
    RR = jnp.stack([R[:, a] * R[:, b] for a, b in pairs], axis=1)  # (k, npair)
    Gv = jnp.matmul(RR.T, Dm1, precision=pgp)  # (npair, m)
    Gd = {
        ab: (
            _wquad(parts["CtC"][ab[0], ab[1]], Gv[i])
            if ab[0] == ab[1]
            else parts["CtC"][ab[0], ab[1]] + Gv[i]
        )
        for i, ab in enumerate(pairs)
    }
    Lc = unrolled_cholesky(Gd, c)
    zeta = fwd_subst(Lc, [t[a] for a in range(c)], c)
    nrm2 = residual_sq(yWy, zeta)

    # marker-side (p, m) terms: base + rank-k correction GEMMs
    B = parts["XtY"] + jnp.matmul(P.T, Qd, precision=pgp)  # (p, m)
    Uc = [
        parts["XtC"][:, a][:, None]
        + jnp.matmul(P.T, Dm1 * R[:, a][:, None], precision=pgp)
        for a in range(c)
    ]  # c x (p, m)
    D1 = _wquad(
        parts["dXX"][:, None], jnp.matmul((P * P).T, Dm1, precision=pgp)
    )  # (p, m)

    Z = fwd_subst(Lc, Uc, c)
    N = B
    for a in range(c):
        N = N - Z[a] * zeta[a][None, :]
    D = residual_sq(D1, Z)
    # zero-information columns contribute r = 0 exactly, not normalized
    # rounding noise (COMPAT.md #15). D and nrm2 are differences of squares
    # (residual_sq) -> linear-in-eps cancel_keep_mask at the eps of the
    # least precise dtype the operands passed through.
    eps = max(
        jnp.finfo(precision.resolve_gemm()).eps,
        jnp.finfo(precision.resolve_kernel()).eps,
    )
    keep = (
        cancel_keep_mask(D, D1, eps=eps)
        * cancel_keep_mask(nrm2, yWy, eps=eps)[None, :]
    )
    return N * keep, D, nrm2


def lods_per_trait_lowrank(
    parts, lam, h2_per_trait, n, *, precision: PrecisionConfig = DEFAULT_PRECISION
):
    """(p, m) LOD matrix with a distinct h2 per trait, rank-k weights.

    Identical epilogue to ops/liteqtl.py::weighted_correlation_per_trait
    (unrolled Cholesky + forward substitution + residual floors); the
    h2-dependent terms are (p, k)(k, m) GEMMs with the per-trait weight
    corrections folded elementwise into the (k, m) projections.
    """
    from .liteqtl import _fast_log

    N, D, nrm2 = _nd_parts_lowrank(parts, lam, h2_per_trait, precision=precision)
    den = jnp.maximum(D * nrm2[None, :], jnp.finfo(D.dtype).tiny)
    r = N / jnp.sqrt(den)
    return r2lod(r, n, fast_log=_fast_log(precision))


def lods_shared_lowrank(
    parts, lam, h2, n, *, precision: PrecisionConfig = DEFAULT_PRECISION
):
    """(p, m) LOD matrix at ONE shared h2, rank-k weights.

    The shared-h2 specialization of :func:`lods_per_trait_lowrank` for the
    alt-grid loop (the full-rank analog: ops/liteqtl.py's shared-weight
    kernel used by models/bulkscan.py::_alt_grid_impl): with one h2 the
    marker-side covariate projections ``Uc``, marker norms ``D1``, and the
    covariate Gram are trait-independent — (p,) vectors and scalars
    instead of (p, m) panels — cutting (c + 1) of the (p, k)(k, m)
    correction GEMMs per grid step down to matvecs.
    """
    from .liteqtl import _fast_log

    pgp = precision.gemm_precision
    P, Q, R = parts["P"], parts["Q"], parts["R"]
    c = parts["CtC"].shape[0]

    dm1 = _correction_weights(h2, lam)  # (k,)
    Qd = dm1[:, None] * Q  # (k, m)

    # trait-side scalars
    yWy = _wquad(parts["yty"], jnp.sum(Q * Qd, axis=0))  # (m,)
    t = parts["CtY"] + jnp.matmul(R.T, Qd, precision=pgp)  # (c, m)
    G = {}
    for a in range(c):
        for b in range(a, c):
            G[(a, b)] = parts["CtC"][a, b] + jnp.sum(R[:, a] * R[:, b] * dm1)
        G[(a, a)] = jnp.maximum(G[(a, a)], 0.0)
    Lc = unrolled_cholesky(G, c)
    zeta = fwd_subst(Lc, [t[a] for a in range(c)], c)
    nrm2 = residual_sq(yWy, zeta)

    # marker-side terms: (p,) vectors — h2-shared, trait-independent
    B = parts["XtY"] + jnp.matmul(P.T, Qd, precision=pgp)  # (p, m)
    Uc = [
        parts["XtC"][:, a] + jnp.matmul(P.T, dm1 * R[:, a], precision=pgp)
        for a in range(c)
    ]  # c x (p,)
    D1 = _wquad(
        parts["dXX"], jnp.matmul((P * P).T, dm1, precision=pgp)
    )  # (p,)

    Z = fwd_subst(Lc, Uc, c)
    N = B
    for a in range(c):
        N = N - Z[a][:, None] * zeta[a][None, :]
    D = residual_sq(D1, Z)
    eps = max(
        jnp.finfo(precision.resolve_gemm()).eps,
        jnp.finfo(precision.resolve_kernel()).eps,
    )
    keep = (
        cancel_keep_mask(D, D1, eps=eps)[:, None]
        * cancel_keep_mask(nrm2, yWy, eps=eps)[None, :]
    )
    den = jnp.maximum(D[:, None] * nrm2[None, :], jnp.finfo(D.dtype).tiny)
    r = (N * keep) / jnp.sqrt(den)
    return r2lod(r, n, fast_log=_fast_log(precision))


def lods_and_effects_lowrank(
    parts, lam, h2_per_trait, n, *, precision: PrecisionConfig = DEFAULT_PRECISION
):
    """(lod, beta, se) from ONE rank-k parts computation (streamed blocks)."""
    from .liteqtl import _effects_from_nd, _fast_log

    c = parts["CtC"].shape[0]
    N, D, nrm2 = _nd_parts_lowrank(parts, lam, h2_per_trait, precision=precision)
    den = jnp.maximum(D * nrm2[None, :], jnp.finfo(D.dtype).tiny)
    r = N / jnp.sqrt(den)
    lod = r2lod(r, n, fast_log=_fast_log(precision))
    beta, se = _effects_from_nd(N, D, nrm2, n, c)
    return lod, beta, se


def _alt_grid_lowrank(parts, lam, h2_grid, prior, *, n, precision, reml=False):
    """Grid-approximated Exact-LMM on the rank-k kinship: running elementwise
    max of the per-(marker, trait) alt log-likelihood over the h2 grid.

    Same scan structure as the full-rank XLA engine
    (models/bulkscan.py::_alt_grid_impl, reference src/bulkscan.jl:428-527)
    with the rank-k correlation kernel in place of the rotated one: at each
    grid step the shared-h2 LOD comes from :func:`lods_per_trait_lowrank`
    (logL1 = lod*ln10 + ell0), the null ell from :func:`null_ell_lowrank`.
    """
    p = parts["P"].shape[1]
    m = parts["Q"].shape[1]
    dt = parts["Q"].dtype
    g = h2_grid.shape[0]
    idx_dt = jnp.int8 if g <= 127 else jnp.int32

    def step(carry, inputs):
        k, h2 = inputs
        logL1_max, kmax, logL0_max = carry
        lod_k = lods_shared_lowrank(parts, lam, h2, n, precision=precision)
        ell0 = null_ell_lowrank(parts, lam, h2, prior, n=n, reml=reml)
        logL1 = lod_k * _LN10 + ell0[None, :]
        upd = logL1 > logL1_max
        return (
            jnp.where(upd, logL1, logL1_max),
            jnp.where(upd, k, kmax),
            jnp.maximum(logL0_max, ell0),
        ), None

    init = (
        jnp.full((p, m), -jnp.inf, dtype=dt),
        jnp.zeros((p, m), dtype=idx_dt),
        jnp.full((m,), -jnp.inf, dtype=dt),
    )
    ks = jnp.arange(g, dtype=idx_dt)
    (logL1_max, kmax, logL0_max), _ = jax.lax.scan(step, init, (ks, h2_grid))
    L = (logL1_max - logL0_max[None, :]) / _LN10
    return L, h2_grid[kmax]


def scan_alt_h2_ells_lowrank(parts, lam, prior, *, n, reml=False,
                             optim_interval=1, ml_ells=False):
    """Per-marker exact-Brent alt fit on the rank-k likelihood (one trait).

    The full-rank alt engine vmaps Brent over markers on rotated data
    (models/scan.py::_scan_alt_impl, reference src/scan.jl:428-443); here the
    marker column joins the design through the shared projections — each
    likelihood evaluation builds the (c+1)-dim Gram from base + rank-k
    corrections in O(k c) scalar work, no (n,)-scale traffic per iteration.
    Returns ``(ells, h2s)``, each (p,).
    """
    from .brent import gridbrent

    CtC, R, Q = parts["CtC"], parts["R"], parts["Q"]
    CtY, yty = parts["CtY"], parts["yty"]
    Q1, CtY1, yty1 = Q[:, 0], CtY[:, 0], yty[0]

    def fit_marker(XtC_j, P_j, dXX_j, XtY_j):
        def neg_ell(h2):
            return -_aug_ell_lowrank(
                CtC, R, lam, Q1, CtY1, yty1, XtC_j, P_j, dXX_j, XtY_j, h2,
                prior, n=n, reml=reml,
            )

        fmin, h2 = gridbrent(neg_ell, 0.0, 1.0, optim_interval,
                             dtype=lam.dtype)
        if ml_ells:
            # REML log-likelihoods are not comparable across designs with
            # different fixed effects: for LOD formation, re-evaluate with
            # ML at the (REML-)fitted h2 (reference src/wls.jl:29 default)
            return _aug_ell_lowrank(
                CtC, R, lam, Q1, CtY1, yty1, XtC_j, P_j, dXX_j, XtY_j, h2,
                prior, n=n, reml=False,
            ), h2
        return -fmin, h2

    return jax.vmap(fit_marker, in_axes=(0, 1, 0, 0))(
        parts["XtC"], parts["P"], parts["dXX"], parts["XtY"][:, 0]
    )


def effects_alt_per_marker_lowrank(parts, lam, h2s, n):
    """(beta, se) with each marker's own fitted h2, rank-k weights.

    Marker-axis analog of the per-trait Woodbury split: every w-weighted
    inner product is its base Gram plus a rank-k correction through the
    shared projections, with ``dm1`` varying per MARKER — elementwise ops
    + tiny GEMMs + the unrolled Cholesky, no per-marker whitening GEMMs
    and no vmapped (n, c) QRs (a batched slow path).
    """
    CtC, R, P = parts["CtC"], parts["R"], parts["P"]
    Q1, CtY1, yty1 = parts["Q"][:, 0], parts["CtY"][:, 0], parts["yty"][0]
    c = CtC.shape[0]

    Dm1 = _correction_weights(h2s, lam).T  # (k, p): marker j's corrections
    pairs = pair_indices(c)
    RR = jnp.stack([R[:, a] * R[:, b] for a, b in pairs], axis=1)  # (k, npair)
    Gv = jnp.matmul(RR.T, Dm1)  # (npair, p)
    Gd = {
        ab: (
            _wquad(CtC[ab[0], ab[1]], Gv[i]) if ab[0] == ab[1]
            else CtC[ab[0], ab[1]] + Gv[i]
        )
        for i, ab in enumerate(pairs)
    }
    Lc = unrolled_cholesky(Gd, c)

    RQ = R * Q1[:, None]  # (k, c)
    t = CtY1[:, None] + jnp.matmul(RQ.T, Dm1)  # (c, p)
    zeta = fwd_subst(Lc, [t[a] for a in range(c)], c)
    yWy = _wquad(yty1, jnp.matmul(Q1 * Q1, Dm1))  # (p,)
    ny2 = residual_sq(yWy, zeta)

    xWx = _wquad(parts["dXX"], jnp.sum(P * P * Dm1, axis=0))  # (p,)
    xWy = parts["XtY"][:, 0] + jnp.sum(P * Dm1 * Q1[:, None], axis=0)
    xWC = [
        parts["XtC"][:, a] + jnp.sum(P * Dm1 * R[:, a][:, None], axis=0)
        for a in range(c)
    ]
    Z = fwd_subst(Lc, xWC, c)
    nx2 = jnp.maximum(residual_sq(xWx, Z), jnp.finfo(yWy.dtype).tiny)
    cov = xWy
    for a in range(c):
        cov = cov - Z[a] * zeta[a]
    beta = cov / nx2
    rss = jnp.maximum(ny2 - cov * cov / nx2, 0.0)
    dof = max(n - c - 1, 1)
    se = jnp.sqrt(rss / dof / nx2)
    return beta, se


def _aug_ell_lowrank(CtC, R, lam, Q1, CtY1, yty1, XtC_j, P_j, dXX_j, XtY_j,
                     h2, prior, *, n, reml):
    """Alt-model log-likelihood of ONE (trait, marker) at one h2: the
    marker column joins the design through the shared k-dim projections —
    the (c+1)-dim augmented-Gram core shared by
    :func:`scan_alt_h2_ells_lowrank` and the rank-k profile-likelihood."""
    c = CtC.shape[0]
    dm1 = _correction_weights(h2, lam)  # (k,)
    Qd = dm1 * Q1
    yWy = _wquad(yty1, jnp.sum(Q1 * Qd))
    G = {}
    for a in range(c):
        for b in range(a, c):
            G[(a, b)] = CtC[a, b] + jnp.sum(R[:, a] * R[:, b] * dm1)
        G[(a, a)] = jnp.maximum(G[(a, a)], 0.0)
    for a in range(c):
        G[(a, c)] = XtC_j[a] + jnp.sum(P_j * dm1 * R[:, a])
    G[(c, c)] = _wquad(dXX_j, jnp.sum(P_j * P_j * dm1))
    t = [CtY1[a] + jnp.sum(R[:, a] * Qd) for a in range(c)]
    t.append(XtY_j + jnp.sum(P_j * Qd))
    Lc = unrolled_cholesky(G, c + 1)
    zeta = fwd_subst(Lc, t, c + 1)
    rss = residual_sq(yWy, zeta)
    logw_sum = jnp.sum(jnp.log1p(dm1))
    ell, _ = _ell_from_parts(rss, logw_sum, Lc, n, c + 1, prior, reml)
    return ell


def whiten_lowrank(A, U, lam, h2, *, gemm_precision=jax.lax.Precision.HIGHEST):
    """Apply ``Sigma^{-1/2}`` for ``Sigma = delta K_k + I`` (up to the global
    ``1/sqrt(1-h2)`` scale, which cancels in correlations).

    With the rank-k spectral form, ``Sigma^{-1/2} = I + U diag(sqrt(w)-1) U'``
    where ``w_i = 1/(delta lam_i + 1)`` — two (n, k) GEMMs per operand. This
    is the unrotated equivalent of the full-rank path's sqrt-weight scaling
    after rotation (models/scan.py::_scan_perms_impl).
    """
    s = jnp.sqrt(1.0 + _correction_weights(h2, lam)) - 1.0  # (k,)
    UtA = jnp.matmul(U.T, A, precision=gemm_precision)
    return A + jnp.matmul(U, s[:, None] * UtA, precision=gemm_precision)


def scan_perms_lowrank_kernel(
    y, Xm, C, U, lam, b, h2, *, nperms, rndseed, method, precision, n
):
    """Permutation LOD matrix (p, 1 + nperms) on the rank-k kinship.

    Whitens the null residual, covariates, and markers explicitly with the
    rank-k ``Sigma^{-1/2}`` (entries of the whitened residual are
    exchangeable under the null — the unrotated analog of permuting the
    rotated-and-reweighted residual, reference src/transform_helpers.jl:57-102),
    then runs the same residualize-normalize-correlate kernel as the
    full-rank permutation engine.
    """
    from .liteqtl import _fast_log
    from .rotation import transform_permute
    from .wls import resid

    r0 = y - jnp.matmul(C, b)  # (n, 1)
    pgp = precision.gemm_precision
    w_r0 = whiten_lowrank(r0, U, lam, h2, gemm_precision=pgp)
    Cw = whiten_lowrank(C, U, lam, h2, gemm_precision=pgp)
    Xw = whiten_lowrank(Xm, U, lam, h2, gemm_precision=pgp)
    X00 = resid(Xw, Cw, method=method)

    r0perm = transform_permute(w_r0, nperms=nperms, rndseed=rndseed, original=True)
    # collinear-with-covariates columns (and fully-explained traits)
    # residualize to rounding noise: the relative rank mask maps them to
    # r = 0 exactly instead of normalizing the noise (ops/smallchol.py,
    # COMPAT.md #15); the tiny floor still guards 0/0
    yw = whiten_lowrank(y, U, lam, h2, gemm_precision=pgp)
    tiny = jnp.finfo(X00.dtype).tiny
    norm_y = jnp.sqrt(jnp.maximum(jnp.sum(r0perm * r0perm, axis=0), tiny))
    norm_x = jnp.sqrt(jnp.maximum(jnp.sum(X00 * X00, axis=0), tiny))
    keps = jnp.finfo(precision.resolve_kernel()).eps
    keep_x = residual_keep_mask(
        jnp.sum(X00 * X00, axis=0), jnp.sum(Xw * Xw, axis=0), eps=keps
    )
    keep_y = residual_keep_mask(
        jnp.sum(w_r0 * w_r0), jnp.sum(yw * yw), eps=keps
    )
    r0n = (r0perm * keep_y) / norm_y
    X00n = (X00 * keep_x[None, :]) / norm_x
    gdt = precision.resolve_gemm()
    L = jnp.matmul(X00n.T.astype(gdt), r0n.astype(gdt), precision=pgp)
    return r2lod(L, n, fast_log=_fast_log(precision))


_STATIC_LR = ("prior", "reml", "precision")


@partial(jax.jit, static_argnames=_STATIC_LR + ("n", "trait_chunk", "method",
                                                "optim_interval", "effects"))
@with_highest_matmul
def _bulkscan_lowrank_core(
    Y, Xm, C, U, lam, h2_grid, *, n, prior, reml, precision, trait_chunk=None,
    method="null-grid", optim_interval=1, effects=False,
):
    lr = LowRankKinship(U=U, lam=lam)
    kdt = precision.resolve_kernel()
    kw = dict(
        gemm_dtype=precision.resolve_gemm(), kernel_dtype=kdt,
        gemm_precision=precision.gemm_precision,
    )
    # marker-side parts once — shared across trait chunks
    mparts = _marker_parts(Xm, C, lr, **kw)
    lam_k = lam.astype(kdt)

    def impl(Yc):
        parts = {**mparts, **_trait_parts(Yc, Xm, C, lr, **kw)}
        if method == "alt-grid":
            return _alt_grid_lowrank(
                parts, lam_k, h2_grid.astype(kdt), prior,
                n=n, precision=precision, reml=reml,
            )
        if method == "null-exact":
            h2_list = fit_h2_lowrank(
                parts, lam_k, prior,
                n=n, reml=reml, optim_interval=optim_interval,
            )
        else:  # null-grid
            ells = grid_null_ell_lowrank(
                parts, lam_k, h2_grid.astype(kdt), prior, n=n, reml=reml
            )
            idx = jnp.argmax(ells, axis=0)  # first max wins, like Julia findmax
            h2_list = h2_grid[idx]
        if effects:
            # one parts pass serves LODs AND the GLS effects
            L, beta, se = lods_and_effects_lowrank(
                parts, lam_k, h2_list.astype(kdt), n, precision=precision
            )
            return L, h2_list, beta, se
        L = lods_per_trait_lowrank(
            parts, lam_k, h2_list.astype(kdt), n, precision=precision
        )
        return L, h2_list

    if trait_chunk is None:
        return impl(Y)
    from ..models.bulkscan import _chunk_traits

    return _chunk_traits(impl, Y, trait_chunk=trait_chunk)


# ---------------------------------------------------------------------------
# single-trait cores (models/scan.py dispatches here for LowRankKinship)
# ---------------------------------------------------------------------------


def _parts_kwargs(precision):
    return dict(
        gemm_dtype=precision.resolve_gemm(),
        kernel_dtype=precision.resolve_kernel(),
        gemm_precision=precision.gemm_precision,
    )


@partial(jax.jit, static_argnames=("precision",))
@with_highest_matmul
def _trait_projections_lowrank(y, C, U, lam, *, precision):
    """(k,)/(c,)-scale projections of one trait for the host null fit."""
    kw = _parts_kwargs(precision)
    gd, sd, pgp = kw["gemm_dtype"], kw["kernel_dtype"], kw["gemm_precision"]
    Yg, Cg, Ug = y.astype(gd), C.astype(gd), U.astype(gd)
    return dict(
        CtC=jnp.matmul(Cg.T, Cg, precision=pgp).astype(sd),
        CtY=jnp.matmul(Cg.T, Yg, precision=pgp)[:, 0].astype(sd),
        yty=jnp.sum((Yg * Yg).astype(sd)),
        R=jnp.matmul(Ug.T, Cg, precision=pgp).astype(sd),
        Q=jnp.matmul(Ug.T, Yg, precision=pgp)[:, 0].astype(sd),
    )


@partial(jax.jit, static_argnames=_STATIC_LR + ("n", "effects"))
@with_highest_matmul
def _scan_null_lowrank_core(
    y, Xm, C, U, lam, h2, *, n, prior, reml, precision, effects=False
):
    lr = LowRankKinship(U=U, lam=lam)
    kdt = precision.resolve_kernel()
    parts = _base_parts(y, Xm, C, lr, **_parts_kwargs(precision))
    if effects:
        # one parts pass serves the LODs AND the GLS effects
        L, beta, se = lods_and_effects_lowrank(
            parts, lam.astype(kdt), h2[None].astype(kdt), n, precision=precision
        )
        return L[:, 0], beta[:, 0], se[:, 0]
    L = lods_per_trait_lowrank(
        parts, lam.astype(kdt), h2[None].astype(kdt), n, precision=precision
    )
    return (L[:, 0],)


@partial(jax.jit, static_argnames=_STATIC_LR + ("n", "optim_interval",
                                                 "effects"))
@with_highest_matmul
def _scan_alt_lowrank_core(
    y, Xm, C, U, lam, h2_null, *, n, prior, reml, optim_interval, precision,
    effects=False,
):
    """(ells, h2s, ell0[, beta, se]): per-marker alt fits (+ optional GLS
    effects from the SAME parts pass — recomputing the O(n k p) base
    projections for an effects-enabled alt scan would double the GEMM
    work). Under REML, the LOD-forming likelihoods (alt AND null) are
    re-evaluated with ML at the fitted h2s — REML log-likelihoods are not
    comparable across different fixed-effect designs; under ML the caller
    uses the host fit's null ell, so ell0 is only computed when needed."""
    lr = LowRankKinship(U=U, lam=lam)
    kdt = precision.resolve_kernel()
    parts = _base_parts(y, Xm, C, lr, **_parts_kwargs(precision))
    lam_k = lam.astype(kdt)
    ells, h2s = scan_alt_h2_ells_lowrank(
        parts, lam_k, prior,
        n=n, reml=reml, optim_interval=optim_interval, ml_ells=reml,
    )
    ell0 = (
        null_ell_lowrank(parts, lam_k, h2_null, prior, n=n, reml=False)[0]
        if reml else jnp.zeros((), dtype=ells.dtype)
    )
    if effects:
        beta, se = effects_alt_per_marker_lowrank(parts, lam_k, h2s, n)
        return ells, h2s, ell0, beta, se
    return ells, h2s, ell0


_STATIC_LR_PERMS = ("nperms", "rndseed", "method", "precision", "n")


@partial(jax.jit, static_argnames=_STATIC_LR_PERMS)
@with_highest_matmul
def _scan_perms_lowrank_core(
    y, Xm, C, U, lam, b, h2, *, nperms, rndseed, method, precision, n
):
    return scan_perms_lowrank_kernel(
        y, Xm, C, U, lam, b, h2,
        nperms=nperms, rndseed=rndseed, method=method,
        precision=precision, n=n,
    )


@partial(jax.jit, static_argnames=_STATIC_LR + ("n",))
@with_highest_matmul
def _profile_ll_lowrank_core(
    y, Xm, C, U, lam, h2_grid, marker_id, *, n, prior, reml, precision
):
    """(ll_list_null, ll_list_alt) over the h2 grid for one marker —
    the rank-k counterpart of analysis/profile_ll.py."""
    lr = LowRankKinship(U=U, lam=lam)
    kdt = precision.resolve_kernel()
    # profile ONE marker: slice its column before the marker-side
    # projections — computing (k, p)/(p, c) GEMMs over the whole panel to
    # index out one row would cost a full scan's projections
    Xm_j = jax.lax.dynamic_slice_in_dim(Xm, marker_id, 1, axis=1)
    parts = _base_parts(y, Xm_j, C, lr, **_parts_kwargs(precision))
    lam_k = lam.astype(kdt)
    CtC, R = parts["CtC"], parts["R"]
    Q1, CtY1, yty1 = parts["Q"][:, 0], parts["CtY"][:, 0], parts["yty"][0]
    XtC_j = parts["XtC"][0]
    P_j = parts["P"][:, 0]
    dXX_j = parts["dXX"][0]
    XtY_j = parts["XtY"][0, 0]

    def ell_alt(h2):
        return _aug_ell_lowrank(
            CtC, R, lam_k, Q1, CtY1, yty1, XtC_j, P_j, dXX_j, XtY_j, h2,
            prior, n=n, reml=reml,
        )

    hk = h2_grid.astype(kdt)
    ll_null = grid_null_ell_lowrank(parts, lam_k, hk, prior, n=n, reml=reml)[:, 0]
    ll_alt = jax.vmap(ell_alt)(hk)
    return ll_null, ll_alt
