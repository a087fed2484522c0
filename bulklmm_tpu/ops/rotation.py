"""FaST-LMM decorrelation pipeline: rotate / reweight / permute.

Parity: reference src/transform_helpers.jl.

- ``transform_rotation`` (:1-55): eigendecompose (or SVD) the kinship matrix
  once per dataset and rotate traits + design into the basis where errors are
  independent. Split: the O(n^3) symmetric eigendecomposition runs
  **eagerly on the host in float64** (n is small relative to p, m, and the
  host result is backend-independent), while the O(n^2 (p+c+m)) rotation
  GEMMs run on device. The
  rotated arrays then feed the jitted static-shape scan cores.
- ``transform_reweight`` (:57-92): fit the null VC on the covariate block,
  residualize, scale by sqrt-weights, project covariates out of the markers.
- ``transform_permute`` (:94-102): batched permutations of the rotated,
  reweighted, covariate-residualized residuals (iid under the null), with
  JAX's counter-based PRNG instead of MersenneTwister.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from .stats import shuffle_vector
from .weights import make_weights
from .wls import resid


class RotatedData(NamedTuple):
    """Eigen-rotated data: ``y0 = U^T y``, ``X0 = U^T [covar geno]``, and the
    kinship eigenvalues ``lam`` (ascending for decomp_scheme='eigen',
    descending for 'svd' — matching Julia eigen/svd ordering)."""

    y0: jnp.ndarray
    X0: jnp.ndarray
    lam: jnp.ndarray


class KinshipDecomposition(NamedTuple):
    """Cached kinship eigendecomposition, device-resident.

    For repeated scans on one cohort, decompose once with
    :func:`decompose_kinship` and pass this object wherever ``K`` is
    accepted — skips the O(n^3) host eigendecomposition *and* the
    host->device transfer of the n x n eigenvector matrix on every call
    (at n=2000+ those dominate a repeated-scan workflow; the reference
    re-decomposes inside every scan call, src/transform_helpers.jl:21-49).
    """

    Ut: jnp.ndarray  # (n, n) transposed eigenvectors, device
    lam: jnp.ndarray  # (n,) eigenvalues, device
    # untruncated float64 LAPACK outputs (host numpy), kept so the
    # backend-deterministic host null fit never consumes f32-rounded
    # factors upcast back to f64; None when constructed by hand
    Ut_host: "np.ndarray | None" = None
    lam_host: "np.ndarray | None" = None


def decompose_kinship(
    K, decomp_scheme: str = "eigen", dtype=None
) -> KinshipDecomposition:
    """Host eigendecomposition -> device-resident factors, computed once
    (the float64 host factors ride along for the host null fit)."""
    Ut_np, lam_np = kinship_eigen(K, decomp_scheme)
    if dtype is None:
        dtype = DEFAULT_PRECISION.resolve_solve()
    return KinshipDecomposition(
        Ut=jnp.asarray(Ut_np, dtype=dtype),
        lam=jnp.asarray(lam_np, dtype=dtype),
        Ut_host=Ut_np,
        lam_host=lam_np,
    )


def resolve_kinship(K, decomp_scheme: str, dtype) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(Ut, lam) device arrays from either a raw kinship matrix or a cached
    :class:`KinshipDecomposition`."""
    if isinstance(K, KinshipDecomposition):
        return K.Ut.astype(dtype), K.lam.astype(dtype)
    Ut_np, lam_np = kinship_eigen(K, decomp_scheme)
    return jnp.asarray(Ut_np, dtype=dtype), jnp.asarray(lam_np, dtype=dtype)


def resolve_kinship_with_host(K, decomp_scheme: str, dtype):
    """Like :func:`resolve_kinship`, but also returns host float64 copies
    ``(Ut, lam, Ut_host, lam_host)`` — the host pair feeds the
    backend-deterministic null fit (ops/hostfit.py)."""
    if isinstance(K, KinshipDecomposition):
        # prefer the untruncated f64 LAPACK factors; a hand-built
        # decomposition without them falls back to upcasting the device
        # copies (f32-rounded when x64 is off — backend-deterministic but
        # not bit-identical to a raw-K call)
        Ut_h = (
            K.Ut_host if K.Ut_host is not None
            else np.asarray(K.Ut, dtype=np.float64)
        )
        lam_h = (
            K.lam_host if K.lam_host is not None
            else np.asarray(K.lam, dtype=np.float64)
        )
        return K.Ut.astype(dtype), K.lam.astype(dtype), Ut_h, lam_h
    Ut_h, lam_h = kinship_eigen(K, decomp_scheme)
    return jnp.asarray(Ut_h, dtype=dtype), jnp.asarray(lam_h, dtype=dtype), Ut_h, lam_h


def kinship_eigen(K, decomp_scheme: str = "eigen") -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (float64 LAPACK) decomposition of the kinship matrix.

    Returns ``(Ut, lam)`` with rows of ``Ut`` the eigenvectors. Warns (not
    errors) on eigenvalues below -1e-7, like the reference
    (src/transform_helpers.jl:27-30).
    """
    K64 = np.asarray(K, dtype=np.float64)
    if decomp_scheme == "eigen":
        lam, U = np.linalg.eigh(K64)
        Ut = U.T
    elif decomp_scheme == "svd":
        _, lam, Vt = np.linalg.svd(K64)
        Ut = Vt
    else:
        raise ValueError("decomp_scheme must be 'eigen' or 'svd'")
    if np.any(lam < -1e-7):
        warnings.warn(
            "Negative eigenvalues exist. The kinship matrix supplied may not be SPD."
        )
    return Ut, lam


def transform_rotation(
    y,
    g,
    K,
    *,
    add_intercept: bool = True,
    decomp_scheme: str = "eigen",
    precision: PrecisionConfig = DEFAULT_PRECISION,
) -> RotatedData:
    """Rotate traits and design into the kinship eigenbasis.

    ``y``: (n,) or (n, m) traits; ``g``: (n, p) design (covariates already
    prepended by the caller, or just markers when ``add_intercept=True``).
    """
    y = jnp.asarray(y)
    y2 = y[:, None] if y.ndim == 1 else y
    g = jnp.asarray(g)
    n = y2.shape[0]
    K_n = K.Ut.shape[0] if isinstance(K, KinshipDecomposition) else np.shape(K)[0]
    if g.shape[0] != n or K_n != n:
        raise ValueError("Dimension mismatch.")

    if add_intercept:
        X = jnp.concatenate([jnp.ones((n, 1), dtype=g.dtype), g], axis=1)
    else:
        X = g

    dtype = precision.resolve_solve()
    Ut, lam = resolve_kinship(K, decomp_scheme, dtype)

    pgp = precision.gemm_precision
    y0 = jnp.matmul(Ut, y2.astype(dtype), precision=pgp)
    X0 = jnp.matmul(Ut, X.astype(dtype), precision=pgp)
    return RotatedData(y0=y0, X0=X0, lam=lam)


class ReweightedData(NamedTuple):
    r0: jnp.ndarray  # (n, 1) weighted null residuals
    X00: jnp.ndarray  # (n, p) weighted markers with covariates projected out
    sigma2_e: jnp.ndarray
    h2_null: jnp.ndarray


@with_highest_matmul
def transform_reweight(
    y0,
    X0,
    lam,
    *,
    n_covars: int = 1,
    prior_a: float = 0.0,
    prior_b: float = 0.0,
    reml: bool = False,
    method: str = "qr",
    optim_interval: int = 1,
) -> ReweightedData:
    """Null-model fit -> residualize -> sqrt-weight -> project out covariates.

    Parity: reference transform_reweight (src/transform_helpers.jl:57-92).
    """
    from .lmm import fit_lmm  # local import to avoid cycle

    if y0.ndim == 2 and y0.shape[1] != 1:
        # the null h2 fit below is single-trait; silently reweighting m
        # traits at trait 0's h2 would corrupt every other trait
        raise ValueError(
            "transform_reweight is single-trait (the null h2 fit applies "
            f"to one trait); got {y0.shape[1]} trait columns. Reweight one "
            "column at a time, or use bulkscan/bulkscan_perms."
        )
    X0_cov = X0[:, :n_covars]
    vc = fit_lmm(
        y0, X0_cov, lam, (prior_a, prior_b),
        reml=reml, method=method, optim_interval=optim_interval,
    )
    r0 = y0 - X0_cov @ vc.b
    # abs guard mirrors the reference's sqrt.(abs.(makeweights(...))) for
    # slightly negative kinship eigenvalues (src/bulkscan_helpers.jl:138)
    sqrtw = jnp.sqrt(jnp.abs(make_weights(vc.h2, lam)))
    w_r0 = r0 * sqrtw[:, None]
    w_X0 = X0 * sqrtw[:, None]
    X00 = resid(w_X0[:, n_covars:], w_X0[:, :n_covars], method=method)
    return ReweightedData(r0=w_r0, X00=X00, sigma2_e=vc.sigma2, h2_null=vc.h2)


def transform_permute(r0, *, nperms: int = 1024, rndseed: int = 0, original: bool = True):
    """Batched permutations of the (iid-under-null) weighted residuals.

    Column 0 is the unpermuted vector when ``original=True``. Deterministic
    under ``rndseed`` (JAX threefry; not bit-identical to the reference's
    MersenneTwister — parity is distributional).
    Parity: reference transform_permute (src/transform_helpers.jl:94-102).
    """
    if nperms < 0 or (nperms == 0 and not original):
        raise ValueError(
            "The required number of permutations must be a positive integer "
            "(nperms=0 is allowed only with original=True)."
        )
    key = jax.random.PRNGKey(rndseed)
    col = r0[:, 0] if r0.ndim == 2 else r0
    return shuffle_vector(key, col, nperms, original=original)
