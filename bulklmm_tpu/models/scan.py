"""Single-trait genome scan: null / alt VC assumptions + permutation testing.

Parity: reference ``scan`` and its engines (src/scan.jl:94-557), re-built
for an accelerator:

- the eigendecomposition runs eagerly on the host once per dataset;
- each engine's hot path is one jitted, static-shape core;
- ``scan_null``'s per-marker RSS swap loop (src/scan.jl:344-351) is replaced
  by the exact Frisch-Waugh correlation identity — one (p x 1) GEMM
  (the reference's own tests prove the two agree to 1e-7,
  test/bulkscan_test.jl:60-80);
- ``scan_alt``'s per-marker Brent loop (src/scan.jl:428-443) becomes a
  ``vmap`` over markers: every Brent iteration updates all p optimizations in
  one device step.

Documented divergence from the reference: ``scan_alt`` in the reference
passes sqrt-weights where weights are expected (src/scan.jl:434-439, an
effective double square root). We evaluate the likelihood-ratio with the
correctly-scaled weights; LODs differ from the reference's alt path by a
small amount on the paths affected by the quirk.

Alt-path LODs under ``reml=True`` are likelihood ratios of ML likelihoods
at the REML-fitted h2s (REML log-likelihoods are not comparable across
designs with different fixed effects) — matching the reference, whose
re-evaluating ``wls`` calls always use ML (src/wls.jl:29 default).
"""

from __future__ import annotations

import math
from functools import partial
import jax
import jax.numpy as jnp
import numpy as np

from ..ops.liteqtl import lods_shared
from ..ops.lmm import fit_lmm
from ..ops.lod import lod2log10p, r2lod
from ..ops.rotation import resolve_kinship_with_host, transform_permute
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from .results import ScanResult

_LN10 = math.log(10.0)


@partial(jax.jit, static_argnames=("c",))
def _unpack_fit_vec(packed, c):
    """One dispatch turning the packed ``[b (c,), sigma2, h2, ell]`` device
    vector into its four views (rank-k scan path; see _host_null_fit)."""
    return packed[:c][:, None], packed[c], packed[c + 1], packed[c + 2]


def _coerce_null_fit(null_fit, c):
    """Accept a precomputed null fit in either form: an LMMResult, or the
    packed ``[b (c,), sigma2, h2, ell]`` device vector from
    :func:`_host_null_fit` (unpacked here at trace time — the slices fuse
    into the surrounding jitted program at zero dispatch cost)."""
    from ..ops.lmm import LMMResult

    if null_fit is None or isinstance(null_fit, LMMResult):
        return null_fit
    return LMMResult(
        b=null_fit[:c][:, None],
        sigma2=null_fit[c],
        h2=null_fit[c + 1],
        ell=null_fit[c + 2],
    )


def _scan_null_impl(
    y0, X0m, C0, lam, null_fit=None, *, prior, reml, method, optim_interval, precision
):
    """Covariates (C0) and markers (X0m) stay separate arrays end-to-end:
    slicing them out of one concatenated design would cross shard boundaries
    under marker sharding and force an all-gather.

    ``null_fit``: precomputed null-model LMMResult (host float64 fit,
    ops/hostfit.py) — backend-deterministic h2; ``None`` falls back to the
    on-device Brent fit (used by the sharded perm engine, where inputs are
    already device-resident).
    """
    null_fit = _coerce_null_fit(null_fit, C0.shape[1])
    vc = null_fit if null_fit is not None else fit_lmm(
        y0, C0, lam, prior,
        reml=reml, method=method, optim_interval=optim_interval,
    )
    lod = lods_shared(y0, X0m, C0, lam, vc.h2, precision=precision)[:, 0]
    return vc.sigma2, vc.h2, lod


def _scan_alt_impl(
    y0, X0m, C0, lam, null_fit=None, *, prior, reml, method, optim_interval, precision,
    compat_sqrt_weights=False,
):
    null_fit = _coerce_null_fit(null_fit, C0.shape[1])
    out00 = null_fit if null_fit is not None else fit_lmm(
        y0, C0, lam, prior,
        reml=reml, method=method, optim_interval=optim_interval,
    )

    def fit_one(x_col):
        X = jnp.concatenate([C0, x_col[:, None]], axis=1)
        out11 = fit_lmm(
            y0, X, lam, prior,
            reml=reml, method=method, optim_interval=optim_interval,
        )
        return out11.ell, out11.h2

    ells, h2s = jax.vmap(fit_one, in_axes=1)(X0m)

    if compat_sqrt_weights:
        # Reference-compat mode: reproduce the reference's sqrt-weights quirk
        # exactly (src/scan.jl:432-440) — after fitting h2 properly, both
        # likelihoods are RE-evaluated with sqrt(makeweights(h2, lam)) passed
        # where weights are expected (an effective double square root), and
        # always with ML (the re-evaluating `wls` calls omit the reml kwarg,
        # whose default is false, src/wls.jl:29).
        from ..ops.weights import make_weights
        from ..ops.wls import wls_ell

        ell_null_q = wls_ell(
            y0, C0, jnp.sqrt(make_weights(out00.h2, lam)), prior, reml=False
        )[0][0]

        def ell_alt_one(x_col, h2_i):
            X = jnp.concatenate([C0, x_col[:, None]], axis=1)
            w = jnp.sqrt(make_weights(h2_i, lam))
            return wls_ell(y0, X, w, prior, reml=False)[0][0]

        ells_q = jax.vmap(ell_alt_one, in_axes=(1, 0))(X0m, h2s)
        lod = (ells_q - ell_null_q) / _LN10
    elif reml:
        # REML log-likelihoods are NOT comparable across designs with
        # different fixed effects (the +0.5(c log sigma2 - logdet X'WX)
        # term does not cancel between [C] and [C x]); like the reference
        # (whose re-evaluating wls calls always use ML, src/wls.jl:29),
        # the LOD is formed from ML likelihoods at the REML-fitted h2s.
        from ..ops.weights import make_weights
        from ..ops.wls import wls_ell

        ell_null_ml = wls_ell(
            y0, C0, make_weights(out00.h2, lam), prior, reml=False
        )[0][0]

        def ell_alt_ml(x_col, h2_i):
            X = jnp.concatenate([C0, x_col[:, None]], axis=1)
            return wls_ell(
                y0, X, make_weights(h2_i, lam), prior, reml=False
            )[0][0]

        ells_ml = jax.vmap(ell_alt_ml, in_axes=(1, 0))(X0m, h2s)
        lod = (ells_ml - ell_null_ml) / _LN10
    else:
        lod = (ells - out00.ell) / _LN10
    # a marker collinear with the covariates adds no information: its
    # augmented design is rank-deficient, and the clamped Gram Cholesky
    # inside the per-marker fit returns a slightly PERTURBED likelihood
    # (measured: LOD noise ~ +-0.1) — mask such markers to LOD = 0 exactly.
    # Collinearity is h2-independent (x in span(C) iff W^(1/2)x in
    # span(W^(1/2)C)), so one unweighted test covers every fitted h2
    # (ops/smallchol.py::residual_keep_mask, COMPAT.md #15).
    from ..ops.smallchol import residual_keep_mask
    from ..ops.wls import resid

    Xr = resid(X0m, C0, method=method)
    keep = residual_keep_mask(
        jnp.sum(Xr * Xr, axis=0), jnp.sum(X0m * X0m, axis=0)
    )
    # where (not multiply): 0 * NaN = NaN would leak a non-finite fitted
    # value through the mask instead of the intended exact 0
    lod = jnp.where(keep > 0, lod, 0.0)
    return out00.sigma2, out00.h2, h2s, lod


def _scan_perms_impl(
    y0, X0m, C0, lam, null_fit=None, *,
    prior, reml, method, optim_interval, nperms, rndseed, precision
):
    # transform_reweight with the design kept split (covariates vs markers):
    # fit the null VC on C0, residualize, sqrt-reweight, project C0 out of
    # the markers (reference src/transform_helpers.jl:57-92).
    from ..ops.weights import make_weights
    from ..ops.wls import resid

    null_fit = _coerce_null_fit(null_fit, C0.shape[1])
    vc = null_fit if null_fit is not None else fit_lmm(
        y0, C0, lam, prior,
        reml=reml, method=method, optim_interval=optim_interval,
    )
    r0 = y0 - C0 @ vc.b
    # abs guard mirrors the reference's sqrt.(abs.(makeweights(...))) for
    # slightly negative kinship eigenvalues (src/bulkscan_helpers.jl:138)
    sqrtw = jnp.sqrt(jnp.abs(make_weights(vc.h2, lam)))
    w_r0 = r0 * sqrtw[:, None]
    Xw = X0m * sqrtw[:, None]
    X00 = resid(Xw, C0 * sqrtw[:, None], method=method)

    r0perm = transform_permute(w_r0, nperms=nperms, rndseed=rndseed, original=True)

    # a marker collinear with the covariates (or a trait fully explained
    # by them) residualizes to rounding noise — 0/0 would NaN a whole row
    # of L_perms, and normalizing the noise would fabricate O(1/sqrt(n))
    # correlations in the max-over-markers thresholds; the relative rank
    # mask maps both to r = 0 exactly (ops/smallchol.py, COMPAT.md #15)
    from ..ops.smallchol import residual_keep_mask

    tiny = jnp.finfo(X00.dtype).tiny
    norm_y = jnp.sqrt(jnp.maximum(jnp.sum(r0perm * r0perm, axis=0), tiny))
    norm_x = jnp.sqrt(jnp.maximum(jnp.sum(X00 * X00, axis=0), tiny))
    keep_x = residual_keep_mask(
        jnp.sum(X00 * X00, axis=0), jnp.sum(Xw * Xw, axis=0)
    )
    keep_y = residual_keep_mask(
        jnp.sum(w_r0 * w_r0), jnp.sum((y0 * sqrtw[:, None]) ** 2)
    )
    r0n = (r0perm * keep_y) / norm_y
    X00n = (X00 * keep_x[None, :]) / norm_x

    from ..ops.liteqtl import _fast_log

    gdt = precision.resolve_gemm()
    L = jnp.matmul(
        X00n.T.astype(gdt), r0n.astype(gdt), precision=precision.gemm_precision
    )
    L = r2lod(L, y0.shape[0], fast_log=_fast_log(precision))
    return vc.sigma2, vc.h2, L


_STATIC = ("prior", "reml", "method", "optim_interval", "precision")
_STATIC_PERMS = _STATIC + ("nperms", "rndseed")
_STATIC_ALT = _STATIC + ("compat_sqrt_weights",)

# jitted cores over pre-rotated data (the permutation core is reused by
# bulklmm_tpu.parallel with sharded inputs)
_scan_null_core = partial(jax.jit, static_argnames=_STATIC)(
    with_highest_matmul(_scan_null_impl)
)
_scan_alt_core = partial(jax.jit, static_argnames=_STATIC_ALT)(
    with_highest_matmul(_scan_alt_impl)
)
_scan_perms_core = partial(jax.jit, static_argnames=_STATIC_PERMS)(
    with_highest_matmul(_scan_perms_impl)
)


def _effects_null_rotated(y0, X0m, C0, lam, h2, method):
    """Effects under one shared h2, from ALREADY-ROTATED operands (reuses the
    scan pipeline's rotation GEMMs). abs guard as in ops/liteqtl.py:73."""
    from ..ops.weights import make_weights

    sw = jnp.sqrt(jnp.abs(make_weights(h2, lam)))[:, None]
    return _effects_from_whitened(y0 * sw, X0m * sw, C0 * sw, method=method)


def _effects_alt_rotated(y0, X0m, C0, lam, h2s, method):
    """Effects with each marker's own fitted h2, from already-rotated
    operands.

    Per-marker weights make this the marker-axis analog of the
    per-trait-weight kernel: every Frisch-Waugh quantity is a w-weighted
    Gram built by elementwise ops + tiny GEMMs and solved with the
    unrolled Cholesky (ops/smallchol.py) — a vmapped per-marker QR here
    would be 2p batched (n, c) Householder factorizations, the batched
    slow path the unrolled route exists to avoid.
    """
    from ..ops.smallchol import (
        fwd_subst, pair_indices, residual_sq, unrolled_cholesky,
    )
    from ..ops.weights import make_weights

    n, c = C0.shape
    W = jnp.abs(make_weights(h2s, lam)).T  # (n, p): marker j's weights
    y = y0[:, 0]  # (n,)

    pairs = pair_indices(c)
    CC = jnp.stack([C0[:, a] * C0[:, b] for a, b in pairs], axis=1)  # (n, npair)
    Gv = jnp.matmul(CC.T, W)  # (npair, p)
    Lc = unrolled_cholesky({ab: Gv[i] for i, ab in enumerate(pairs)}, c)

    Cy = C0 * y[:, None]  # (n, c)
    t = jnp.matmul(Cy.T, W)  # (c, p): C^T W y per marker
    zeta = fwd_subst(Lc, [t[a] for a in range(c)], c)
    yWy = jnp.matmul(y * y, W)  # (p,)
    ny2 = residual_sq(yWy, zeta)

    XW = X0m * W  # (n, p): marker column pre-weighted
    xWx = jnp.sum(X0m * XW, axis=0)  # (p,)
    xWy = jnp.sum(XW * y[:, None], axis=0)  # (p,)
    xWC = [jnp.sum(XW * C0[:, a][:, None], axis=0) for a in range(c)]
    Z = fwd_subst(Lc, xWC, c)
    nx2 = residual_sq(xWx, Z)
    nx2 = jnp.maximum(nx2, jnp.finfo(y0.dtype).tiny)
    cov = xWy
    for a in range(c):
        cov = cov - Z[a] * zeta[a]
    beta = cov / nx2
    rss = jnp.maximum(ny2 - cov * cov / nx2, 0.0)
    dof = max(n - c - 1, 1)
    se = jnp.sqrt(rss / dof / nx2)
    return beta, se


@partial(jax.jit, static_argnames=("n", "c"))
@with_highest_matmul
def _rotate3_packed(packed, Xm, *, n, c):
    """Eigen-rotate with ALL small operands arriving as ONE packed vector
    ``[Ut (n*n,), lam (n,), y (n,), C (n*c,)]`` — the raw-K single-trait
    path's eigenvectors/eigenvalues/trait/covariates ride a single
    host->device transfer instead of four (each tiny transfer pays its own
    dispatch-issue latency; see _host_null_fit)."""
    Ut = packed[: n * n].reshape(n, n)
    lam = packed[n * n : n * n + n]
    y = packed[n * n + n : n * n + 2 * n][:, None]
    C = packed[n * n + 2 * n :].reshape(n, c)
    return jnp.matmul(Ut, y), jnp.matmul(Ut, Xm), jnp.matmul(Ut, C), lam, Ut


@jax.jit
@with_highest_matmul
def _rotate3(Ut, y, Xm, C):
    """Eigen-rotate (y, markers, covariates) in one device program.

    Dispatched ASYNC before the host-f64 null fit in :func:`scan` /
    :func:`scan_perms_lite`: the device rotates while the host runs its
    Brent — the two
    are independent until the scan kernel needs h2, so the host fit costs
    ~zero wall time instead of serializing in front of the dispatch."""
    return jnp.matmul(Ut, y), jnp.matmul(Ut, Xm), jnp.matmul(Ut, C)


@partial(jax.jit, static_argnames=_STATIC + ("output_effects",))
@with_highest_matmul
def _scan_null_pipeline(y0, X0m, C0, lam, null_fit=None, *,
                        output_effects=False, **kw):
    """Null scan (+ optional GLS effects) on pre-rotated operands — the
    effects reuse the same rotated operands instead of paying the dominant
    O(n^2 p) rotation a second time."""
    sigma2, h2, lod = _scan_null_impl(y0, X0m, C0, lam, null_fit, **kw)
    if not output_effects:
        return sigma2, h2, lod, None, None
    beta, se = _effects_null_rotated(y0, X0m, C0, lam, h2, kw["method"])
    return sigma2, h2, lod, beta, se


@partial(jax.jit, static_argnames=_STATIC_ALT + ("output_effects",))
@with_highest_matmul
def _scan_alt_pipeline(y0, X0m, C0, lam, null_fit=None, *,
                       output_effects=False, **kw):
    sigma2, h2, h2s, lod = _scan_alt_impl(y0, X0m, C0, lam, null_fit, **kw)
    if not output_effects:
        return sigma2, h2, h2s, lod, None, None
    beta, se = _effects_alt_rotated(y0, X0m, C0, lam, h2s, kw["method"])
    return sigma2, h2, h2s, lod, beta, se


@partial(jax.jit, static_argnames=_STATIC_PERMS + ("output_effects",))
@with_highest_matmul
def _scan_perms_pipeline(y0, X0m, C0, lam, null_fit=None, *,
                         output_effects=False, **kw):
    sigma2, h2, L = _scan_perms_impl(y0, X0m, C0, lam, null_fit, **kw)
    if not output_effects:
        return sigma2, h2, L, None, None
    beta, se = _effects_null_rotated(y0, X0m, C0, lam, h2, kw["method"])
    return sigma2, h2, L, beta, se


def _effects_from_whitened(yt, Xt, Ct, *, method="qr"):
    """Per-marker GLS effect sizes from Sigma^{-1/2}-scaled inputs.

    For each marker j in the whitened model y = C a + x_j b_j + e
    (e iid after whitening), Frisch-Waugh gives b_j = <x_j^perp, y^perp> /
    ||x_j^perp||^2 with ^perp the residual against the whitened covariates.
    SE uses the per-marker unbiased residual variance rss_j / (n - c - 1)
    (the GEMMA-style Wald convention). An addition — the reference outputs
    LODs only (src/scan.jl:94-109).
    """
    from ..ops.wls import resid

    n, c = Ct.shape
    yperp = resid(yt, Ct, method=method)
    Xperp = resid(Xt, Ct, method=method)
    nx2 = jnp.maximum(
        jnp.sum(Xperp * Xperp, axis=0), jnp.finfo(yt.dtype).tiny
    )
    cov = (Xperp.T @ yperp)[:, 0]
    ny2 = jnp.sum(yperp * yperp)
    beta = cov / nx2
    rss = jnp.maximum(ny2 - cov * cov / nx2, 0.0)
    dof = max(n - c - 1, 1)
    se = jnp.sqrt(rss / dof / nx2)
    return beta, se


@partial(jax.jit, static_argnames=("method", "alt", "precision"))
@with_highest_matmul
def _effects_lowrank_pipeline(y, Xm, C, U, lam, h2_or_h2s, *, method, alt,
                              precision=DEFAULT_PRECISION):
    """Marker effects on a rank-k kinship: explicit Sigma^{-1/2} whitening
    (ops/lowrank.py::whiten_lowrank, two (n, k) GEMMs per operand) feeds
    the same Frisch-Waugh effects kernel as the rotated path."""
    from ..ops.lowrank import whiten_lowrank

    if not alt:
        yw = whiten_lowrank(y, U, lam, h2_or_h2s)
        Xw = whiten_lowrank(Xm, U, lam, h2_or_h2s)
        Cw = whiten_lowrank(C, U, lam, h2_or_h2s)
        return _effects_from_whitened(yw, Xw, Cw, method=method)

    # per-marker h2: the Gram/Woodbury route (no per-marker whitening
    # GEMMs, no vmapped QRs — ops/lowrank.py::effects_alt_per_marker_lowrank)
    from ..ops.lowrank import (
        LowRankKinship, _base_parts, _parts_kwargs,
        effects_alt_per_marker_lowrank,
    )

    lr = LowRankKinship(U=U, lam=lam)
    parts = _base_parts(y, Xm, C, lr, **_parts_kwargs(precision))
    return effects_alt_per_marker_lowrank(parts, lam, h2_or_h2s, y.shape[0])


def _host_null_fit(y, covar, Ut_h, lam_h, prior, reml, optim_interval, dtype):
    """Rotate y/covariates on the host in float64 and fit the null model
    there (ops/hostfit.py) so h2 is bit-identical on every backend.

    Returns ONE packed device vector ``[b (c,), sigma2, h2, ell]`` — a
    single host->device transfer instead of four separate scalar uploads,
    each with its own dispatch-issue cost; the scan cores unpack the vector at
    trace time (:func:`_coerce_null_fit`), where the slices fuse for free.
    """
    import numpy as np

    from ..ops.hostfit import fit_lmm_host

    y_h = Ut_h @ np.asarray(y, dtype=np.float64)
    C_h = Ut_h @ np.asarray(covar, dtype=np.float64)
    nf = fit_lmm_host(
        y_h, C_h, lam_h, prior, reml=reml, optim_interval=optim_interval
    )
    packed = np.concatenate([
        np.asarray(nf.b, dtype=np.float64).ravel(),
        [float(nf.sigma2), float(nf.h2), float(nf.ell)],
    ])
    return jnp.asarray(packed, dtype=dtype)


def _apply_weights(y, g, covar, K, weights, add_intercept):
    """Pre-scale data for heteroskedastic residual variances.

    Mirrors the reference exactly (src/scan.jl:201-227): y, G, covariates are
    multiplied by diag(weights) and K -> W K W; the intercept (if requested)
    is materialized first so it is scaled too.

    Runs in float64 ON THE HOST: the K -> WKW rescale squares the
    conditioning and feeds the host eigendecomposition, so it stays in
    host f64 next to it (and the unweighted rotation path is already
    host-f64 end-to-end through ``kinship_eigen``).
    """
    import numpy as _np
    import warnings as _warnings

    wv = _np.asarray(weights, dtype=_np.float64)
    if _np.any(wv <= 0.0):
        # parity: reference warns on non-positive weights (src/wls.jl:35-37)
        _warnings.warn("Some of the weights are not positive.")
    y = _np.asarray(y, dtype=_np.float64)
    g = _np.asarray(g, dtype=_np.float64)
    covar = _np.asarray(covar, dtype=_np.float64)
    n = y.shape[0]
    if add_intercept:
        covar = _np.concatenate([_np.ones((n, 1)), covar], axis=1)
    # returned as HOST numpy: the single-trait engines feed y/covar to the
    # host null fit next (zero device round-trips), and the device cast
    # happens once, at the final .astype(dtype)
    y = y * wv[:, None]
    g = g * wv[:, None]
    covar = covar * wv[:, None]
    K = wv[:, None] * _np.asarray(K, dtype=_np.float64) * wv[None, :]
    return y, g, covar, K, False  # add_intercept now consumed


def _scan_lowrank(
    y, g, covar, K, *, prior, reml, assumption, method, optim_interval,
    permutation_test, nperms, rndseed, profile_ll, marker_id, h2_grid,
    output_pvals, chisq_df, precision, compat_sqrt_weights,
    output_effects=False,
):
    """Single-trait scan on a :class:`~bulklmm_tpu.ops.lowrank.LowRankKinship`.

    Mirrors the full-rank engines with rank-k Woodbury corrections in place
    of rotation (ops/lowrank.py): the null h2 comes from the same
    backend-deterministic host float64 Brent (ops/hostfit.py) run on the
    trait's k-dim projections, the null LODs from the rank-k correlation
    kernel, the alt path from per-marker Brent on the (c+1)-dim augmented
    Gram, and permutations from explicit ``Sigma^{-1/2}`` whitening.
    """
    import numpy as np

    from ..ops import lowrank as lrmod
    from ..ops.hostfit import fit_lmm_host_lowrank

    if compat_sqrt_weights:
        raise ValueError(
            "compat_sqrt_weights reproduces a quirk of the rotated full-rank "
            "path (COMPAT.md #1); it does not apply to LowRankKinship."
        )
    dtype = precision.resolve_solve()
    yd = jnp.asarray(y, dtype=dtype)
    C = jnp.asarray(covar, dtype=dtype)
    Xm = jnp.asarray(g).astype(dtype)
    U = K.U.astype(dtype)
    lam = K.lam.astype(dtype)
    n = yd.shape[0]

    proj = lrmod._trait_projections_lowrank(yd, C, U, lam, precision=precision)
    # one batched pytree fetch (k-scale, tiny) instead of per-leaf RPCs
    proj_h = jax.device_get(proj)
    nf = fit_lmm_host_lowrank(
        {k2: np.asarray(v, dtype=np.float64) for k2, v in proj_h.items()},
        np.asarray(lam, dtype=np.float64), n, prior,
        reml=reml, optim_interval=optim_interval,
    )
    # ONE packed upload + one unpacking dispatch (tiny per-scalar uploads
    # each pay their own dispatch-issue latency; see _host_null_fit on the
    # full-rank path)
    b_h = np.asarray(nf.b, dtype=np.float64)
    packed = jnp.asarray(
        np.concatenate([b_h.ravel(), [float(nf.sigma2), float(nf.h2),
                                      float(nf.ell)]]),
        dtype=dtype,
    )
    b_dev, sigma2_e, h2, ell_dev = _unpack_fit_vec(packed, int(b_h.size))

    if assumption == "null":
        if permutation_test:
            L = lrmod._scan_perms_lowrank_core(
                yd, Xm, C, U, lam, b_dev, h2,
                nperms=nperms, rndseed=rndseed, method=method,
                precision=precision, n=n,
            )
            result = ScanResult(
                sigma2_e=sigma2_e, h2_null=h2, lod=L[:, 0], L_perms=L[:, 1:]
            )
            if output_pvals:
                result.log10pvals = lod2log10p(result.lod, chisq_df)
                result.log10Pvals_perms = lod2log10p(result.L_perms, chisq_df)
        else:
            out = lrmod._scan_null_lowrank_core(
                yd, Xm, C, U, lam, h2,
                n=n, prior=prior, reml=reml, precision=precision,
                effects=output_effects,
            )
            result = ScanResult(sigma2_e=sigma2_e, h2_null=h2, lod=out[0])
            if output_effects:
                # fused: LODs and effects from ONE rank-k parts pass
                result.beta, result.beta_se = out[1], out[2]
            if output_pvals:
                result.log10pvals = lod2log10p(result.lod, chisq_df)
    elif assumption == "alt":
        if permutation_test:
            raise ValueError(
                "Permutation test option currently is not supported for the alternative assumption."
            )
        out_alt = lrmod._scan_alt_lowrank_core(
            yd, Xm, C, U, lam, h2,
            n=n, prior=prior, reml=reml,
            optim_interval=optim_interval, precision=precision,
            effects=output_effects,
        )
        ells, h2_each, ell0_ml = out_alt[:3]
        # REML ells are not LRT-comparable across designs: under REML both
        # sides re-evaluate with ML at the fitted h2s (_scan_alt_impl does
        # the same on the full-rank path); under ML the host fit's ell is
        # the backend-deterministic null reference
        ell_null = ell0_ml if reml else ell_dev.astype(ells.dtype)
        lod = (ells - ell_null) / _LN10
        result = ScanResult(
            sigma2_e=sigma2_e, h2_null=h2, h2_each_marker=h2_each, lod=lod
        )
        if output_effects:
            # fused: effects from the SAME rank-k parts pass as the alt fits
            result.beta, result.beta_se = out_alt[3], out_alt[4]
        if output_pvals:
            result.log10pvals = lod2log10p(result.lod, chisq_df)
    else:
        raise ValueError("Assumption keyword is not supported. Please enter null or alt.")

    if output_effects and result.beta is None:
        # perms/alt paths: explicit Sigma^{-1/2} whitening (the non-perm null
        # path gets its effects fused into the scan's parts pass above)
        result.beta, result.beta_se = _effects_lowrank_pipeline(
            yd, Xm, C, U, lam,
            h2 if assumption == "null" else result.h2_each_marker,
            method=method, alt=assumption == "alt", precision=precision,
        )

    if profile_ll:
        if not 1 <= int(marker_id) <= Xm.shape[1]:
            raise ValueError(
                f"marker_id must be a 1-based marker index in [1, "
                f"{Xm.shape[1]}]; got {marker_id}"
            )
        if h2_grid is None:
            h2_grid = jnp.arange(0.0, 1.0, 0.05)
        # marker_id is 1-based like the reference (analysis/profile_ll.py)
        prof = lrmod._profile_ll_lowrank_core(
            yd, Xm, C, U, lam, jnp.asarray(h2_grid, dtype=dtype),
            jnp.asarray(marker_id - 1),
            n=n, prior=prior, reml=reml, precision=precision,
        )
        result.ll_list_null, result.ll_list_alt = prof
        return result, prof
    return result


def scan(
    y,
    g,
    K,
    covar=None,
    *,
    weights=None,
    prior_variance: float = 0.0,
    prior_sample_size: float = 0.0,
    add_intercept: bool = True,
    reml: bool = False,
    assumption: str = "null",
    method: str = "qr",
    optim_interval: int = 1,
    permutation_test: bool = False,
    nperms: int = 1024,
    rndseed: int = 0,
    profile_ll: bool = False,
    marker_id: int = 1,
    h2_grid=None,
    decomp_scheme: str = "eigen",
    output_pvals: bool = False,
    chisq_df: int = 1,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    compat_sqrt_weights: bool = False,
    output_effects: bool = False,
    missing: str = "error",
):
    """Genome scan for a single quantitative trait.

    Mirrors the reference ``scan`` keyword surface (src/scan.jl:94-109,
    :195-372): ``assumption`` in {"null", "alt"}; ``method`` in
    {"qr", "cholesky"}; optional covariates, heteroskedastic ``weights``,
    Scaled-Inv-Chi^2 prior, REML/ML, permutation testing, profile likelihood,
    eigen/svd kinship decomposition, and -log10 p-value output.

    ``compat_sqrt_weights`` (alt path only) reproduces the reference's
    sqrt-weights quirk bit-for-bit (src/scan.jl:432-440): the final LOD
    re-evaluates both likelihoods with sqrt-weights and ML. Off by default —
    the default evaluates the likelihood ratio with correctly-scaled weights
    (see COMPAT.md #1).

    ``output_effects`` (an addition; the reference outputs LODs only)
    attaches GEMMA-style per-marker GLS effect sizes and Wald standard
    errors (``result.beta``, ``result.beta_se``) — under the shared null h2
    for ``assumption="null"``, or each marker's own fitted h2 for "alt".

    Returns a :class:`ScanResult`; when ``profile_ll`` is set, returns a
    ``(ScanResult, (ll_list_null, ll_list_alt))`` tuple like the reference.
    """
    import numpy as np

    # Single-trait prep (y, covariates, weights — all (n,)-scale) happens on
    # the HOST in float64: the backend-deterministic null fit below consumes
    # host arrays, so numpy inputs (the CSV path) reach it with ZERO device
    # round-trips, and device-resident inputs cost one fetch here instead of
    # per-use fetches inside the fit. Only the (n, p) marker matrix goes
    # straight to the device.
    y = np.asarray(y, dtype=np.float64)
    y = y[:, None] if y.ndim == 1 else y
    if y.shape[1] != 1:
        raise ValueError("scan handles one trait; use bulkscan for multiple traits.")
    from .missing import validate_missing_kwarg

    validate_missing_kwarg(missing)  # eagerly — a typo'd policy must not
    # pass silently just because this particular trait is complete
    if not np.isfinite(y).all():
        # single-trait complete-case subset ('mask'/'drop' coincide at
        # m = 1); missing='error' refuses with the remediation recipe
        from .missing import subset_rows_single

        y, g, K, covar, weights = subset_rows_single(
            y, g, K, covar, weights,
            missing=missing, what="scan", add_intercept=add_intercept,
        )
    n = y.shape[0]
    # clear host-side dimension check: a mismatch would otherwise surface
    # as a cryptic dot-dimension error deep inside a jitted pipeline
    from ..ops.lowrank import LowRankKinship as _LRK
    from ..ops.rotation import KinshipDecomposition as _KD

    K_n = (
        K.Ut.shape[0] if isinstance(K, _KD)
        else K.n if isinstance(K, _LRK)
        else np.shape(K)[0]
    )
    if np.shape(g)[0] != n or K_n != n:
        raise ValueError(
            f"Dimension mismatch: y has {n} samples, g has "
            f"{np.shape(g)[0]}, K has {K_n}."
        )
    # markers move to the device AFTER the weights branch: _apply_weights
    # rescales on the host, and a premature upload would round-trip the
    # largest array device->host->device
    if weights is None:
        g = jnp.asarray(g)

    if covar is None:
        if not add_intercept:
            raise ValueError("Intercept has to be added when no other covariate is given.")
        covar = np.ones((n, 1))
        add_intercept = False
    else:
        covar = np.asarray(covar, dtype=np.float64)
        covar = covar[:, None] if covar.ndim == 1 else covar
        from ..ops.stats import check_covar_full_rank

        check_covar_full_rank(covar, add_intercept)

    from ..ops.lowrank import LowRankKinship

    if weights is not None:
        from ..ops.rotation import KinshipDecomposition

        if isinstance(K, (KinshipDecomposition, LowRankKinship)):
            raise ValueError(
                "weights rescale the kinship matrix (K -> WKW); pass the raw "
                "K, not a cached decomposition."
            )
        y, g, covar, K, add_intercept = _apply_weights(y, g, covar, K, weights, add_intercept)
        g = jnp.asarray(g)

    prior = (float(prior_variance), float(prior_sample_size))

    if add_intercept:
        covar = np.concatenate([np.ones((n, 1)), covar], axis=1)

    if isinstance(K, LowRankKinship):
        # rank-k engine: unrotated data + Woodbury corrections (ops/lowrank.py)
        return _scan_lowrank(
            y, g, covar, K,
            prior=prior, reml=reml, assumption=assumption, method=method,
            optim_interval=optim_interval, permutation_test=permutation_test,
            nperms=nperms, rndseed=rndseed, profile_ll=profile_ll,
            marker_id=marker_id, h2_grid=h2_grid, output_pvals=output_pvals,
            chisq_df=chisq_df, precision=precision,
            compat_sqrt_weights=compat_sqrt_weights,
            output_effects=output_effects,
        )
    dtype = precision.resolve_solve()
    from ..ops.rotation import KinshipDecomposition, kinship_eigen

    # dispatch the device rotation FIRST (async): the O(n^2 p) marker GEMM
    # overlaps the host null fit below instead of waiting behind it
    if isinstance(K, KinshipDecomposition):
        # cached factors already device-resident — only y/covar upload
        Ut, lam, Ut_h, lam_h = resolve_kinship_with_host(K, decomp_scheme, dtype)
        y0, X0m, C0 = _rotate3(
            Ut, jnp.asarray(y, dtype=dtype), g.astype(dtype),
            jnp.asarray(covar, dtype=dtype),
        )
    else:
        # raw-K path: the host eigh's factors plus the trait and covariates
        # ride ONE packed host->device transfer
        Ut_h, lam_h = kinship_eigen(K, decomp_scheme)
        packed = np.concatenate([Ut_h.ravel(), lam_h, y.ravel(), covar.ravel()])
        y0, X0m, C0, lam, Ut = _rotate3_packed(
            jnp.asarray(packed, dtype=dtype), g.astype(dtype),
            n=n, c=covar.shape[1],
        )
    null_fit = _host_null_fit(
        y, covar, Ut_h, lam_h, prior, reml, optim_interval, dtype
    )

    common = dict(
        prior=prior, reml=reml,
        method=method, optim_interval=optim_interval, precision=precision,
    )

    if assumption == "null":
        if permutation_test:
            sigma2_e, h2_null, L, beta, beta_se = _scan_perms_pipeline(
                y0, X0m, C0, lam, null_fit, nperms=nperms, rndseed=rndseed,
                output_effects=output_effects, **common
            )
            result = ScanResult(
                sigma2_e=sigma2_e, h2_null=h2_null, lod=L[:, 0], L_perms=L[:, 1:],
                beta=beta, beta_se=beta_se,
            )
            if output_pvals:
                result.log10pvals = lod2log10p(result.lod, chisq_df)
                result.log10Pvals_perms = lod2log10p(result.L_perms, chisq_df)
        else:
            sigma2_e, h2_null, lod, beta, beta_se = _scan_null_pipeline(
                y0, X0m, C0, lam, null_fit,
                output_effects=output_effects, **common
            )
            result = ScanResult(
                sigma2_e=sigma2_e, h2_null=h2_null, lod=lod,
                beta=beta, beta_se=beta_se,
            )
            if output_pvals:
                result.log10pvals = lod2log10p(result.lod, chisq_df)
    elif assumption == "alt":
        if permutation_test:
            raise ValueError(
                "Permutation test option currently is not supported for the alternative assumption."
            )
        sigma2_e, h2_null, h2_each, lod, beta, beta_se = _scan_alt_pipeline(
            y0, X0m, C0, lam, null_fit,
            compat_sqrt_weights=compat_sqrt_weights,
            output_effects=output_effects, **common
        )
        result = ScanResult(
            sigma2_e=sigma2_e, h2_null=h2_null, h2_each_marker=h2_each, lod=lod,
            beta=beta, beta_se=beta_se,
        )
        if output_pvals:
            result.log10pvals = lod2log10p(result.lod, chisq_df)
    else:
        raise ValueError("Assumption keyword is not supported. Please enter null or alt.")

    if profile_ll:
        from ..analysis.profile_ll import profile_LL
        from ..ops.rotation import KinshipDecomposition

        # marker_id is 1-based like the reference's markerID; 0 (the old
        # silent default) would profile the last covariate on the
        # full-rank path and marker 1 on the rank-k path — reject early
        p_markers = np.shape(g)[1]
        if not 1 <= int(marker_id) <= p_markers:
            raise ValueError(
                f"marker_id must be a 1-based marker index in [1, "
                f"{p_markers}]; got {marker_id}"
            )
        if h2_grid is None:
            # reference requires the caller to supply the grid for profileLL
            # (its default is an undef 1-array, src/scan.jl:104); a usable
            # default is friendlier
            h2_grid = jnp.arange(0.0, 1.0, 0.05)
        # reuse the factors already computed for the scan — avoids a second
        # O(n^3) host eigendecomposition + rotation
        prof = profile_LL(
            y, g, covar, KinshipDecomposition(Ut=Ut, lam=lam), jnp.asarray(h2_grid),
            marker_id, prior=prior, reml=reml,
        )
        result.ll_list_null, result.ll_list_alt = prof
        return result, prof

    return result


def scan_perms_lite(
    y,
    g,
    covar,
    K,
    *,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    add_intercept: bool = True,
    method: str = "qr",
    optim_interval: int = 1,
    nperms: int = 1024,
    rndseed: int = 0,
    reml: bool = False,
    decomp_scheme: str = "eigen",
    output_pvals: bool = False,
    chisq_df: int = 1,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    missing: str = "error",
):
    """Standalone eigen-rotated permutation scan (reference src/scan.jl:485-557).

    Note the reference's standalone default ``prior_variance = 1.0`` differs
    from ``scan``'s 0.0 (src/scan.jl:487 vs :98); both defaults are mirrored.
    """
    # host numpy float64 until the single device cast below: the
    # backend-deterministic null fit must see the untruncated phenotype
    # (jnp.asarray would round to f32 when x64 is off), same as scan()
    y = np.asarray(y, dtype=np.float64)
    y = y[:, None] if y.ndim == 1 else y
    if y.shape[1] != 1:
        raise ValueError("Can only handle one trait.")
    from .missing import validate_missing_kwarg

    validate_missing_kwarg(missing)
    if not np.isfinite(y).all():
        from .missing import subset_rows_single

        y, g, K, covar, _ = subset_rows_single(
            y, g, K, covar, None,
            missing=missing, what="scan_perms_lite",
            add_intercept=add_intercept,
        )
    covar = np.asarray(covar, dtype=np.float64)
    covar = covar[:, None] if covar.ndim == 1 else covar
    n = y.shape[0]
    if add_intercept:
        covar = np.concatenate([np.ones((n, 1)), covar], axis=1)
    dtype = precision.resolve_solve()
    prior = (float(prior_variance), float(prior_sample_size))

    from ..ops.lowrank import LowRankKinship

    if isinstance(K, LowRankKinship):
        return _scan_lowrank(
            y, g, covar, K,
            prior=prior, reml=reml, assumption="null", method=method,
            optim_interval=optim_interval, permutation_test=True,
            nperms=nperms, rndseed=rndseed, profile_ll=False, marker_id=0,
            h2_grid=None, output_pvals=output_pvals, chisq_df=chisq_df,
            precision=precision, compat_sqrt_weights=False,
        )
    Ut, lam, Ut_h, lam_h = resolve_kinship_with_host(K, decomp_scheme, dtype)
    # rotation dispatched async BEFORE the host null fit (see scan())
    y0, X0m, C0 = _rotate3(
        Ut, jnp.asarray(y, dtype=dtype), jnp.asarray(g, dtype=dtype),
        jnp.asarray(covar, dtype=dtype),
    )
    null_fit = _host_null_fit(
        y, covar, Ut_h, lam_h, prior, reml, optim_interval, dtype
    )
    sigma2_e, h2_null, L, _, _ = _scan_perms_pipeline(
        y0, X0m, C0, lam,
        null_fit,
        prior=prior,
        reml=reml, method=method, optim_interval=optim_interval,
        nperms=nperms, rndseed=rndseed, precision=precision,
    )
    result = ScanResult(sigma2_e=sigma2_e, h2_null=h2_null, lod=L[:, 0], L_perms=L[:, 1:])
    if output_pvals:
        result.log10pvals = lod2log10p(result.lod, chisq_df)
        result.log10Pvals_perms = lod2log10p(result.L_perms, chisq_df)
    return result
