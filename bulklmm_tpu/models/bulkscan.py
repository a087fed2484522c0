"""Multi-trait bulk genome scans: null-grid / null-exact / alt-grid.

Parity: reference ``bulkscan`` (src/bulkscan.jl:81-162) and its three engines.
Accelerator redesign:

- **null-grid** (src/bulkscan.jl:321-397): the reference evaluates the h2
  grid, then groups traits into h2-bins and runs one CPU GEMM per bin
  (dynamic shapes). Here the grid likelihoods are one vmapped batched solve
  (grid x traits in a single device step), the per-trait argmax picks h2, and
  the scan runs through the per-trait-weight correlation kernel
  (ops/liteqtl.py) — (c+2) static-shape GEMMs, exact per-trait h2, no
  binning or reordering.
- **null-exact** (src/bulkscan.jl:188-313): the reference multi-threads a
  per-trait Brent + GEMV loop over trait blocks. Here ``vmap(fit_lmm)``
  batches every Brent iteration across all m traits, then the same per-trait
  kernel produces the (p x m) LOD matrix.
- **alt-grid** (src/bulkscan.jl:428-527): ``lax.scan`` over the h2 grid with
  a running elementwise max of the alt log-likelihood, tracking the argmax h2
  per (marker, trait). The reference's ``tmax!`` counter bug (h2_panel picks
  ``hsq_list[count]`` rather than the current h2, src/bulkscan.jl:494-524)
  is fixed: we report the true argmax h2.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.liteqtl import lods_per_trait, lods_shared
from ..ops.lmm import fit_lmm
from ..ops.lod import lod2log10p
from ..ops.rotation import resolve_kinship
from ..ops.weights import make_weights
from ..ops.wls import wls_ell
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from .results import BulkScanResult
from .scan import _apply_weights

_LN10 = math.log(10.0)


def grid_null_ell(Y0, X0_cov, lam, h2_grid, prior, *, reml=False):
    """(g, m) null-model log-likelihoods over the h2 grid.

    One vmapped batched WLS per grid point — the reference's
    ``map(h2 -> wls_multivar(...).Ell, grid)`` (src/bulkscan_helpers.jl:267-269)
    as a single fused device computation. Likelihoods go through the
    solve-free ``wls_ell`` path, which has no QR/Cholesky choice — the
    ``solve_method`` kwarg applies only to coefficient solves.
    """

    def ell_one(h2):
        w = make_weights(h2, lam)
        return wls_ell(Y0, X0_cov, w, prior, reml=reml)[0]

    return jax.vmap(ell_one)(h2_grid)


def _lod_kernel(Y0, X0m, C0, lam, h2_list, *, precision, effects):
    """(L, h2) or (L, h2, beta, se) — the effects variant shares ONE parts
    computation with the LODs (ops/liteqtl.py::lods_and_effects_per_trait)."""
    if effects:
        from ..ops.liteqtl import lods_and_effects_per_trait

        L, beta, se = lods_and_effects_per_trait(
            Y0, X0m, C0, lam, h2_list, precision=precision
        )
        return L, h2_list, beta, se
    return lods_per_trait(Y0, X0m, C0, lam, h2_list, precision=precision), h2_list


def _null_grid_impl(Y0, X0m, C0, lam, h2_grid, *, prior, reml, method, precision,
                    effects=False):
    """Covariates (C0) and markers (X0m) stay separate arrays end-to-end —
    slicing a concatenated design would cross shard boundaries under marker
    sharding and force an all-gather.

    The grid log-likelihoods run in the kernel dtype: bin selection only
    needs to rank ~0.1-spaced grid points, whose ell gaps dwarf f32 noise
    (measured: 0 selection flips in 8,192 heritable traits, f32 vs f64) —
    f64-emulated elementwise ell math was most of BALANCED's overhead.
    """
    kdt = precision.resolve_kernel()
    ells = grid_null_ell(
        Y0.astype(kdt), C0.astype(kdt), lam.astype(kdt),
        h2_grid.astype(kdt), prior, reml=reml,
    )
    idx = jnp.argmax(ells, axis=0)  # first max wins, like Julia findmax
    h2_list = h2_grid[idx]
    return _lod_kernel(Y0, X0m, C0, lam, h2_list, precision=precision,
                       effects=effects)


def _null_exact_impl(
    Y0, X0m, C0, lam, *, prior, reml, method, optim_interval, precision,
    effects=False,
):
    fits = jax.vmap(
        lambda yj: fit_lmm(
            yj, C0, lam, prior,
            reml=reml, method=method, optim_interval=optim_interval,
        ),
        in_axes=1,
    )(Y0)
    h2_list = fits.h2
    return _lod_kernel(Y0, X0m, C0, lam, h2_list, precision=precision,
                       effects=effects)


def _alt_grid_impl(Y0, X0m, C0, lam, h2_grid, *, prior, reml, method, precision):
    X0_cov = C0
    X0_m = X0m
    p = X0_m.shape[1]
    m = Y0.shape[1]
    dt = Y0.dtype

    # argmax index carried as int8: the (p, m) kmax array is read+written
    # every grid step, so 4 bytes -> 1 byte saves real HBM traffic (grids
    # are tiny; 127 points is far beyond any practical h2 grid)
    g = h2_grid.shape[0]
    idx_dt = jnp.int8 if g <= 127 else jnp.int32

    def step(carry, inputs):
        k, h2 = inputs
        logL1_max, kmax, logL0_max = carry
        lod_k = lods_shared(Y0, X0_m, X0_cov, lam, h2, precision=precision)
        ell0 = wls_ell(Y0, X0_cov, make_weights(h2, lam), prior, reml=reml)[0]
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
    h2_panel = h2_grid[kmax]
    return L, h2_panel


def _scan_common_inputs(Y, covar, h2_grid, add_intercept, *, method, engine):
    """Shared validation + trait/covariate prep for the scan entry points
    (in-memory :func:`bulkscan` and marker-streamed ``bulkscan_streamed``)
    — they must never diverge on argument semantics."""
    if method not in ("null-grid", "null-exact", "alt-grid"):
        raise ValueError(
            "method must be one of 'null-grid', 'null-exact', 'alt-grid'"
        )
    if engine not in ("auto", "xla", "pallas"):
        raise ValueError("engine must be one of 'auto', 'xla', 'pallas'")
    if engine == "pallas" and method != "alt-grid":
        raise ValueError(
            "engine='pallas' is only available for method='alt-grid' "
            "(the null engines are XLA-only)"
        )
    Y = jnp.asarray(Y)
    Y = Y[:, None] if Y.ndim == 1 else Y
    n = Y.shape[0]
    if h2_grid is None:
        h2_grid = jnp.arange(0.0, 0.91, 0.1)
    h2_grid = jnp.asarray(h2_grid)
    if covar is None:
        covar = jnp.ones((n, 1), dtype=Y.dtype)
        add_intercept = False
    else:
        from ..ops.stats import check_covar_full_rank

        check_covar_full_rank(covar, add_intercept)
        covar = jnp.asarray(covar)
        covar = covar[:, None] if covar.ndim == 1 else covar
    return Y, covar, h2_grid, add_intercept


def _altgrid_engine(engine, precision, g, device=None) -> str:
    """"pallas" or "xla" for the alt-grid method (pallas.resolve_engine;
    the kernel's int8 argmin panel holds at most 127 grid points)."""
    from ..pallas import resolve_engine

    return resolve_engine(engine, precision, device=device, eligible=g <= 127)


def _check_output_effects(output_effects: bool, method: str) -> None:
    """Shared guard (bulkscan / bulkscan_streamed / bulkscan_sharded):
    (p, m) effects need one h2 per trait, i.e. a null method."""
    if output_effects and method == "alt-grid":
        raise ValueError(
            "output_effects applies to the null methods (one h2 per trait); "
            "for per-marker-h2 effects run scan(assumption='alt', "
            "output_effects=True) on the trait of interest"
        )


_STATIC_GRID = ("prior", "reml", "method", "precision")
_STATIC_EXACT = ("prior", "reml", "method", "optim_interval", "precision")


def _chunk_traits(impl, Y0, *, trait_chunk):
    """Run ``impl(Y_chunk) -> tuple of arrays`` over trait chunks.

    Bounds peak memory: (p, m)-scale intermediates exist only at (p, chunk)
    size per step, and chunk results are written in place
    (``dynamic_update_slice`` inside a ``fori_loop``) into ONE preallocated
    output per leaf — a ``lax.map`` + concatenate formulation held both the
    stacked (k, p, chunk) results AND the merged (p, m) copy live at once,
    OOMing the biobank config. m is zero-padded up to a chunk multiple and
    sliced back.
    """
    m = Y0.shape[1]
    pad = (-m) % trait_chunk
    if pad:
        Y0 = jnp.concatenate(
            [Y0, jnp.zeros((Y0.shape[0], pad), dtype=Y0.dtype)], axis=1
        )
    mp = Y0.shape[1]
    k = mp // trait_chunk

    probe = jax.eval_shape(
        impl, jax.ShapeDtypeStruct((Y0.shape[0], trait_chunk), Y0.dtype)
    )
    outs0 = tuple(jnp.zeros(s.shape[:-1] + (mp,), s.dtype) for s in probe)

    def body(i, outs):
        Yc = jax.lax.dynamic_slice_in_dim(Y0, i * trait_chunk, trait_chunk, axis=1)
        res = impl(Yc)
        return tuple(
            jax.lax.dynamic_update_slice_in_dim(o, r, i * trait_chunk, axis=o.ndim - 1)
            for o, r in zip(outs, res)
        )

    outs = jax.lax.fori_loop(0, k, body, outs0)
    return tuple(o[..., :m] for o in outs)

# jitted cores over pre-rotated data (used by bulklmm_tpu.parallel, which
# device_puts sharded rotated arrays before the call)
_bulkscan_null_grid_core = partial(
    jax.jit, static_argnames=_STATIC_GRID + ("effects",)
)(with_highest_matmul(_null_grid_impl))
_bulkscan_null_exact_core = partial(
    jax.jit, static_argnames=_STATIC_EXACT + ("effects",)
)(with_highest_matmul(_null_exact_impl))
_bulkscan_alt_grid_core = partial(jax.jit, static_argnames=_STATIC_GRID)(
    with_highest_matmul(_alt_grid_impl)
)


def _rotate(Y, Xm, C, Ut):
    return jnp.matmul(Ut, Y), jnp.matmul(Ut, Xm), jnp.matmul(Ut, C)


@partial(jax.jit, static_argnames=_STATIC_GRID + ("trait_chunk", "effects"))
@with_highest_matmul
def _null_grid_pipeline(
    Y, Xm, C, Ut, lam, h2_grid, *, prior, reml, method, precision,
    trait_chunk=None, effects=False,
):
    """Rotation + grid fit + LOD kernel as ONE jitted computation — a single
    device dispatch per bulkscan call, with the rotation GEMMs fused into the
    same XLA program as the scan. ``trait_chunk`` bounds peak memory by
    streaming trait blocks (for f64 runs / biobank-scale matrices);
    ``effects`` adds (beta, se) outputs from the same chunked kernel pass."""
    Y0, X0m, C0 = _rotate(Y, Xm, C, Ut)
    kw = dict(prior=prior, reml=reml, method=method, precision=precision,
              effects=effects)
    if trait_chunk is None:
        return _null_grid_impl(Y0, X0m, C0, lam, h2_grid, **kw)
    return _chunk_traits(
        lambda Yc: _null_grid_impl(Yc, X0m, C0, lam, h2_grid, **kw),
        Y0, trait_chunk=trait_chunk,
    )


@partial(jax.jit, static_argnames=_STATIC_EXACT + ("trait_chunk", "effects"))
@with_highest_matmul
def _null_exact_pipeline(
    Y, Xm, C, Ut, lam, *, prior, reml, method, optim_interval, precision,
    trait_chunk=None, effects=False,
):
    Y0, X0m, C0 = _rotate(Y, Xm, C, Ut)
    kw = dict(
        prior=prior, reml=reml, method=method,
        optim_interval=optim_interval, precision=precision, effects=effects,
    )
    if trait_chunk is None:
        return _null_exact_impl(Y0, X0m, C0, lam, **kw)
    return _chunk_traits(
        lambda Yc: _null_exact_impl(Yc, X0m, C0, lam, **kw),
        Y0, trait_chunk=trait_chunk,
    )


@partial(jax.jit, static_argnames=_STATIC_GRID + ("trait_chunk",))
@with_highest_matmul
def _alt_grid_pipeline(
    Y, Xm, C, Ut, lam, h2_grid, *, prior, reml, method, precision, trait_chunk=None
):
    Y0, X0m, C0 = _rotate(Y, Xm, C, Ut)
    kw = dict(prior=prior, reml=reml, method=method, precision=precision)
    if trait_chunk is None:
        return _alt_grid_impl(Y0, X0m, C0, lam, h2_grid, **kw)
    return _chunk_traits(
        lambda Yc: _alt_grid_impl(Yc, X0m, C0, lam, h2_grid, **kw),
        Y0, trait_chunk=trait_chunk,
    )


@partial(jax.jit, static_argnames=_STATIC_GRID + ("trait_chunk", "panel"))
@with_highest_matmul
def _alt_grid_pallas_pipeline(
    Y, Xm, C, Ut, lam, h2_grid, *, prior, reml, method, precision,
    trait_chunk=None, panel=True,
):
    """Rotation fused with the register-carry alt-grid kernel
    (pallas/altgrid_fused.py) — the GPU path; same accuracy as the XLA
    formulation at f32 GEMM dtype, without the per-grid-step (p, m)
    carry traffic. ``panel=False`` skips the argmin store."""
    from ..pallas.altgrid_fused import fused_alt_grid

    Y0, X0m, C0 = _rotate(Y, Xm, C, Ut)

    def impl(Yc):
        out = fused_alt_grid(
            Yc, X0m, C0, lam, h2_grid, prior=prior, reml=reml,
            precision=precision, output_h2_panel=panel,
        )
        return out if panel else (out[0],)

    if trait_chunk is None:
        return impl(Y0)
    return _chunk_traits(impl, Y0, trait_chunk=trait_chunk)


def bulkscan(
    Y,
    G,
    K,
    covar=None,
    *,
    method: str = "null-grid",
    h2_grid=None,
    add_intercept: bool = True,
    weights=None,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    output_pvals: bool = False,
    chisq_df: int = 1,
    solve_method: str = "qr",
    precision: PrecisionConfig = DEFAULT_PRECISION,
    trait_chunk=None,
    engine: str = "auto",
    output_effects: bool = False,
    missing: str = "error",
    output_h2_panel: bool = True,
) -> BulkScanResult:
    """Genome scan for many traits at once.

    ``method``: "null-grid" (default; grid-approximated Null-LMM),
    "null-exact" (per-trait Brent Null-LMM), or "alt-grid" (grid-approximated
    Exact-LMM). Keyword surface mirrors the reference (src/bulkscan.jl:81-162;
    the reference's ``nb``/``nt_blas`` CPU-threading knobs have no device
    equivalent — parallelism comes from the device mesh, see
    ``bulklmm_tpu.parallel``). ``solve_method`` ("qr"/"cholesky") applies
    only to coefficient solves (Brent refits); the grid likelihoods use the
    solve-free ``wls_ell`` path, which has no such choice.

    ``engine``: "auto" (default), "xla", or "pallas" — implementation of the
    alt-grid method. "auto" picks the fused Pallas kernel
    (pallas/altgrid_fused.py) on a CUDA GPU with an f32 GEMM dtype, where
    it keeps the running-max carry in registers instead of the XLA
    ``lax.scan`` formulation's per-step device-memory round trip; other
    backends/dtypes use XLA. The null engines are XLA-only.

    ``output_effects`` (an addition; null methods only): attach (p, m)
    GEMMA-style GLS effect sizes and Wald SEs at each trait's fitted null
    h2 (``result.beta_mat`` / ``result.beta_se_mat``).

    ``trait_chunk=None`` (default) sizes itself from the device memory
    budget (utils/memory.py): small problems keep the single-dispatch
    fast path, larger ones get a device trait chunk, and problems whose
    (p, m) result cannot live on device fall back to sequential host
    trait blocks automatically (result assembled in host numpy). Pass an
    int to pin the chunk (>= m disables chunking).

    ``missing``: NaN-phenotype policy — "error" (default; async
    device-side guard, ~0 hot-path cost), "mask" (per-trait complete-case,
    traits grouped by missingness pattern — exact, each pattern gets its
    own rotation and effective n), or "drop" (listwise deletion). See
    models/missing.py and COMPAT.md #18.
    """
    _check_output_effects(output_effects, method)
    from .missing import (
        finite_flag, maybe_masked, raise_if_missing, subset_kinship,
    )

    masked = maybe_masked(
        Y, missing,
        lambda Ys, rows, traits, gi: bulkscan(
            Ys, np.asarray(G)[rows], subset_kinship(K, rows),
            None if covar is None else np.asarray(covar)[rows],
            method=method, h2_grid=h2_grid, add_intercept=add_intercept,
            weights=None if weights is None else np.asarray(weights)[rows],
            prior_variance=prior_variance,
            prior_sample_size=prior_sample_size, reml=reml,
            optim_interval=optim_interval, decomp_scheme=decomp_scheme,
            output_pvals=output_pvals, chisq_df=chisq_df,
            solve_method=solve_method, precision=precision,
            trait_chunk=trait_chunk, engine=engine,
            output_effects=output_effects,
            output_h2_panel=output_h2_panel,
        ),
        covar=covar, weights=weights, add_intercept=add_intercept,
        what="bulkscan",
    )
    if masked is not None:
        return masked
    _finite = finite_flag(Y)  # background guard, checked at return

    if trait_chunk is None:
        # OOM-free by default: size the trait chunk from the device
        # budget + footprint model (utils/memory.py). Small problems get
        # None back (single-dispatch fast path, unchanged); problems
        # whose (p, m) result itself overflows fall back to sequential
        # host trait blocks with the result assembled in host RAM.
        from .missing import _ncov_total
        from ..utils.memory import auto_trait_chunk

        _n, _m = np.shape(Y)[0], (
            1 if np.ndim(Y) == 1 else np.shape(Y)[1]
        )
        _p = np.shape(G)[1]
        _c = _ncov_total(covar, add_intercept)
        _grid = 10 if h2_grid is None else len(h2_grid)
        _iz = max(np.dtype(precision.resolve_solve()).itemsize,
                  np.dtype(precision.resolve_kernel()).itemsize)
        # each counted output is one (p, m)-scale device resident:
        # L (+h2 panel for alt-grid) (+beta, SE) (+device p-values)
        _nout = (1 + (method == "alt-grid") + 2 * int(output_effects)
                 + int(output_pvals))
        try:
            trait_chunk = auto_trait_chunk(
                _n, _p, _m, grid=_grid, c=_c, itemsize=_iz,
                n_outputs=_nout,
            )
        except ValueError:
            return _host_blocked_bulkscan(
                Y, G, K, covar,
                method=method, h2_grid=h2_grid,
                add_intercept=add_intercept, weights=weights,
                prior_variance=prior_variance,
                prior_sample_size=prior_sample_size, reml=reml,
                optim_interval=optim_interval,
                decomp_scheme=decomp_scheme, output_pvals=output_pvals,
                chisq_df=chisq_df, solve_method=solve_method,
                precision=precision, engine=engine,
                output_effects=output_effects,
                output_h2_panel=output_h2_panel,
                dims=(_n, _p, _m, _c, _grid, _iz, _nout),
            )

    Y, covar, h2_grid, add_intercept = _scan_common_inputs(
        Y, covar, h2_grid, add_intercept, method=method, engine=engine
    )
    G = jnp.asarray(G)
    n = Y.shape[0]

    from ..ops.lowrank import LowRankKinship

    if weights is not None:
        from ..ops.rotation import KinshipDecomposition

        if isinstance(K, (KinshipDecomposition, LowRankKinship)):
            raise ValueError(
                "weights rescale the kinship matrix (K -> WKW); pass the raw "
                "K, not a cached decomposition."
            )
        Y, G, covar, K, add_intercept = _apply_weights(Y, G, covar, K, weights, add_intercept)

    prior = (float(prior_variance), float(prior_sample_size))

    # host-side O(n^3) eigendecomposition; everything after is ONE jitted
    # device program (rotation GEMMs fused with the scan)
    if add_intercept:
        covar = jnp.concatenate([jnp.ones((n, 1), dtype=covar.dtype), covar], axis=1)
    dtype = precision.resolve_solve()

    if isinstance(K, LowRankKinship):
        # rank-k engine: no rotation at all — unrotated inputs, Woodbury
        # weights (ops/lowrank.py). All three methods are supported; the
        # h2 fits and LOD kernels run on the shared k-dim projections.
        if engine == "pallas":
            raise ValueError(
                "engine='pallas' is not available for LowRankKinship inputs "
                "(the rank-k engine is XLA-only)"
            )
        from ..ops.lowrank import _bulkscan_lowrank_core

        out = _bulkscan_lowrank_core(
            Y.astype(dtype), G.astype(dtype), covar.astype(dtype),
            K.U.astype(dtype), K.lam.astype(dtype),
            jnp.asarray(h2_grid, dtype=dtype),
            n=n, prior=prior, reml=reml, precision=precision,
            trait_chunk=trait_chunk, method=method,
            optim_interval=optim_interval,
            effects=output_effects and method != "alt-grid",
        )
        if method == "alt-grid":
            result = BulkScanResult(
                L=out[0],
                h2_panel=out[1] if output_h2_panel else None,
            )
        else:
            result = BulkScanResult(L=out[0], h2_null_list=out[1])
            if output_effects:
                result.beta_mat, result.beta_se_mat = out[2], out[3]
        if output_pvals:
            result.log10Pvals_mat = lod2log10p(result.L, chisq_df)
            result.chisq_df = chisq_df
        raise_if_missing(_finite, "bulkscan")
        return result
    Ut, lam = resolve_kinship(K, decomp_scheme, dtype)
    Y = Y.astype(dtype)
    C = covar.astype(dtype)
    Xm = G.astype(dtype)

    if method == "null-grid":
        out = _null_grid_pipeline(
            Y, Xm, C, Ut, lam, h2_grid.astype(dtype),
            prior=prior, reml=reml, method=solve_method,
            precision=precision, trait_chunk=trait_chunk,
            effects=output_effects,
        )
        result = BulkScanResult(L=out[0], h2_null_list=out[1])
        if output_effects:
            result.beta_mat, result.beta_se_mat = out[2], out[3]
    elif method == "null-exact":
        out = _null_exact_pipeline(
            Y, Xm, C, Ut, lam,
            prior=prior, reml=reml, method=solve_method,
            optim_interval=optim_interval, precision=precision,
            trait_chunk=trait_chunk, effects=output_effects,
        )
        result = BulkScanResult(L=out[0], h2_null_list=out[1])
        if output_effects:
            result.beta_mat, result.beta_se_mat = out[2], out[3]
    elif method == "alt-grid":
        if _altgrid_engine(engine, precision, h2_grid.shape[0]) == "pallas":
            out = _alt_grid_pallas_pipeline(
                Y, Xm, C, Ut, lam, h2_grid.astype(dtype),
                prior=prior, reml=reml, method=solve_method,
                precision=precision, trait_chunk=trait_chunk,
                panel=output_h2_panel,
            )
            L, h2_panel = out if output_h2_panel else (out[0], None)
        else:
            L, h2_panel = _alt_grid_pipeline(
                Y, Xm, C, Ut, lam, h2_grid.astype(dtype),
                prior=prior, reml=reml, method=solve_method,
                precision=precision, trait_chunk=trait_chunk,
            )
            if not output_h2_panel:
                # XLA formulation computes the panel either way (its scan
                # carry lives in device memory regardless); the flag only
                # elides the kernel's argmin store
                h2_panel = None
        result = BulkScanResult(L=L, h2_panel=h2_panel)

    if output_pvals:
        result.log10Pvals_mat = lod2log10p(result.L, chisq_df)
        result.chisq_df = chisq_df
    raise_if_missing(_finite, "bulkscan")
    return result


def _host_blocked_bulkscan(Y, G, K, covar, *, dims, weights, decomp_scheme,
                           output_pvals, output_effects, chisq_df,
                           precision, **kwargs) -> BulkScanResult:
    """Sequential host trait blocks when the full (p, m) result cannot
    live on device (utils/memory.py::auto_host_block): each block runs
    the normal engine (its own auto trait_chunk), its outputs land in
    host arrays, and the kinship is decomposed ONCE up front — round 4's
    hand-driven ``--host-blocks`` pattern, now automatic."""
    from ..ops.lowrank import LowRankKinship
    from ..ops.rotation import KinshipDecomposition, decompose_kinship
    from ..utils.memory import auto_host_block

    n, p, m, c, grid, iz, nout = dims
    mh = auto_host_block(n, p, m, grid=grid, c=c, itemsize=iz,
                         n_outputs=nout)
    if weights is not None:
        # scale once on the host; per-block rescaling would decompose a
        # different WKW per block only to get the same factors
        if isinstance(K, (KinshipDecomposition, LowRankKinship)):
            raise ValueError(
                "weights rescale the kinship matrix (K -> WKW); pass the "
                "raw K, not a cached decomposition."
            )
        # same input normalization as _scan_common_inputs BEFORE the
        # weight scaling: a 1-D Y would broadcast y * w[:, None] to
        # (n, n) silently, a 1-D covar would crash the intercept concat
        Yw = np.asarray(Y, dtype=np.float64)
        Yw = Yw[:, None] if Yw.ndim == 1 else Yw
        if covar is None:
            covar = np.ones((n, 1), dtype=np.float64)
            kwargs["add_intercept"] = False
        else:
            covar = np.asarray(covar, dtype=np.float64)
            covar = covar[:, None] if covar.ndim == 1 else covar
        Y, G, covar, K, kwargs["add_intercept"] = _apply_weights(
            Yw, G, covar, K, weights, kwargs["add_intercept"],
        )
    if not isinstance(K, (KinshipDecomposition, LowRankKinship)):
        K = decompose_kinship(np.asarray(K), decomp_scheme)
    # upload the marker panel ONCE: each block's recursive call would
    # otherwise re-transfer the (n, p) panel (2 GB at biobank scale);
    # jnp.asarray on an already
    # device-resident array is a no-op downstream
    G = jnp.asarray(G)
    Yn = np.asarray(Y)
    Yn = Yn[:, None] if Yn.ndim == 1 else Yn
    # output dtypes INHERIT from the first block's engine results, so a
    # host-blocked run returns byte-identical dtypes to the same call on
    # a bigger device (they are precision- and engine-dependent; pinning
    # resolve_kernel here would diverge under MIXED)
    L = None
    h2_list = h2_panel = beta = se = pv = None

    def start_d2h(res):
        # runtime-level async device->host copies: the (p, mh) slabs
        # transfer while the NEXT block computes (D2H readback is the
        # bottleneck when results live in host RAM)
        for a in (res.L, res.h2_null_list, res.h2_panel, res.beta_mat,
                  res.beta_se_mat, res.log10Pvals_mat):
            if a is not None and hasattr(a, "copy_to_host_async"):
                try:
                    a.copy_to_host_async()
                except RuntimeError:
                    pass

    def harvest(ms, me, res):
        nonlocal L, h2_list, h2_panel, beta, se, pv
        Lb = np.asarray(res.L)
        if L is None:
            L = np.empty((p, m), dtype=Lb.dtype)
        L[:, ms:me] = Lb
        if res.h2_null_list is not None:
            hb = np.asarray(res.h2_null_list)
            if h2_list is None:
                h2_list = np.empty(m, dtype=hb.dtype)
            h2_list[ms:me] = hb
        if res.h2_panel is not None:
            pb = np.asarray(res.h2_panel)
            if h2_panel is None:
                h2_panel = np.empty((p, m), dtype=pb.dtype)
            h2_panel[:, ms:me] = pb
        if output_effects:
            bb, sb = np.asarray(res.beta_mat), np.asarray(res.beta_se_mat)
            if beta is None:
                beta = np.empty((p, m), dtype=bb.dtype)
                se = np.empty((p, m), dtype=sb.dtype)
            beta[:, ms:me] = bb
            se[:, ms:me] = sb
        if output_pvals:
            vb = np.asarray(res.log10Pvals_mat)
            if pv is None:
                pv = np.empty((p, m), dtype=vb.dtype)
            pv[:, ms:me] = vb

    pending = None
    for ms in range(0, m, mh):
        me = min(ms + mh, m)
        res = bulkscan(
            Yn[:, ms:me], G, K, covar,
            decomp_scheme=decomp_scheme, output_pvals=output_pvals,
            chisq_df=chisq_df, output_effects=output_effects,
            precision=precision, **kwargs,
        )
        start_d2h(res)
        if pending is not None:
            harvest(*pending)  # previous block's copies are in flight
        pending = (ms, me, res)
    harvest(*pending)
    result = BulkScanResult(L=L, h2_null_list=h2_list, h2_panel=h2_panel)
    if output_effects:
        result.beta_mat, result.beta_se_mat = beta, se
    if output_pvals:
        result.log10Pvals_mat = pv
        result.chisq_df = chisq_df
    return result


def bulkscan_null(Y, G, K, covar=None, **kwargs) -> BulkScanResult:
    """Exact Null-LMM bulk scan (reference bulkscan_null, src/bulkscan.jl:188)."""
    kwargs.setdefault("prior_variance", 1.0)
    return bulkscan(Y, G, K, covar, method="null-exact", **kwargs)


def bulkscan_null_grid(Y, G, K, h2_grid=None, covar=None, **kwargs) -> BulkScanResult:
    """Grid-approximated Null-LMM bulk scan (reference src/bulkscan.jl:321)."""
    kwargs.setdefault("prior_variance", 1.0)
    return bulkscan(Y, G, K, covar, method="null-grid", h2_grid=h2_grid, **kwargs)


def bulkscan_alt_grid(Y, G, K, h2_grid=None, covar=None, **kwargs) -> BulkScanResult:
    """Grid-approximated Exact-LMM bulk scan (reference src/bulkscan.jl:428)."""
    kwargs.setdefault("prior_variance", 1.0)
    return bulkscan(Y, G, K, covar, method="alt-grid", h2_grid=h2_grid, **kwargs)
