"""Marker-streamed bulk scans: genotype panels larger than device HBM.

The in-memory engines (models/bulkscan.py) hold the full (n, p) genotype
panel and the (p, m) LOD matrix on device. At biobank scale (p ~ 10^6
markers) either can exceed one chip's HBM. This module streams HOST marker
blocks (plain numpy, ``np.memmap``, or any sliceable (n, p) array) through
the device:

- the per-trait null h2 is MARKER-INDEPENDENT (it comes from the
  covariate-only model), so the grid/Brent fit runs ONCE on the rotated
  trait block (reference semantics: src/bulkscan.jl:321-397 fits the null
  per trait before any marker work);
- each marker block is uploaded, rotated, and pushed through the same
  per-trait-weight correlation kernel as the in-memory engine
  (ops/liteqtl.py); the LOD block lands in a host output array (caller may
  pass an ``np.memmap`` for p x m results larger than RAM);
- the final block is zero-padded to the block size so every step reuses
  one compiled program.

``alt-grid`` streams too: its running max over the h2 grid is independent
per marker, so each block runs the full grid scan locally.

LowRankKinship inputs skip rotation entirely (ops/lowrank.py): trait-side
projections are computed once, marker-side projections per block.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.liteqtl import lods_per_trait
from ..ops.lmm import fit_lmm
from ..ops.lod import lod2log10p
from ..ops.rotation import resolve_kinship
from ..ops.smallchol import decovariate
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from .bulkscan import _alt_grid_impl, _check_output_effects, grid_null_ell
from .results import BulkScanResult

_STATIC = ("prior", "reml", "precision")


@partial(jax.jit, static_argnames=_STATIC + ("method", "optim_interval",
                                              "solve_method"))
@with_highest_matmul
def _fit_h2_rotated(Y, C, Ut, lam, h2_grid, *, prior, reml, method,
                    optim_interval, precision, solve_method="qr"):
    """Rotate the trait block and fit the per-trait null h2 (once)."""
    Y0 = jnp.matmul(Ut, Y)
    C0 = jnp.matmul(Ut, C)
    if method == "null-exact":
        fits = jax.vmap(
            lambda yj: fit_lmm(
                yj, C0, lam, prior,
                reml=reml, method=solve_method,
                optim_interval=optim_interval,
            ),
            in_axes=1,
        )(Y0)
        h2_list = fits.h2
    else:
        kdt = precision.resolve_kernel()
        ells = grid_null_ell(
            Y0.astype(kdt), C0.astype(kdt), lam.astype(kdt),
            h2_grid.astype(kdt), prior, reml=reml,
        )
        h2_list = h2_grid[jnp.argmax(ells, axis=0)]
    return Y0, C0, h2_list


@partial(jax.jit, static_argnames=("precision", "effects"))
@with_highest_matmul
def _block_lods(Y0, Xb, C0, Ut, lam, h2_list, *, precision, effects=False):
    """Rotate one marker block and compute its (pb, m) LOD slab (plus the
    GLS effects slab when ``effects`` — shared parts, one pass)."""
    X0b = jnp.matmul(Ut, Xb)
    if effects:
        from ..ops.liteqtl import lods_and_effects_per_trait

        return lods_and_effects_per_trait(
            Y0, X0b, C0, lam, h2_list, precision=precision
        )
    return lods_per_trait(Y0, X0b, C0, lam, h2_list, precision=precision)


@partial(jax.jit, static_argnames=_STATIC + ("use_pallas",))
@with_highest_matmul
def _block_alt_grid(Y0, Xb, C0, Ut, lam, h2_grid, *, prior, reml, precision,
                    use_pallas=False):
    X0b = jnp.matmul(Ut, Xb)
    if use_pallas:
        from ..pallas.altgrid_fused import fused_alt_grid

        return fused_alt_grid(
            Y0, X0b, C0, lam, h2_grid, prior=prior, reml=reml,
            precision=precision,
        )
    return _alt_grid_impl(
        Y0, X0b, C0, lam, h2_grid,
        prior=prior, reml=reml, method="qr", precision=precision,
    )


def _blocks(p, block):
    for lo in range(0, p, block):
        yield lo, min(lo + block, p)


def _stream_loop(G, p, block, dtype, compute, write, sharding=None):
    """Double-buffered block pipeline: while block i computes on device, the
    host slices + uploads block i+1 (``device_put`` is async), and only the
    result readback blocks. Hides host->HBM transfer behind compute.
    ``sharding`` places each uploaded block on a mesh (markers sharded) so
    the per-block kernel runs multi-device."""
    spans = list(_blocks(p, block))
    Xb = _pad_block(G, spans[0][0], spans[0][1], block, dtype, sharding)
    for i, (lo, hi) in enumerate(spans):
        res = compute(Xb)  # async dispatch
        if i + 1 < len(spans):
            Xb = _pad_block(
                G, spans[i + 1][0], spans[i + 1][1], block, dtype, sharding
            )
        write(lo, hi, res)  # np.asarray readback synchronizes block i


def bulkscan_streamed(
    Y,
    G,
    K,
    covar=None,
    *,
    method: str = "null-grid",
    marker_block=None,
    h2_grid=None,
    add_intercept: bool = True,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    solve_method: str = "qr",
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    output_pvals: bool = False,
    chisq_df: int = 1,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    out=None,
    out_pvals=None,
    engine: str = "auto",
    output_effects: bool = False,
    mesh=None,
    missing: str = "error",
) -> BulkScanResult:
    """Bulk scan over a HOST-resident genotype panel, streamed in marker
    blocks — for p too large to hold (n, p) genotypes or the (p, m) LOD
    matrix on device.

    ``mesh`` (optional ``jax.sharding.Mesh`` from
    ``bulklmm_tpu.parallel.make_mesh``) composes streaming with the device
    mesh: each uploaded marker block is placed ``P(None, "markers")`` and
    trait columns ``P(None, "traits")``, so every per-block kernel runs
    sharded — the p-beyond-one-HBM axis and the multi-chip axis scale
    together. Numerics are unchanged (same kernels, placement only).

    ``G`` is any sliceable host (n, p) array — plain numpy or ``np.memmap``.
    ``out`` (optional) receives the (p, m) LODs; pass an ``np.memmap`` when
    the result exceeds host RAM (same for ``out_pvals`` when
    ``output_pvals=True`` — p-values are computed block-by-block on the
    host, never materializing the LOD matrix on device). ``engine``
    selects the alt-grid implementation exactly as in :func:`bulkscan`
    ("auto" uses the fused Pallas kernel per block on a GPU).
    ``output_effects`` (null methods) streams the (p, m) GLS effects +
    Wald SEs alongside the LODs from the same per-block kernel pass.
    Keyword surface otherwise mirrors :func:`bulkscan` (same engines and
    numerics
    — each block goes through the identical kernels), minus ``weights``
    (pre-scale with the in-memory API) and ``trait_chunk`` (size
    ``marker_block`` instead). Returns a :class:`BulkScanResult` whose
    ``L`` is the host output array.
    """
    from .bulkscan import _scan_common_inputs
    from .missing import finite_flag, raise_if_missing

    masked = _masked_streamed(
        Y, G, K, covar, missing=missing, out=out, out_pvals=out_pvals,
        add_intercept=add_intercept, output_pvals=output_pvals,
        precision=precision,
        kwargs=dict(
            method=method, marker_block=marker_block, h2_grid=h2_grid,
            prior_variance=prior_variance,
            prior_sample_size=prior_sample_size, reml=reml,
            solve_method=solve_method, optim_interval=optim_interval,
            decomp_scheme=decomp_scheme, output_pvals=output_pvals,
            chisq_df=chisq_df, precision=precision, engine=engine,
            output_effects=output_effects, mesh=mesh,
        ),
    )
    if masked is not None:
        return masked

    _finite = finite_flag(Y)  # background guard, checked at return
    n, p = G.shape[0], G.shape[1]
    Y, covar, h2_grid, add_intercept = _scan_common_inputs(
        Y, covar, h2_grid, add_intercept, method=method, engine=engine
    )
    m = Y.shape[1]
    if add_intercept:
        covar = jnp.concatenate([jnp.ones((n, 1), dtype=covar.dtype), covar], axis=1)
    prior = (float(prior_variance), float(prior_sample_size))
    _check_output_effects(output_effects, method)

    dtype = precision.resolve_solve()
    if marker_block is None:
        # OOM-free default: size the block from the device budget +
        # footprint model (utils/memory.py); explicit ints are honored
        from ..utils.memory import auto_marker_block

        marker_block = auto_marker_block(
            n, m, itemsize=np.dtype(dtype).itemsize,
            n_outputs=1 + 2 * int(output_effects) + int(output_pvals),
        )
    block = min(marker_block, p)
    blk_shd = trait_shd = rep_shd = None
    if mesh is not None:
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as _P

        from ..parallel.sharding import MARKERS_AXIS, TRAITS_AXIS, _pad_cols

        # static block width must divide evenly over the markers axis
        block += (-block) % mesh.shape[MARKERS_AXIS]
        blk_shd = NamedSharding(mesh, _P(None, MARKERS_AXIS))
        trait_shd = NamedSharding(mesh, _P(None, TRAITS_AXIS))
        rep_shd = NamedSharding(mesh, _P())
        # trait columns pad to the traits-axis shard count; every host
        # write below slices back to the caller's m
        Y, _ = _pad_cols(jnp.asarray(Y), mesh.shape[TRAITS_AXIS])
    if out is None:
        # default host result dtype follows the kernel dtype so EXACT64
        # runs are not truncated; callers can pass f32 (or a memmap) to
        # halve the footprint
        out = np.empty((p, m), dtype=np.dtype(precision.resolve_kernel()))
    elif out.shape != (p, m):
        raise ValueError(f"out must have shape {(p, m)}, got {out.shape}")
    pv = None
    if out_pvals is not None and not output_pvals:
        raise ValueError("out_pvals requires output_pvals=True")
    if output_pvals:
        pv = (
            out_pvals
            if out_pvals is not None
            else np.empty((p, m), dtype=out.dtype)
        )
        if pv.shape != (p, m):
            raise ValueError(
                f"out_pvals must have shape {(p, m)}, got {pv.shape}"
            )

    eff = (
        (np.empty((p, m), dtype=out.dtype), np.empty((p, m), dtype=out.dtype))
        if output_effects
        else None
    )

    from ..ops.lowrank import LowRankKinship

    if isinstance(K, LowRankKinship):
        if engine == "pallas":
            raise ValueError(
                "engine='pallas' is not available for LowRankKinship inputs "
                "(the rank-k engine is XLA-only)"
            )
        res_lr = _streamed_lowrank(
            Y, G, covar, K, out,
            method=method, block=block, h2_grid=h2_grid, prior=prior,
            reml=reml, optim_interval=optim_interval, precision=precision,
            pv=pv, chisq_df=chisq_df, dtype=dtype, n=n, eff=eff, m_out=m,
            blk_shd=blk_shd, trait_shd=trait_shd, rep_shd=rep_shd,
        )
        raise_if_missing(_finite, "bulkscan_streamed")
        return res_lr

    Ut, lam = resolve_kinship(K, decomp_scheme, dtype)
    Yd = Y.astype(dtype)
    Cd = covar.astype(dtype)
    grid_d = h2_grid.astype(dtype)
    if mesh is not None:
        Yd = jax.device_put(Yd, trait_shd)
        Cd = jax.device_put(Cd, rep_shd)
        Ut = jax.device_put(Ut, rep_shd)
        lam = jax.device_put(lam, rep_shd)
        grid_d = jax.device_put(grid_d, rep_shd)

    if method == "alt-grid":
        from .bulkscan import _altgrid_engine

        if engine == "pallas" and mesh is not None:
            raise ValueError(
                "engine='pallas' does not compose with mesh= for the "
                "streamed alt-grid (the fused block kernel is "
                "single-device); use engine='auto'/'xla' with mesh=, or "
                "drop mesh= for the fused kernel"
            )
        # the fused block kernel is single-device; on a mesh the XLA
        # formulation partitions via sharding propagation instead
        use_pallas = mesh is None and _altgrid_engine(
            engine, precision, h2_grid.shape[0]
        ) == "pallas"
        # HIGHEST rotation: an eager jnp.matmul outside the jitted
        # with_highest_matmul pipelines would run at the backend's default
        # f32 matmul precision (TF32 on a GPU, ~1e-3 LOD)
        hi = jax.lax.Precision.HIGHEST
        Y0 = jnp.matmul(Ut, Yd, precision=hi)
        C0 = jnp.matmul(Ut, Cd, precision=hi)
        h2_panel = np.empty((p, m), dtype=np.float32)

        def write_alt(lo, hi, res):
            Lb, h2b = res
            out[lo:hi] = np.asarray(Lb[: hi - lo, :m])
            h2_panel[lo:hi] = np.asarray(h2b[: hi - lo, :m])
            if pv is not None:
                pv[lo:hi] = lod2log10p(out[lo:hi], chisq_df)

        _stream_loop(
            G, p, block, dtype,
            lambda Xb: _block_alt_grid(
                Y0, Xb, C0, Ut, lam, grid_d,
                prior=prior, reml=reml, precision=precision,
                use_pallas=use_pallas,
            ),
            write_alt,
            sharding=blk_shd,
        )
        result = BulkScanResult(L=out, h2_panel=h2_panel)
    else:
        Y0, C0, h2_list = _fit_h2_rotated(
            Yd, Cd, Ut, lam, grid_d,
            prior=prior, reml=reml, method=method,
            optim_interval=optim_interval, precision=precision,
            solve_method=solve_method,
        )

        def write_null(lo, hi, res):
            if eff is not None:
                Lb, bb, sb = res
                eff[0][lo:hi] = np.asarray(bb[: hi - lo, :m])
                eff[1][lo:hi] = np.asarray(sb[: hi - lo, :m])
            else:
                Lb = res
            out[lo:hi] = np.asarray(Lb[: hi - lo, :m])
            if pv is not None:
                pv[lo:hi] = lod2log10p(out[lo:hi], chisq_df)

        _stream_loop(
            G, p, block, dtype,
            lambda Xb: _block_lods(
                Y0, Xb, C0, Ut, lam, h2_list, precision=precision,
                effects=eff is not None,
            ),
            write_null,
            sharding=blk_shd,
        )
        result = BulkScanResult(L=out, h2_null_list=h2_list[:m])

    if eff is not None:
        result.beta_mat, result.beta_se_mat = eff
    if pv is not None:
        result.log10Pvals_mat = pv
        result.chisq_df = chisq_df
    raise_if_missing(_finite, "bulkscan_streamed")
    return result


def _masked_streamed(Y, G, K, covar, *, missing, out, out_pvals,
                     add_intercept, output_pvals, precision, kwargs):
    """Pattern-grouped complete-case dispatch for the streamed scan
    (models/missing.py semantics). Marker blocks are row-subset LAZILY
    (RowSubsetView — the (n_obs, p) panel is never materialized) and each
    group writes through a column view of the caller's host output, so a
    memmap ``out`` works unchanged. Returns None when Y is complete."""
    from .missing import (
        ColSubsetOut, RowSubsetView, _check_side_inputs, _check_group_sizes,
        _ncov_total, missing_groups, subset_kinship, validate_missing_kwarg,
    )

    validate_missing_kwarg(missing)
    if missing == "error":
        return None
    Yn = np.asarray(Y, dtype=np.float64)
    Yn = Yn[:, None] if Yn.ndim == 1 else Yn
    finite = np.isfinite(Yn)
    if finite.all():
        return None
    _check_side_inputs(covar, None, "bulkscan_streamed")
    groups = missing_groups(finite, drop=(missing == "drop"))
    _check_group_sizes(
        groups, _ncov_total(covar, add_intercept),
        what="bulkscan_streamed", drop=(missing == "drop"),
    )
    p, m = G.shape[1], Yn.shape[1]
    L_full = (
        out if out is not None
        else np.empty((p, m), dtype=np.dtype(precision.resolve_kernel()))
    )
    pv_full = out_pvals if out_pvals is not None else (
        np.empty((p, m), dtype=L_full.dtype) if output_pvals else None
    )
    h2_list = h2_panel = beta = se = None
    covar_n = None if covar is None else np.asarray(covar)
    for rows, traits in groups:
        res = bulkscan_streamed(
            Yn[np.ix_(rows, traits)], RowSubsetView(G, rows),
            subset_kinship(K, rows),
            None if covar_n is None else covar_n[rows],
            add_intercept=add_intercept,
            out=ColSubsetOut(L_full, traits),
            out_pvals=(
                ColSubsetOut(pv_full, traits) if pv_full is not None
                else None
            ),
            **kwargs,
        )
        if res.h2_null_list is not None:
            if h2_list is None:
                h2_list = np.full(m, np.nan)
            h2_list[traits] = np.asarray(res.h2_null_list)
        if res.h2_panel is not None:
            if h2_panel is None:
                h2_panel = np.empty((p, m), dtype=np.float32)
            h2_panel[:, traits] = np.asarray(res.h2_panel)
        if res.beta_mat is not None:
            if beta is None:
                beta = np.empty((p, m), dtype=L_full.dtype)
                se = np.empty((p, m), dtype=L_full.dtype)
            beta[:, traits] = np.asarray(res.beta_mat)
            se[:, traits] = np.asarray(res.beta_se_mat)
    result = BulkScanResult(L=L_full, h2_null_list=h2_list, h2_panel=h2_panel)
    if beta is not None:
        result.beta_mat, result.beta_se_mat = beta, se
    if pv_full is not None:
        result.log10Pvals_mat = pv_full
        result.chisq_df = kwargs["chisq_df"]
    return result


def _pad_block(G, lo, hi, block, dtype, sharding=None):
    """Upload one host marker block, zero-padded to the static block size;
    ``sharding`` (optional NamedSharding) splits the block's marker columns
    over a mesh so downstream kernels run multi-device."""
    Xb = np.asarray(G[:, lo:hi], dtype=np.dtype(dtype).name)
    if Xb.shape[1] < block:
        Xb = np.concatenate(
            [Xb, np.zeros((Xb.shape[0], block - Xb.shape[1]), dtype=Xb.dtype)],
            axis=1,
        )
    return jax.device_put(Xb) if sharding is None else jax.device_put(Xb, sharding)


# ---------------------------------------------------------------------------
# rank-k variant: trait projections once, marker projections per block
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=_STATIC + ("n", "method", "optim_interval"))
@with_highest_matmul
def _lr_trait_fit(Y, C, U, lam, h2_grid, *, n, prior, reml, method,
                  optim_interval, precision):
    from ..ops.lowrank import (
        LowRankKinship, _parts_kwargs, _shared_parts, _trait_side_parts,
        fit_h2_lowrank, grid_null_ell_lowrank,
    )

    kdt = precision.resolve_kernel()
    kw = _parts_kwargs(precision)
    lr = LowRankKinship(U=U, lam=lam)
    base = {**_shared_parts(C, lr, **kw), **_trait_side_parts(Y, C, lr, **kw)}
    lam_k = lam.astype(kdt)
    if method == "alt-grid":
        # the alt path scans the whole grid per marker — a per-trait null
        # fit would be dead compute (its h2_panel carries the argmax)
        h2_list = jnp.zeros((Y.shape[1],), dtype=kdt)
    elif method == "null-exact":
        h2_list = fit_h2_lowrank(
            base, lam_k, prior, n=n, reml=reml, optim_interval=optim_interval
        )
    else:
        ells = grid_null_ell_lowrank(
            base, lam_k, h2_grid.astype(kdt), prior, n=n, reml=reml
        )
        h2_list = h2_grid[jnp.argmax(ells, axis=0)]
    return base, h2_list


def _streamed_lowrank(Y, G, covar, K, out, *, method, block, h2_grid, prior,
                      reml, optim_interval, precision, pv, chisq_df,
                      dtype, n, eff=None, m_out=None,
                      blk_shd=None, trait_shd=None, rep_shd=None):
    m = Y.shape[1] if m_out is None else m_out
    p = G.shape[1]
    Yd = Y.astype(dtype)
    Cd = covar.astype(dtype)
    U = K.U.astype(dtype)
    lam = K.lam.astype(dtype)
    grid_d = h2_grid.astype(dtype)
    if trait_shd is not None:
        # mesh composition: trait columns sharded, the (n, k) factor and
        # covariates replicated; marker blocks arrive P(None, "markers")
        Yd = jax.device_put(Yd, trait_shd)
        Cd = jax.device_put(Cd, rep_shd)
        U = jax.device_put(U, rep_shd)
        lam = jax.device_put(lam, rep_shd)
        grid_d = jax.device_put(grid_d, rep_shd)

    tbase, h2_list = _lr_trait_fit(
        Yd, Cd, U, lam, grid_d,
        n=n, prior=prior, reml=reml, method=method,
        optim_interval=optim_interval, precision=precision,
    )
    # the streamed blocks need XtY (pb, m): keep the trait block resident
    # and fold it into the per-block parts inside _lr_block_with_y
    h2_panel = np.empty((p, m), dtype=np.float32) if method == "alt-grid" else None
    alt = method == "alt-grid"

    def write(lo, hi, res):
        if alt:
            Lb, h2b = res
            h2_panel[lo:hi] = np.asarray(h2b[: hi - lo, :m])
        elif eff is not None:
            Lb, bb, sb = res
            eff[0][lo:hi] = np.asarray(bb[: hi - lo, :m])
            eff[1][lo:hi] = np.asarray(sb[: hi - lo, :m])
        else:
            Lb = res
        out[lo:hi] = np.asarray(Lb[: hi - lo, :m])
        if pv is not None:
            pv[lo:hi] = lod2log10p(out[lo:hi], chisq_df)

    _stream_loop(
        G, p, block, dtype,
        lambda Xb: _lr_block_with_y(
            Xb, Yd, Cd, U, lam, tbase, grid_d if alt else h2_list,
            n=n, prior=prior, reml=reml, precision=precision, alt=alt,
            effects=eff is not None,
        ),
        write,
        sharding=blk_shd,
    )
    if method == "alt-grid":
        result = BulkScanResult(L=out, h2_panel=h2_panel)
    else:
        result = BulkScanResult(L=out, h2_null_list=h2_list[:m])
        if eff is not None:
            result.beta_mat, result.beta_se_mat = eff
    if pv is not None:
        result.log10Pvals_mat = pv
        result.chisq_df = chisq_df
    return result


@partial(jax.jit, static_argnames=_STATIC + ("n", "alt", "effects"))
@with_highest_matmul
def _lr_block_with_y(Xb, Y, C, U, lam, tbase, h2_or_grid, *, n, prior, reml,
                     precision, alt=False, effects=False):
    from ..ops.lowrank import (
        LowRankKinship, _alt_grid_lowrank, _marker_side_parts, _parts_kwargs,
        lods_and_effects_lowrank, lods_per_trait_lowrank,
    )

    lr = LowRankKinship(U=U, lam=lam)
    kw = _parts_kwargs(precision)
    kdt = precision.resolve_kernel()
    gd, pgp = kw["gemm_dtype"], kw["gemm_precision"]
    # marker-side projections only; the trait-side and covariate-only parts
    # (R, CtC, CtY, Q, yty) were computed once in _lr_trait_fit
    mparts = _marker_side_parts(Xb, C, lr, **kw)
    XtY = jnp.matmul(Xb.astype(gd).T, Y.astype(gd), precision=pgp).astype(kdt)
    parts = {**mparts, **tbase, "XtY": XtY}
    lam_k = lam.astype(kdt)
    if alt:
        return _alt_grid_lowrank(
            parts, lam_k, h2_or_grid.astype(kdt), prior,
            n=n, precision=precision, reml=reml,
        )
    if effects:
        return lods_and_effects_lowrank(
            parts, lam_k, h2_or_grid.astype(kdt), n, precision=precision
        )
    return lods_per_trait_lowrank(
        parts, lam_k, h2_or_grid.astype(kdt), n, precision=precision
    )


@partial(jax.jit, static_argnames=())
@with_highest_matmul
def _rotate_block(Ut, Xb, C):
    """Rotated marker block without its covariate span, as
    models/bulkperm.py::_bulkperm_prep hands the permutation engines."""
    return decovariate(jnp.matmul(Ut, Xb), jnp.matmul(Ut, C))


def bulkscan_perms_streamed(
    Y,
    G,
    K,
    covar=None,
    *,
    nperms: int = 1000,
    rndseed: int = 0,
    method: str = "null-grid",
    h2_grid=None,
    marker_block=None,
    add_intercept: bool = True,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    solve_method: str = "qr",
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    precision: PrecisionConfig = DEFAULT_PRECISION,
    engine: str = "auto",
    trait_chunk=None,
    perm_chunk: int = 2048,
    original: bool = True,
    tile_p: int = 64,
    interpret: bool = False,
    checkpoint=None,
    checkpoint_every: int = 1,
    mesh=None,
    missing: str = "error",
):
    """All-trait permutation maxima over a HOST-resident marker panel,
    streamed in marker blocks — for p too large to hold (n, p) genotypes on
    device.

    ``mesh`` (optional ``jax.sharding.Mesh`` from
    ``bulklmm_tpu.parallel.make_mesh``) composes the streamed sweep with
    the device mesh — the large-p-beyond-HBM x multi-chip x permutations
    configuration (biobank FWER thresholds). Layout follows
    ``bulkscan_perms_sharded``: traits shard the traits axis, permutation
    columns the markers axis (each MB-scale marker block is replicated, so
    the genome-wide max over markers stays device-local and the hot path is
    collective-free); the (m, 1+nperms) running-max accumulator lives as
    trait x perm tiles sharded over the mesh. ``perm_chunk`` is then the
    PER-DEVICE permutation width, as in ``bulkscan_perms_sharded``.
    Numerics are unchanged — same chunk cores, placement only — and
    checkpointing works identically.

    Same numerics as :func:`bulklmm_tpu.bulkscan_perms` (shared chunk
    core): LOD is monotone in r^2, so the genome-wide maxima accumulate as
    an elementwise running max over marker blocks — the (m, 1+nperms)
    device accumulator is the ONLY marker-extensive state, and each block
    goes through the identical fused kernel (Pallas on a GPU) or XLA path.
    ``G`` is any sliceable host (n, p) array — plain numpy or
    ``np.memmap``. A :class:`~bulklmm_tpu.ops.lowrank.LowRankKinship`
    ``K`` runs the rank-k Woodbury whitening engine per block (no n x n
    kinship, no host eigh, markers streamed from host — the large-n AND
    large-p configuration; XLA engine only).

    ``checkpoint`` (directory) makes the sweep preemption-safe: the (m,
    1+nperms) running-max accumulator + a marker-block cursor persist
    atomically every ``checkpoint_every`` marker blocks (and after the
    final one); re-running the same call resumes from the last persisted
    block (models/bulkperm.py::_PermCheckpoint — a config or input-data
    mismatch is refused). Each save is a full device->host sync plus an
    O(m x nperms) atomic rewrite — at biobank scale that can dominate the
    block pipeline, so raise ``checkpoint_every`` for large sweeps; resume
    redoes at most the trailing unsaved blocks (max is idempotent).
    """
    from ..ops.bulkperm import permutation_indices
    from ..ops.lowrank import LowRankKinship
    from .bulkperm import (
        BulkPermResult, _attach_adj_pvals, _bulkperm_chunk,
        _bulkperm_prep_traits, _default_trait_chunk, _perm_common_inputs,
        _resolve_perm_engine,
    )

    if isinstance(K, LowRankKinship) and engine == "pallas":
        raise ValueError(
            "engine='pallas' is not available for LowRankKinship inputs "
            "(the fused kernel assumes the rotated basis's diagonal "
            "whitening); use engine='xla' or 'auto'."
        )
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    from .missing import (
        RowSubsetView, finite_flag, group_checkpoint, maybe_masked,
        raise_if_missing, subset_kinship,
    )

    masked = maybe_masked(
        Y, missing,
        lambda Ys, rows, traits, gi: bulkscan_perms_streamed(
            Ys, RowSubsetView(G, rows), subset_kinship(K, rows),
            None if covar is None else np.asarray(covar)[rows],
            nperms=nperms, rndseed=rndseed, method=method, h2_grid=h2_grid,
            marker_block=marker_block, add_intercept=add_intercept,
            prior_variance=prior_variance,
            prior_sample_size=prior_sample_size, reml=reml,
            solve_method=solve_method, optim_interval=optim_interval,
            decomp_scheme=decomp_scheme, precision=precision, engine=engine,
            trait_chunk=trait_chunk, perm_chunk=perm_chunk,
            original=original, tile_p=tile_p, interpret=interpret,
            checkpoint=group_checkpoint(checkpoint, gi),
            checkpoint_every=checkpoint_every, mesh=mesh,
        ),
        covar=covar, add_intercept=add_intercept,
        what="bulkscan_perms_streamed",
    )
    if masked is not None:
        return masked
    _finite = finite_flag(Y)  # background guard, checked at return
    from .bulkperm import _data_fingerprint

    data_digest = (
        _data_fingerprint(Y, G, covar, K)
        if checkpoint is not None else None
    )
    Y, _, K, covar, h2_grid, prior = _perm_common_inputs(
        Y, G, K, covar, method=method, engine=engine, h2_grid=h2_grid,
        weights=None, add_intercept=add_intercept,
        prior_variance=prior_variance, prior_sample_size=prior_sample_size,
    )
    n, m = Y.shape
    p = G.shape[1]
    dtype = precision.resolve_solve()
    if marker_block is None:
        from ..utils.memory import auto_marker_block

        marker_block = auto_marker_block(
            n, m, itemsize=np.dtype(dtype).itemsize,
        )
    block = min(marker_block, p)

    if mesh is not None:
        res_m = _perms_streamed_sharded(
            Y, G, K, covar, h2_grid, prior, mesh,
            nperms=nperms, rndseed=rndseed, method=method, block=block,
            reml=reml, solve_method=solve_method,
            optim_interval=optim_interval, decomp_scheme=decomp_scheme,
            precision=precision, trait_chunk=trait_chunk,
            perm_chunk=perm_chunk, original=original, tile_p=tile_p,
            interpret=interpret, engine=engine, checkpoint=checkpoint,
            checkpoint_every=checkpoint_every, data_digest=data_digest,
        )
        raise_if_missing(_finite, "bulkscan_perms_streamed")
        return res_m

    if isinstance(K, LowRankKinship):
        res_lr = _perms_streamed_lowrank(
            Y, G, K, covar, h2_grid, prior,
            nperms=nperms, rndseed=rndseed, method=method, block=block,
            reml=reml, optim_interval=optim_interval, precision=precision,
            trait_chunk=trait_chunk, perm_chunk=perm_chunk,
            original=original, checkpoint=checkpoint,
            checkpoint_every=checkpoint_every, data_digest=data_digest,
        )
        raise_if_missing(_finite, "bulkscan_perms_streamed")
        return res_lr

    Ut, lam = resolve_kinship(K, decomp_scheme, dtype)
    h2_list, sigma2_list, sqrtw, Qstack, wrn = _bulkperm_prep_traits(
        Y.astype(dtype), covar.astype(dtype), Ut, lam, h2_grid.astype(dtype),
        prior=prior, reml=reml, method=method, solve_method=solve_method,
        optim_interval=optim_interval, precision=precision,
    )

    eng, cap = _resolve_perm_engine(
        engine, n, precision=precision, interpret=interpret,
        p=block, trait_block=trait_chunk,
    )
    perm_chunk = min(perm_chunk, cap)
    if trait_chunk is None:
        trait_chunk = _default_trait_chunk(eng)

    idx = permutation_indices(n, nperms, rndseed, original=original)
    K_total = int(idx.shape[0])

    # per-(trait chunk, perm chunk) device accumulators; marker blocks fold
    # in via elementwise max (monotone in r^2), zero-padded block columns
    # contribute r^2 = 0 and never win
    from .bulkperm import (
        _bulkperm_chunk_pallas, _bulkperm_chunk_xla, _bulkperm_pallas_trait_block,
        _bulkperm_xla_trait_block,
    )

    acc = {}
    spans = list(_blocks(p, block))
    ck, blocks_done = _stream_perm_ckpt(
        checkpoint, acc, n=n, m=m, p=p, nperms=nperms, rndseed=rndseed,
        method=method, reml=reml, original=original, trait_chunk=trait_chunk,
        h2_grid=h2_grid, prior=prior, perm_chunk=perm_chunk, block=block,
        K_total=K_total, rank="full-streamed",
        precision=precision, engine=eng, data_digest=data_digest,
    )
    for bi, (lo, hi) in enumerate(spans):
        if bi < blocks_done:
            continue
        X0b = _rotate_block(
            Ut, _pad_block(G, lo, hi, block, dtype), covar.astype(dtype)
        )
        for ms in range(0, m, trait_chunk):
            me = min(ms + trait_chunk, m)
            mb = me - ms
            sw_b, Q_b, wrn_b = sqrtw[ms:me], Qstack[ms:me], wrn[:, ms:me]
            if eng == "pallas" and mb % 8:
                pad = -mb % 8
                sw_b = jnp.pad(sw_b, ((0, pad), (0, 0)))
                Q_b = jnp.pad(Q_b, ((0, pad), (0, 0), (0, 0)))
                wrn_b = jnp.pad(wrn_b, ((0, 0), (0, pad)))
            if eng == "xla":
                pXs, xns = _bulkperm_xla_trait_block(
                    X0b, sw_b, Q_b, precision=precision
                )
            elif eng == "pallas":
                # perm-independent inv_xn hoisted out of the chunk loop
                # (per marker block — X0b changes per block)
                inv_xn = _bulkperm_pallas_trait_block(
                    X0b, sw_b, Q_b, precision=precision
                )
            for ks in range(0, K_total, perm_chunk):
                ke = min(ks + perm_chunk, K_total)
                if eng == "xla":
                    blk = _bulkperm_chunk_xla(
                        X0b, sw_b, Q_b, pXs, xns, wrn_b, idx[ks:ke],
                        n=n, precision=precision,
                    )[:mb]
                else:  # eng == "pallas" (_resolve_perm_engine returns only xla/pallas)
                    blk = _bulkperm_chunk_pallas(
                        X0b, sw_b, Q_b, inv_xn, wrn_b, idx[ks:ke],
                        n=n, precision=precision,
                        tile_p=tile_p, interpret=interpret,
                    )[:mb]
                key = (ms, ks)
                acc[key] = blk if key not in acc else jnp.maximum(acc[key], blk)
        # cadence: a save is a full device sync + O(m*K) atomic rewrite —
        # do it every `checkpoint_every` blocks (and after the last)
        if ck is not None and (
            (bi + 1) % checkpoint_every == 0 or bi == len(spans) - 1
        ):
            ck.save_state(
                _assemble_perm_acc(acc, m, trait_chunk, K_total, perm_chunk),
                bi + 1,
            )

    raise_if_missing(_finite, "bulkscan_perms_streamed")
    return _attach_adj_pvals(BulkPermResult(
        maxlods=_assemble_perm_acc(acc, m, trait_chunk, K_total, perm_chunk),
        h2_null_list=h2_list,
        sigma2_e_list=sigma2_list,
        nperms=nperms,
        original=original,
    ))


def _assemble_perm_acc(acc, m, trait_chunk, K_total, perm_chunk):
    """Stitch the per-(trait chunk, perm chunk) running-max accumulators
    into the (m, K_total) maxima matrix (device concatenations only)."""
    trait_rows = []
    for ms in range(0, m, trait_chunk):
        cols = [acc[(ms, ks)] for ks in range(0, K_total, perm_chunk)]
        trait_rows.append(
            cols[0] if len(cols) == 1 else jnp.concatenate(cols, axis=1)
        )
    return (
        trait_rows[0] if len(trait_rows) == 1
        else jnp.concatenate(trait_rows, axis=0)
    )


def _stream_perm_ckpt(checkpoint, acc, *, n, m, p, nperms, rndseed, method,
                      reml, original, trait_chunk, h2_grid, prior,
                      perm_chunk, block, K_total, rank,
                      precision=None, engine=None, data_digest=None):
    """Checkpoint handle + resume seed for the streamed perm engines:
    loads the persisted (m, K) running-max state into the per-(trait,
    perm)-chunk accumulator dict and returns (handle, blocks_done)."""
    if checkpoint is None:
        return None, 0
    from .bulkperm import _perm_checkpoint

    ck = _perm_checkpoint(
        checkpoint, n=n, m=m, p=p, nperms=nperms, rndseed=rndseed,
        method=method, reml=reml, original=original,
        trait_chunk=trait_chunk, h2_grid=h2_grid, prior=prior,
        # the streamed engine's resume state additionally depends on the
        # block/perm-chunk tiling — fold it into the fingerprint
        rank=f"{rank}-b{block}-pc{perm_chunk}",
        precision=precision, engine=engine, data_digest=data_digest,
    )
    st = ck.load_state()
    if st is None:
        return ck, 0
    maxima, blocks_done = st
    for ms in range(0, m, trait_chunk):
        me = min(ms + trait_chunk, m)
        for ks in range(0, K_total, perm_chunk):
            ke = min(ks + perm_chunk, K_total)
            acc[(ms, ks)] = jnp.asarray(maxima[ms:me, ks:ke])
    return ck, blocks_done


def _perms_streamed_lowrank(
    Y, G, lr, covar, h2_grid, prior, *,
    nperms, rndseed, method, block, reml, optim_interval, precision,
    trait_chunk, perm_chunk, original, checkpoint=None,
    checkpoint_every: int = 1, data_digest=None,
):
    """Rank-k body of :func:`bulkscan_perms_streamed`: Woodbury whitening
    in standard coordinates per HOST marker block (models/bulkperm.py
    chunk core); zero-padded block columns have zero norms and zero
    numerators, so they contribute r^2 = 0 and never win the max."""
    from ..ops.bulkperm import lowrank_perm_chunk_cap, permutation_indices
    from .bulkperm import (
        BulkPermResult, _attach_adj_pvals, _bulkperm_chunk_lowrank,
        _bulkperm_lr_marker_prep, _bulkperm_lr_trait_block,
        _bulkperm_prep_traits_lowrank,
    )

    n, m = Y.shape
    p = G.shape[1]
    dtype = precision.resolve_solve()
    U = jnp.asarray(lr.U, dtype=dtype)
    lam = jnp.asarray(lr.lam, dtype=dtype)

    h2_list, sigma2_list, sm1, Qstack, wrn = _bulkperm_prep_traits_lowrank(
        Y.astype(dtype), covar.astype(dtype), U, lam, h2_grid.astype(dtype),
        n=n, prior=prior, reml=reml, method=method,
        optim_interval=optim_interval, precision=precision,
    )
    if trait_chunk is None:
        trait_chunk = 16
    perm_chunk = min(
        perm_chunk, lowrank_perm_chunk_cap(n, block, trait_chunk=trait_chunk)
    )
    idx = permutation_indices(n, nperms, rndseed, original=original)
    K_total = int(idx.shape[0])

    acc = {}
    spans = list(_blocks(p, block))
    ck, blocks_done = _stream_perm_ckpt(
        checkpoint, acc, n=n, m=m, p=p, nperms=nperms, rndseed=rndseed,
        method=method, reml=reml, original=original, trait_chunk=trait_chunk,
        h2_grid=h2_grid, prior=prior, perm_chunk=perm_chunk, block=block,
        K_total=K_total, rank=f"lowrank{lr.rank}-streamed",
        precision=precision, engine="xla", data_digest=data_digest,
    )
    for bi, (lo, hi) in enumerate(spans):
        if bi < blocks_done:
            continue
        Xb = _pad_block(G, lo, hi, block, dtype)
        UtX, UtX2, xsq = _bulkperm_lr_marker_prep(Xb, U, precision=precision)
        for ms in range(0, m, trait_chunk):
            me = min(ms + trait_chunk, m)
            sm1_b, Q_b = sm1[ms:me], Qstack[ms:me]
            qXs, xns = _bulkperm_lr_trait_block(
                Xb, U, UtX, UtX2, xsq, sm1_b, Q_b, precision=precision
            )
            for ks in range(0, K_total, perm_chunk):
                ke = min(ks + perm_chunk, K_total)
                blk = _bulkperm_chunk_lowrank(
                    Xb, U, UtX, sm1_b, Q_b, qXs, xns, wrn[:, ms:me],
                    idx[ks:ke], n=n, precision=precision,
                )
                key = (ms, ks)
                acc[key] = (
                    blk if key not in acc else jnp.maximum(acc[key], blk)
                )
        if ck is not None and (
            (bi + 1) % checkpoint_every == 0 or bi == len(spans) - 1
        ):
            ck.save_state(
                _assemble_perm_acc(acc, m, trait_chunk, K_total, perm_chunk),
                bi + 1,
            )

    return _attach_adj_pvals(BulkPermResult(
        maxlods=_assemble_perm_acc(acc, m, trait_chunk, K_total, perm_chunk),
        h2_null_list=h2_list,
        sigma2_e_list=sigma2_list,
        nperms=nperms,
        original=original,
    ))


def _perms_streamed_sharded(
    Y, G, K, covar, h2_grid, prior, mesh, *,
    nperms, rndseed, method, block, reml, solve_method, optim_interval,
    decomp_scheme, precision, trait_chunk, perm_chunk, original,
    tile_p, interpret, engine, checkpoint=None, checkpoint_every: int = 1,
    data_digest=None,
):
    """Mesh body of :func:`bulkscan_perms_streamed`: host marker blocks x
    device mesh x permutations — the biobank FWER composition.

    Per HOST marker block the same shard_map chunk cores as
    ``bulkscan_perms_sharded`` run (device (i, j) owns trait shard i x
    permutation shard j against the replicated block; the max over the
    block's markers is device-local, collective-free), and block results
    fold into the trait x perm accumulator tiles by elementwise max (LOD is
    monotone in r^2). Trait-side tensors are placed on the mesh ONCE and
    reused by every block. Supports dense kinships (full-rank rotation,
    fused Pallas or XLA chunk core per device) and
    :class:`~bulklmm_tpu.ops.lowrank.LowRankKinship` (Woodbury whitening,
    XLA core). Reference capability being scaled: src/scan.jl:485-557.
    """
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as _P

    from ..ops.bulkperm import permutation_indices
    from ..ops.lowrank import LowRankKinship
    from ..parallel.sharding import (
        MARKERS_AXIS, TRAITS_AXIS, _bulkperm_lr_block_fn,
        _bulkperm_lr_chunk_fn,
    )
    from .bulkperm import (
        BulkPermResult, _attach_adj_pvals, _bulkperm_lr_marker_prep,
        _bulkperm_prep_traits, _bulkperm_prep_traits_lowrank,
    )

    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    n, m = Y.shape
    p = G.shape[1]
    dtype = precision.resolve_solve()
    tshards = mesh.shape[TRAITS_AXIS]
    mshards = mesh.shape[MARKERS_AXIS]
    lowrank = isinstance(K, LowRankKinship)
    rep = NamedSharding(mesh, _P(None, None))

    if lowrank:
        from ..ops.bulkperm import lowrank_perm_chunk_cap

        U = jax.device_put(jnp.asarray(K.U, dtype=dtype), rep)
        lam = jnp.asarray(K.lam, dtype=dtype)
        h2_list, sigma2_list, sm1, Qstack, wrn = (
            _bulkperm_prep_traits_lowrank(
                Y.astype(dtype), covar.astype(dtype), U, lam,
                h2_grid.astype(dtype),
                n=n, prior=prior, reml=reml, method=method,
                optim_interval=optim_interval, precision=precision,
            )
        )
        eng = "xla"
        quantum = tshards
        row_quant = mshards
        if trait_chunk is None:
            trait_chunk = 16 * tshards
        trait_chunk += (-trait_chunk) % quantum
        pc_dev = min(
            perm_chunk,
            lowrank_perm_chunk_cap(
                n, block, trait_chunk=-(-trait_chunk // tshards)
            ),
        )
        blockfn = _bulkperm_lr_block_fn(mesh, precision)
        runfn = _bulkperm_lr_chunk_fn(mesh, n, precision)
        rank_tag = f"lowrank{K.rank}-streamed-sharded"
    else:
        Ut, lam = resolve_kinship(K, decomp_scheme, dtype)
        h2_list, sigma2_list, sqrtw, Qstack, wrn = _bulkperm_prep_traits(
            Y.astype(dtype), covar.astype(dtype), Ut, lam,
            h2_grid.astype(dtype),
            prior=prior, reml=reml, method=method, solve_method=solve_method,
            optim_interval=optim_interval, precision=precision,
        )
        # engine + tiling quanta from the SAME helper as the in-HBM mesh
        # engine (parallel/sharding.py::_mesh_perm_tiling — per-device
        # memory caps see the per-device trait block against one
        # replicated marker block)
        from ..parallel.sharding import _mesh_perm_tiling

        eng, trait_chunk, pc_dev, quantum, row_quant = _mesh_perm_tiling(
            mesh, engine=engine, n=n, p=block, precision=precision,
            interpret=interpret, trait_chunk=trait_chunk,
            perm_chunk=perm_chunk,
        )
        Ut = jax.device_put(Ut, rep)
        from ..parallel.sharding import (
            _bulkperm_fr_block_fn, _bulkperm_fr_chunk_fn,
        )

        blockfn = _bulkperm_fr_block_fn(mesh, eng, precision)
        runfn = _bulkperm_fr_chunk_fn(mesh, eng, n, precision, tile_p, interpret)
        rank_tag = "full-streamed-sharded"

    chunk_glob = pc_dev * mshards
    idx = permutation_indices(n, nperms, rndseed, original=original)
    K_total = int(idx.shape[0])

    # permutation chunks padded/placed by the shared helper; placed on the
    # mesh ONCE, reused by every marker block
    from ..parallel.sharding import _mesh_perm_idx_chunks

    idx_chunks = [
        (ci * chunk_glob, idx_blk, kw)
        for ci, (idx_blk, kw) in enumerate(_mesh_perm_idx_chunks(
            idx, mesh, chunk_glob=chunk_glob, row_quant=row_quant
        ))
    ]

    # trait-side tensors: marker-independent, placed on the mesh once
    tparts = []
    for ms in range(0, m, trait_chunk):
        me = min(ms + trait_chunk, m)
        mb = me - ms
        lead_b = (sm1 if lowrank else sqrtw)[ms:me]
        Q_b, wrn_b = Qstack[ms:me], wrn[:, ms:me]
        if mb % quantum:
            pad = -mb % quantum
            lead_b = jnp.pad(lead_b, ((0, pad), (0, 0)))
            Q_b = jnp.pad(Q_b, ((0, pad), (0, 0), (0, 0)))
            wrn_b = jnp.pad(wrn_b, ((0, 0), (0, pad)))
        tparts.append((
            ms, mb,
            jax.device_put(lead_b, NamedSharding(mesh, _P(TRAITS_AXIS, None))),
            jax.device_put(
                Q_b, NamedSharding(mesh, _P(TRAITS_AXIS, None, None))
            ),
            jax.device_put(wrn_b, NamedSharding(mesh, _P(None, TRAITS_AXIS))),
        ))

    acc = {}
    spans = list(_blocks(p, block))
    ck, blocks_done = _stream_perm_ckpt(
        checkpoint, acc, n=n, m=m, p=p, nperms=nperms, rndseed=rndseed,
        method=method, reml=reml, original=original, trait_chunk=trait_chunk,
        h2_grid=h2_grid, prior=prior, perm_chunk=chunk_glob, block=block,
        K_total=K_total, rank=rank_tag,
        precision=precision, engine=eng, data_digest=data_digest,
    )
    for bi, (lo, hi) in enumerate(spans):
        if bi < blocks_done:
            continue
        Xb = _pad_block(G, lo, hi, block, dtype, rep)
        if lowrank:
            UtX, UtX2, xsq = _bulkperm_lr_marker_prep(Xb, U, precision=precision)
            UtX = jax.device_put(UtX, rep)
            UtX2 = jax.device_put(UtX2, rep)
            xsq = jax.device_put(xsq, NamedSharding(mesh, _P(None)))
        else:
            X0b = _rotate_block(Ut, Xb, covar.astype(dtype))
        for ms, mb, lead_b, Q_b, wrn_b in tparts:
            # permutation-independent parts hoisted per (marker block,
            # trait chunk) — both kinship ranks, both engines
            if lowrank:
                qXs, xns = blockfn(Xb, U, UtX, UtX2, xsq, lead_b, Q_b)
            else:
                parts = blockfn(X0b, lead_b, Q_b)
                parts = parts if isinstance(parts, tuple) else (parts,)
            for ks, idx_blk, kw in idx_chunks:
                if lowrank:
                    blk = runfn(
                        Xb, U, UtX, lead_b, Q_b, qXs, xns, wrn_b, idx_blk
                    )[:mb, :kw]
                else:
                    blk = runfn(
                        X0b, lead_b, Q_b, *parts, wrn_b, idx_blk
                    )[:mb, :kw]
                key = (ms, ks)
                acc[key] = (
                    blk if key not in acc else jnp.maximum(acc[key], blk)
                )
        if ck is not None and (
            (bi + 1) % checkpoint_every == 0 or bi == len(spans) - 1
        ):
            ck.save_state(
                _assemble_perm_acc(acc, m, trait_chunk, K_total, chunk_glob),
                bi + 1,
            )

    return _attach_adj_pvals(BulkPermResult(
        maxlods=_assemble_perm_acc(acc, m, trait_chunk, K_total, chunk_glob),
        h2_null_list=h2_list,
        sigma2_e_list=sigma2_list,
        nperms=nperms,
        original=original,
    ))
