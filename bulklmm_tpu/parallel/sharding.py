"""Sharded scan engines over a (traits x markers) device mesh.

Scaling model (replaces reference src/bulkscan.jl:252-311 thread blocking):

- **traits** axis — the data-parallel axis. ``Y0`` columns (and everything
  derived per-trait: grid log-likelihoods, per-trait h2, LOD columns) are
  sharded; each device owns ``m / n_traits_shards`` traits end-to-end, so the
  only cross-device traffic on this axis is the final result layout.
- **markers** axis — the model-parallel axis for huge genotype panels.
  ``X0`` marker columns are sharded; the (p x m) LOD matrix comes out sharded
  over both axes. The per-trait correlation kernel contracts over the
  (small, replicated) individuals dimension, so no collective is needed in
  the hot GEMM itself.
- **permutations** ride the traits axis: permuted residual columns shard the
  same way trait columns do.

The kinship eigendecomposition (n x n, n small) runs on the host and its
factors are replicated — duplicating an O(n^2) object per device to make the
O(p*m) work collective-free, exactly the replicate-the-small-thing recipe.

Everything goes through ``jax.jit`` with ``NamedSharding`` on the inputs; XLA
propagates the shardings through the (pure-jnp) scan cores and partitions the
GEMMs onto the mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from functools import lru_cache, partial

from ..models.bulkscan import (
    _bulkscan_alt_grid_core,
    _bulkscan_null_exact_core,
    _bulkscan_null_grid_core,
    _check_output_effects,
)
from ..models.results import BulkScanResult, ScanResult
from ..models.scan import _scan_perms_core
from ..ops.rotation import resolve_kinship, transform_rotation
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig

TRAITS_AXIS = "traits"
MARKERS_AXIS = "markers"


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    marker_shards: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ("traits", "markers") mesh over the available devices.

    By default all devices go to the traits axis (trait scaling is perfectly
    parallel); pass ``marker_shards`` to split off a model-parallel axis for
    very large marker panels.
    """
    devs = list(devices) if devices is not None else list(jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    nd = len(devs)
    ms = 1 if marker_shards is None else int(marker_shards)
    if nd % ms != 0:
        raise ValueError(f"marker_shards={ms} must divide device count {nd}")
    arr = np.asarray(devs).reshape(nd // ms, ms)
    return Mesh(arr, (TRAITS_AXIS, MARKERS_AXIS))


def _pad_cols(A: jnp.ndarray, multiple: int) -> Tuple[jnp.ndarray, int]:
    """Zero-pad columns of (n, k) A so k divides the mesh axis; returns (padded, k)."""
    k = A.shape[1]
    rem = (-k) % multiple
    if rem:
        A = jnp.concatenate([A, jnp.zeros((A.shape[0], rem), dtype=A.dtype)], axis=1)
    return A, k


def _core_trait_chunks(core, Ycols, mesh: Mesh, trait_chunk: Optional[int]):
    """Run a sharded bulkscan core over host-side GLOBAL trait chunks.

    Bounds per-device peak memory exactly like the single-device engines'
    chunking (models/bulkscan.py::_chunk_traits): (p, m)-scale
    intermediates exist only at (p, chunk) size per step. Each chunk pads
    up to the traits-axis shard count, is placed ``P(None, "traits")``, and
    the padded columns are sliced off before the along-trait concatenation
    — at most two distinct chunk widths ever compile (body + remainder).

    Returns ``(tuple-of-outputs concatenated along the trait (last) axis,
    m_orig)``; marker-axis padding is the caller's to slice.
    """
    tshards = mesh.shape[TRAITS_AXIS]
    m = Ycols.shape[1]

    def one(block):
        mb = block.shape[1]
        Yp, _ = _pad_cols(block, tshards)
        Ys = jax.device_put(Yp, NamedSharding(mesh, P(None, TRAITS_AXIS)))
        return tuple(x[..., :mb] for x in core(Ys))

    if trait_chunk is None:
        return one(Ycols), m
    tc = max(int(trait_chunk), 1)
    tc += (-tc) % tshards
    chunks = [one(Ycols[:, s : min(s + tc, m)]) for s in range(0, m, tc)]
    if len(chunks) == 1:
        return chunks[0], m
    return tuple(jnp.concatenate(ps, axis=-1) for ps in zip(*chunks)), m


def shard_rotated(y0, X0, lam, n_covars: int, mesh: Mesh):
    """Place rotated data on the mesh: traits sharded, markers sharded,
    covariates + eigenvalues replicated. Pads trait/marker counts up to the
    mesh axis sizes (padding is sliced off the results). Covariates and
    markers stay separate arrays — concatenating then re-slicing would cross
    shard boundaries and force an all-gather of the marker matrix.

    Returns (y0_sharded, X0m_sharded, C0_replicated, lam_replicated,
    m_orig, p_orig).
    """
    tshards = mesh.shape[TRAITS_AXIS]
    mshards = mesh.shape[MARKERS_AXIS]

    y0p, m = _pad_cols(y0, tshards)
    cov = X0[:, :n_covars]
    Xm, p = _pad_cols(X0[:, n_covars:], mshards)

    y0s = jax.device_put(y0p, NamedSharding(mesh, P(None, TRAITS_AXIS)))
    C0s = jax.device_put(cov, NamedSharding(mesh, P(None, None)))
    X0ms = jax.device_put(Xm, NamedSharding(mesh, P(None, MARKERS_AXIS)))
    lams = jax.device_put(lam, NamedSharding(mesh, P(None)))
    return y0s, X0ms, C0s, lams, m, p


@lru_cache(maxsize=None)
def _rotate_markers_sharded(mesh: Mesh, pgp):
    """Mesh-sharded marker rotation: Ut replicated, marker columns sharded
    — each device rotates only the (n, p/mshards) block it will scan."""
    return jax.jit(
        lambda U, X: jnp.matmul(U, X, precision=pgp),
        out_shardings=NamedSharding(mesh, P(None, MARKERS_AXIS)),
    )


def bulkscan_sharded(
    Y,
    G,
    K,
    covar=None,
    *,
    mesh: Optional[Mesh] = None,
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
    output_effects: bool = False,
    trait_chunk: Optional[int] = None,
    missing: str = "error",
) -> BulkScanResult:
    """Multi-trait scan sharded over a device mesh.

    Same numerics as :func:`bulklmm_tpu.bulkscan` (the cores are shared);
    this wrapper only changes data placement. Works on any mesh from
    :func:`make_mesh`, including a multi-host one. ``output_effects``
    attaches the sharded (p, m) GLS effects + Wald SEs (null methods; the
    effects kernel contracts over the replicated individuals axis, so it
    stays collective-free like the LOD kernel). ``trait_chunk`` bounds
    per-device peak memory exactly like the single-device engines'
    chunking (models/bulkscan.py::_chunk_traits): the cores see GLOBAL
    trait blocks of at most ``trait_chunk`` columns (rounded up to the
    traits-axis shard count), so (p, m)-scale intermediates exist only at
    (p, chunk) size per device step.
    """
    if mesh is None:
        mesh = make_mesh()
    _check_output_effects(output_effects, method)

    from ..models.bulkscan import _scan_common_inputs
    from ..models.missing import (
        finite_flag, maybe_masked, raise_if_missing, subset_kinship,
    )

    masked = maybe_masked(
        Y, missing,
        lambda Ys, rows, traits, gi: bulkscan_sharded(
            Ys, np.asarray(G)[rows], subset_kinship(K, rows),
            None if covar is None else np.asarray(covar)[rows],
            mesh=mesh, method=method, h2_grid=h2_grid,
            add_intercept=add_intercept,
            weights=None if weights is None else np.asarray(weights)[rows],
            prior_variance=prior_variance,
            prior_sample_size=prior_sample_size, reml=reml,
            optim_interval=optim_interval, decomp_scheme=decomp_scheme,
            output_pvals=output_pvals, chisq_df=chisq_df,
            solve_method=solve_method, precision=precision,
            output_effects=output_effects, trait_chunk=trait_chunk,
        ),
        covar=covar, weights=weights, add_intercept=add_intercept,
        what="bulkscan_sharded",
    )
    if masked is not None:
        return masked
    _finite = finite_flag(Y)  # background guard, checked at return

    if trait_chunk is None:
        # per-DEVICE auto sizing (utils/memory.py): the sharded cores see
        # global trait blocks of trait_chunk columns, so each device holds
        # ~(p / marker_shards, chunk / trait_shards) slabs — model the
        # per-device footprint and scale the chunk back up to global.
        # Overflow beyond what chunking can fix keeps None (no host-block
        # path on the mesh; more devices is the fix there).
        from ..models.missing import _ncov_total
        from ..utils.memory import auto_trait_chunk

        tr = mesh.shape[TRAITS_AXIS]
        mk = mesh.shape[MARKERS_AXIS]
        _n = np.shape(Y)[0]
        _m = 1 if np.ndim(Y) == 1 else np.shape(Y)[1]
        _p = np.shape(G)[1]
        try:
            mc = auto_trait_chunk(
                _n, max(1, _p // mk), max(1, -(-_m // tr)),
                grid=10 if h2_grid is None else len(h2_grid),
                c=_ncov_total(covar, add_intercept),
                itemsize=max(
                    np.dtype(precision.resolve_solve()).itemsize,
                    np.dtype(precision.resolve_kernel()).itemsize,
                ),
                n_outputs=(1 + (method == "alt-grid")
                           + 2 * int(output_effects) + int(output_pvals)),
            )
        except ValueError:
            mc = None
        trait_chunk = None if mc is None else mc * tr

    Y, covar, h2_grid, add_intercept = _scan_common_inputs(
        Y, covar, h2_grid, add_intercept, method=method, engine="auto"
    )
    G = jnp.asarray(G)
    n = Y.shape[0]

    from ..ops.lowrank import LowRankKinship

    if weights is not None:
        from ..models.scan import _apply_weights
        from ..ops.rotation import KinshipDecomposition

        if isinstance(K, (KinshipDecomposition, LowRankKinship)):
            raise ValueError(
                "weights rescale the kinship matrix (K -> WKW); pass the raw "
                "K, not a cached decomposition."
            )
        Y, G, covar, K, add_intercept = _apply_weights(
            Y, G, covar, K, weights, add_intercept
        )

    prior = (float(prior_variance), float(prior_sample_size))

    if isinstance(K, LowRankKinship):
        # rank-k engine on the mesh: traits/markers sharded, the (n, k)
        # eigenfactor replicated (the replicate-the-small-thing recipe —
        # k << n x n); every base Gram and rank-k correction GEMM contracts
        # over replicated dimensions, so the hot path stays collective-free
        # exactly like the full-rank kernel.
        if method not in ("null-grid", "null-exact", "alt-grid"):
            raise ValueError(
                "method must be one of 'null-grid', 'null-exact', 'alt-grid'"
            )
        from ..ops.lowrank import _bulkscan_lowrank_core

        if add_intercept:
            covar = jnp.concatenate(
                [jnp.ones((n, 1), dtype=covar.dtype), covar], axis=1
            )
        dtype = precision.resolve_solve()
        mshards = mesh.shape[MARKERS_AXIS]
        Gp, p = _pad_cols(G.astype(dtype), mshards)
        Gs = jax.device_put(Gp, NamedSharding(mesh, P(None, MARKERS_AXIS)))
        Cs = jax.device_put(covar.astype(dtype), NamedSharding(mesh, P(None, None)))
        Us = jax.device_put(K.U.astype(dtype), NamedSharding(mesh, P(None, None)))
        lams = jax.device_put(K.lam.astype(dtype), NamedSharding(mesh, P(None)))
        grid = jnp.asarray(h2_grid, dtype=dtype)

        def lr_core(Ys):
            return _bulkscan_lowrank_core(
                Ys, Gs, Cs, Us, lams, grid,
                n=n, prior=prior, reml=reml, precision=precision,
                method=method, optim_interval=optim_interval,
                effects=output_effects and method != "alt-grid",
            )

        out, m = _core_trait_chunks(lr_core, Y.astype(dtype), mesh, trait_chunk)
        if method == "alt-grid":
            result = BulkScanResult(L=out[0][:p], h2_panel=out[1][:p])
        else:
            result = BulkScanResult(L=out[0][:p], h2_null_list=out[1])
            if output_effects:
                # fused: the effects come from the SAME parts pass as the
                # LODs (ops/lowrank.py::lods_and_effects_lowrank)
                result.beta_mat = out[2][:p]
                result.beta_se_mat = out[3][:p]
        if output_pvals:
            from ..ops.lod import lod2log10p

            result.log10Pvals_mat = lod2log10p(result.L, chisq_df)
            result.chisq_df = chisq_df
        raise_if_missing(_finite, "bulkscan_sharded")
        return result

    # rotate the SMALL operands (traits, covariates) on the default device,
    # but the (n, p) marker panel under the mesh: G is device_put sharded
    # over the markers axis with Ut replicated, so each device rotates only
    # its own marker columns — the full rotated panel never materializes on
    # one device (the marker model-parallel axis exists for panels that
    # don't fit one HBM). Column-independent matmul -> numerics identical
    # to the unsharded rotation.
    from ..ops.rotation import KinshipDecomposition

    Ut, lam = resolve_kinship(K, decomp_scheme, precision.resolve_solve())
    rot = transform_rotation(
        Y, covar, KinshipDecomposition(Ut=Ut, lam=lam),
        add_intercept=add_intercept, decomp_scheme=decomp_scheme,
        precision=precision,
    )
    mshards = mesh.shape[MARKERS_AXIS]
    Gp, p = _pad_cols(G.astype(rot.y0.dtype), mshards)
    C0s = jax.device_put(rot.X0, NamedSharding(mesh, P(None, None)))
    lams = jax.device_put(rot.lam, NamedSharding(mesh, P(None)))
    Gs = jax.device_put(Gp, NamedSharding(mesh, P(None, MARKERS_AXIS)))
    Uts = jax.device_put(Ut, NamedSharding(mesh, P(None, None)))
    X0ms = _rotate_markers_sharded(mesh, precision.gemm_precision)(Uts, Gs)

    grid = h2_grid.astype(rot.y0.dtype)
    if method == "null-grid":
        def core(y0s):
            return _bulkscan_null_grid_core(
                y0s, X0ms, C0s, lams, grid,
                prior=prior, reml=reml, method=solve_method,
                precision=precision, effects=output_effects,
            )
    elif method == "null-exact":
        def core(y0s):
            return _bulkscan_null_exact_core(
                y0s, X0ms, C0s, lams,
                prior=prior, reml=reml, method=solve_method,
                optim_interval=optim_interval, precision=precision,
                effects=output_effects,
            )
    elif method == "alt-grid":
        def core(y0s):
            return _bulkscan_alt_grid_core(
                y0s, X0ms, C0s, lams, grid,
                prior=prior, reml=reml, method=solve_method,
                precision=precision,
            )
    else:
        raise ValueError(
            "method must be one of 'null-grid', 'null-exact', 'alt-grid'"
        )
    out, m = _core_trait_chunks(core, rot.y0, mesh, trait_chunk)
    if method == "alt-grid":
        result = BulkScanResult(L=out[0][:p], h2_panel=out[1][:p])
    else:
        result = BulkScanResult(L=out[0][:p], h2_null_list=out[1])
    if output_effects and method != "alt-grid":
        # fused: the effects come from the SAME (c+2)-GEMM parts pass as the
        # LODs (ops/liteqtl.py::lods_and_effects_per_trait)
        result.beta_mat = out[2][:p]
        result.beta_se_mat = out[3][:p]
    if output_pvals:
        from ..ops.lod import lod2log10p

        result.log10Pvals_mat = lod2log10p(result.L, chisq_df)
        result.chisq_df = chisq_df
    raise_if_missing(_finite, "bulkscan_sharded")
    return result


@lru_cache(maxsize=None)
def _scan_perms_sharded_fn(mesh, prior, reml, method, optim_interval,
                           nperms_run, rndseed, precision):
    """Jitted permutation-scan core with OUTPUT shardings constrained
    (markers x perms over the mesh): XLA back-propagates the output
    sharding through the correlation GEMM, partitioning the
    permuted-residual columns over the traits axis — without it the perm
    matrix (built inside the core by transform_permute) stays replicated
    and every device redundantly computes the full scan."""
    from ..models.scan import _scan_perms_impl
    from ..utils.config import with_highest_matmul as _whm

    return jax.jit(
        _whm(partial(
            _scan_perms_impl,
            prior=prior, reml=reml, method=method,
            optim_interval=optim_interval, nperms=nperms_run,
            rndseed=rndseed, precision=precision,
        )),
        out_shardings=(
            NamedSharding(mesh, P()),
            NamedSharding(mesh, P()),
            NamedSharding(mesh, P(MARKERS_AXIS, TRAITS_AXIS)),
        ),
    )


def scan_perms_sharded(
    y,
    g,
    K,
    covar=None,
    *,
    mesh: Optional[Mesh] = None,
    nperms: int = 1024,
    rndseed: int = 0,
    add_intercept: bool = True,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    method: str = "qr",
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    precision: PrecisionConfig = DEFAULT_PRECISION,
) -> ScanResult:
    """Permutation scan with permutation columns sharded over the mesh.

    The permuted-residual matrix (n x nperms+1) takes the traits axis; the
    marker matrix takes the markers axis; the (p x nperms+1) null-LOD matrix
    comes out sharded over both. Threshold extraction
    (:func:`bulklmm_tpu.get_thresholds`) reduces over markers first, so the
    per-permutation maxima need only a markers-axis collective.
    """
    if mesh is None:
        mesh = make_mesh()

    # host numpy float64 until the device casts below: the
    # backend-deterministic null fit must see the untruncated phenotype
    # (jnp.asarray would round to f32 when x64 is off), same as scan()
    y = np.asarray(y, dtype=np.float64)
    y = y[:, None] if y.ndim == 1 else y
    n = y.shape[0]
    # markers stay at native dtype — only y/covar feed the host f64 fit,
    # and an (n, p) f64 copy would double host RAM at cohort scale
    g = np.asarray(g)
    if covar is None:
        covar = np.ones((n, 1))
        add_intercept = False
    else:
        covar = np.asarray(covar, dtype=np.float64)
        covar = covar[:, None] if covar.ndim == 1 else covar
    n_covars = covar.shape[1] + (1 if add_intercept else 0)

    # One host eigendecomposition, shared by the device rotation and the
    # backend-deterministic float64 null fit (ops/hostfit.py) — raw K at
    # cohort scale makes a second O(n^3) eigh the dominant setup cost.
    from ..models.scan import _host_null_fit
    from ..ops.rotation import KinshipDecomposition, resolve_kinship_with_host

    dtype = precision.resolve_solve()
    Ut_d, lam_d, Ut_h, lam_h = resolve_kinship_with_host(K, decomp_scheme, dtype)
    rot = transform_rotation(
        y, jnp.concatenate([covar, g], axis=1),
        KinshipDecomposition(Ut=Ut_d, lam=lam_d),
        add_intercept=add_intercept, decomp_scheme=decomp_scheme, precision=precision,
    )
    design = np.concatenate(
        [np.ones((n, 1))] * (1 if add_intercept else 0)
        + [np.asarray(covar, dtype=np.float64)],
        axis=1,
    )
    null_fit = _host_null_fit(
        np.asarray(y, dtype=np.float64), design, Ut_h, lam_h,
        (float(prior_variance), float(prior_sample_size)),
        reml, optim_interval, dtype,
    )
    # Permutation columns ride the traits axis; nperms+1 must land on a
    # sharding-friendly count, so round the *requested* perms up.
    tshards = mesh.shape[TRAITS_AXIS]
    total = nperms + 1
    total_padded = total + ((-total) % tshards)
    nperms_run = total_padded - 1

    cov = rot.X0[:, :n_covars]
    Xm, p = _pad_cols(rot.X0[:, n_covars:], mesh.shape[MARKERS_AXIS])
    y0s = jax.device_put(rot.y0, NamedSharding(mesh, P(None, None)))
    C0s = jax.device_put(cov, NamedSharding(mesh, P(None, None)))
    X0ms = jax.device_put(Xm, NamedSharding(mesh, P(None, MARKERS_AXIS)))
    lams = jax.device_put(rot.lam, NamedSharding(mesh, P(None)))

    core = _scan_perms_sharded_fn(
        mesh, (float(prior_variance), float(prior_sample_size)),
        reml, method, optim_interval, nperms_run, rndseed, precision,
    )
    sigma2_e, h2_null, L = core(y0s, X0ms, C0s, lams, null_fit)
    L = L[:p, : nperms + 1]
    return ScanResult(sigma2_e=sigma2_e, h2_null=h2_null, lod=L[:, 0], L_perms=L[:, 1:])


def _mesh_perm_tiling(
    mesh, *, engine, n, p, precision, interpret, trait_chunk, perm_chunk,
):
    """Engine choice + tiling quanta for a dense-kinship (traits x markers)
    mesh permutation sweep — the ONE place the per-device trait quantum
    (the fused kernel's 8-trait programs), the markers-axis perm-row quantum,
    the trait-chunk default, and the per-device perm-width cap are
    computed. Shared by :func:`bulkscan_perms_sharded` and the streamed
    composition (models/streaming.py::_perms_streamed_sharded) so the two
    mesh engines' tilings cannot desynchronize.

    Returns ``(eng, trait_chunk, pc_dev, quantum, row_quant)``.
    """
    from ..models.bulkperm import _default_trait_chunk, _resolve_perm_engine

    tshards = mesh.shape[TRAITS_AXIS]
    mshards = mesh.shape[MARKERS_AXIS]
    # engine keys off the MESH's devices, not the session default backend;
    # the memory cap sees the PER-DEVICE trait block (trait_chunk rounded
    # UP to a tshards multiple) against the replicated panel
    eng, cap = _resolve_perm_engine(
        engine, n, precision=precision, interpret=interpret, p=p,
        device=mesh.devices.flat[0],
        trait_block=(
            None if trait_chunk is None else max(1, -(-trait_chunk // tshards))
        ),
    )
    quantum = tshards * (8 if eng == "pallas" else 1)
    if trait_chunk is None:
        trait_chunk = _default_trait_chunk(eng) * tshards
    trait_chunk += (-trait_chunk) % quantum
    return eng, trait_chunk, min(perm_chunk, cap), quantum, mshards


def _mesh_perm_idx_chunks(idx, mesh, *, chunk_glob, row_quant):
    """Split the (K_total, n) permutation-index matrix into global chunks,
    pad each to the markers-axis quantum with identity-permutation rows
    (their columns are sliced off by the caller), and place on the mesh.
    Returns ``[(device_idx_block, true_width), ...]`` — placed ONCE,
    reusable across marker blocks."""
    K_total = int(idx.shape[0])
    out = []
    for ks in range(0, K_total, chunk_glob):
        blk = idx[ks:min(ks + chunk_glob, K_total)]
        k_pad = (-blk.shape[0]) % row_quant
        if k_pad:
            blk = jnp.concatenate(
                [blk, jnp.tile(idx[:1], (k_pad, 1))], axis=0
            )
        out.append((
            jax.device_put(blk, NamedSharding(mesh, P(MARKERS_AXIS, None))),
            min(ks + chunk_glob, K_total) - ks,
        ))
    return out


@lru_cache(maxsize=None)
def _bulkperm_sharded_fn(mesh, engine, n, precision, tile_p, interpret):
    """shard_map-wrapped bulk-perm chunk core, cached per (mesh, config).

    Device (i, j) of the (traits x markers) mesh computes trait shard i
    x permutation shard j — permutations ride the markers axis (the marker
    panel itself is tiny at LMM scale, n x p ~ a few MB, and is replicated;
    the genome-wide max over markers is device-local, so the whole engine
    is collective-free).
    """
    from ..models.bulkperm import _chunk_impl

    f = partial(
        _chunk_impl,
        engine=engine, n=n, precision=precision,
        tile_p=tile_p, interpret=interpret,
    )
    return jax.jit(
        jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(
                P(None, None),              # X0m replicated
                P(TRAITS_AXIS, None),       # sqrt-weights
                P(TRAITS_AXIS, None, None), # covariate orthobases
                P(None, TRAITS_AXIS),       # whitened residuals
                P(MARKERS_AXIS, None),      # shuffle indices (perm shards)
            ),
            out_specs=P(TRAITS_AXIS, MARKERS_AXIS),
            # pallas_call outputs carry no varying-mesh-axes metadata
            check_vma=False,
        )
    )


@lru_cache(maxsize=None)
def _bulkperm_fr_block_fn(mesh, engine, precision):
    """shard_map-wrapped FULL-RANK per-trait-block permutation-independent
    parts, traits-sharded against the replicated marker panel — computed
    once per (marker block, trait chunk) and reused by every permutation
    chunk (mirrors the single-device hoisting,
    models/bulkperm.py::_bulkperm_xla_trait_block /
    _bulkperm_pallas_trait_block, and the rank-k _bulkperm_lr_block_fn).
    Returns (pXs, xns) for the XLA engine, inv_xn for the Pallas engine."""
    if engine == "pallas":
        from ..pallas.bulkperm_fused import fused_perm_trait_block

        f = partial(fused_perm_trait_block, precision=precision)
        out_specs = P(TRAITS_AXIS, None)
    else:
        from ..ops.bulkperm import perm_trait_marker_parts

        f = partial(perm_trait_marker_parts, precision=precision)
        out_specs = (P(TRAITS_AXIS, None, None), P(TRAITS_AXIS, None))
    return jax.jit(
        jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(
                P(None, None),               # X0m replicated
                P(TRAITS_AXIS, None),        # sqrt-weights
                P(TRAITS_AXIS, None, None),  # covariate orthobases
            ),
            out_specs=out_specs,
            check_vma=False,
        )
    )


@lru_cache(maxsize=None)
def _bulkperm_fr_chunk_fn(mesh, engine, n, precision, tile_p, interpret):
    """shard_map-wrapped FULL-RANK perm chunk core consuming the hoisted
    block parts from :func:`_bulkperm_fr_block_fn` (the per-chunk sibling
    of :func:`_bulkperm_sharded_fn`, which computes parts inline)."""
    if engine == "pallas":
        from ..pallas.bulkperm_fused import (
            fused_perm_chunk_inputs, fused_perm_maxlods,
        )

        def f(X0m, sw_b, Q_b, inv_xn, wrn_b, idx_blk):
            S2 = fused_perm_chunk_inputs(sw_b, Q_b, wrn_b, idx_blk)
            return fused_perm_maxlods(
                X0m, S2, inv_xn,
                n=n, tile_p=tile_p, precision=precision, interpret=interpret,
            )

        parts_specs = (P(TRAITS_AXIS, None),)  # inv_xn
    else:
        from ..ops.bulkperm import max_r2_perms_xla, maxr2_to_lod

        def f(X0m, sw_b, Q_b, pXs, xns, wrn_b, idx_blk):
            maxr2 = max_r2_perms_xla(
                X0m, sw_b, Q_b, pXs, xns, wrn_b, idx_blk,
                precision=precision,
            )
            return maxr2_to_lod(maxr2, n, precision=precision)

        parts_specs = (P(TRAITS_AXIS, None, None), P(TRAITS_AXIS, None))
    return jax.jit(
        jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(
                P(None, None),               # X0m replicated
                P(TRAITS_AXIS, None),        # sqrt-weights
                P(TRAITS_AXIS, None, None),  # covariate orthobases
            ) + parts_specs + (
                P(None, TRAITS_AXIS),        # whitened residuals
                P(MARKERS_AXIS, None),       # shuffle indices (perm shards)
            ),
            out_specs=P(TRAITS_AXIS, MARKERS_AXIS),
            check_vma=False,
        )
    )


@lru_cache(maxsize=None)
def _bulkperm_lr_block_fn(mesh, precision):
    """shard_map-wrapped rank-k per-trait-block marker parts (qX, xn):
    traits-sharded, marker panel and (n, k) factor replicated. Computed once
    per trait block and reused by every permutation chunk (mirrors the
    single-device hoisting, models/bulkperm.py::_bulkperm_lr_trait_block)."""
    from ..ops.bulkperm import lowrank_perm_trait_marker_parts

    f = partial(lowrank_perm_trait_marker_parts, precision=precision)
    return jax.jit(
        jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(
                P(None, None),               # X (n, p) replicated
                P(None, None),               # U (n, k) replicated
                P(None, None),               # UtX (k, p)
                P(None, None),               # UtX^2 (k, p)
                P(None),                     # marker norms (p,)
                P(TRAITS_AXIS, None),        # sqrt(w)-1 (mb, k)
                P(TRAITS_AXIS, None, None),  # covariate bases (mb, c, n)
            ),
            out_specs=(P(TRAITS_AXIS, None, None), P(TRAITS_AXIS, None)),
        )
    )


@lru_cache(maxsize=None)
def _bulkperm_lr_chunk_fn(mesh, n, precision):
    """shard_map-wrapped rank-k perm chunk core: device (i, j) computes
    trait shard i x permutation shard j via the Woodbury whitening split
    (ops/bulkperm.py::max_r2_perms_lowrank_xla) — the genome-wide max over
    markers is device-local against the replicated panel, so the engine is
    collective-free like the full-rank path."""
    from ..ops.bulkperm import max_r2_perms_lowrank_xla, maxr2_to_lod

    def f(X, U, UtX, sm1_b, Q_b, qXs, xns, wrn_b, idx_blk):
        maxr2 = max_r2_perms_lowrank_xla(
            X, U, UtX, sm1_b, Q_b, qXs, xns, wrn_b, idx_blk,
            precision=precision,
        )
        return maxr2_to_lod(maxr2, n, precision=precision)

    return jax.jit(
        jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(
                P(None, None),               # X
                P(None, None),               # U
                P(None, None),               # UtX
                P(TRAITS_AXIS, None),        # sm1
                P(TRAITS_AXIS, None, None),  # Q
                P(TRAITS_AXIS, None, None),  # qXs
                P(TRAITS_AXIS, None),        # xns
                P(None, TRAITS_AXIS),        # whitened residuals (n, mb)
                P(MARKERS_AXIS, None),       # shuffle indices (perm shards)
            ),
            out_specs=P(TRAITS_AXIS, MARKERS_AXIS),
        )
    )


def _bulkscan_perms_lowrank_sharded(
    Y, G, lr, covar, mesh, *,
    nperms, rndseed, method, h2_grid, prior, reml, optim_interval,
    precision, trait_chunk, perm_chunk, original, checkpoint=None,
    _adj_pvals=True, data_digest=None,
):
    """Rank-k (Woodbury) permutation engine on the device mesh.

    Same numerics as the single-device rank-k path
    (models/bulkperm.py::_bulkscan_perms_lowrank); traits shard the traits
    axis and permutation columns the markers axis. This is the
    beyond-the-eigh-wall cohort's (n ~ 1e5) multi-chip path — exactly the
    scale that needs the most devices. Reference capability being scaled:
    src/scan.jl:485-557 (permutation testing).

    ``perm_chunk`` is the PER-DEVICE permutation width (global columns per
    chunk step = perm_chunk x markers-axis shards) — per-device memory at a
    given value matches the single-device engine, where the same keyword is
    the GLOBAL width; results are unaffected.
    """
    from ..models.bulkperm import (
        BulkPermResult, _attach_adj_pvals, _bulkperm_lr_marker_prep,
        _bulkperm_prep_traits_lowrank, _perm_checkpoint,
    )
    from ..ops.bulkperm import lowrank_perm_chunk_cap, permutation_indices

    n, m = Y.shape
    dtype = precision.resolve_solve()
    U = jnp.asarray(lr.U, dtype=dtype)
    lam = jnp.asarray(lr.lam, dtype=dtype)

    h2_list, sigma2_list, sm1, Qstack, wrn = _bulkperm_prep_traits_lowrank(
        Y.astype(dtype), covar.astype(dtype), U, lam, h2_grid.astype(dtype),
        n=n, prior=prior, reml=reml, method=method,
        optim_interval=optim_interval, precision=precision,
    )

    tshards = mesh.shape[TRAITS_AXIS]
    mshards = mesh.shape[MARKERS_AXIS]
    X = jnp.asarray(G, dtype=dtype)
    p = X.shape[1]
    if trait_chunk is None:
        trait_chunk = 16 * tshards
    trait_chunk += (-trait_chunk) % tshards
    # per-DEVICE perm width: the rank-k memory bound sees the per-device
    # trait block (ceiling division — the block rounds UP to tshards)
    pc_dev = min(
        perm_chunk,
        lowrank_perm_chunk_cap(n, p, trait_chunk=-(-trait_chunk // tshards)),
    )
    chunk_glob = pc_dev * mshards

    idx = permutation_indices(n, nperms, rndseed, original=original)
    K_total = int(idx.shape[0])

    UtX, UtX2, xsq = _bulkperm_lr_marker_prep(X, U, precision=precision)
    rep = NamedSharding(mesh, P(None, None))
    X = jax.device_put(X, rep)
    U = jax.device_put(U, rep)
    UtX = jax.device_put(UtX, rep)
    UtX2 = jax.device_put(UtX2, rep)
    xsq = jax.device_put(xsq, NamedSharding(mesh, P(None)))

    block = _bulkperm_lr_block_fn(mesh, precision)
    run = _bulkperm_lr_chunk_fn(mesh, n, precision)

    idx_chunks = _mesh_perm_idx_chunks(
        idx, mesh, chunk_glob=chunk_glob, row_quant=mshards
    )

    ckpt = _perm_checkpoint(
        checkpoint, n=n, m=m, p=p, nperms=nperms, rndseed=rndseed,
        method=method, reml=reml, original=original, trait_chunk=trait_chunk,
        h2_grid=h2_grid, prior=prior, rank=f"lowrank{lr.rank}-sharded",
        precision=precision, engine="xla", data_digest=data_digest,
    )

    trait_rows = []
    for ms in range(0, m, trait_chunk):
        me = min(ms + trait_chunk, m)
        mb = me - ms
        if ckpt is not None:
            done = ckpt.load(ms, me)
            if done is not None:
                trait_rows.append(jnp.asarray(done))
                continue
        sm1_b, Q_b, wrn_b = sm1[ms:me], Qstack[ms:me], wrn[:, ms:me]
        if mb % tshards:
            pad = -mb % tshards
            sm1_b = jnp.pad(sm1_b, ((0, pad), (0, 0)))
            Q_b = jnp.pad(Q_b, ((0, pad), (0, 0), (0, 0)))
            wrn_b = jnp.pad(wrn_b, ((0, 0), (0, pad)))
        sm1_b = jax.device_put(sm1_b, NamedSharding(mesh, P(TRAITS_AXIS, None)))
        Q_b = jax.device_put(
            Q_b, NamedSharding(mesh, P(TRAITS_AXIS, None, None))
        )
        wrn_b = jax.device_put(wrn_b, NamedSharding(mesh, P(None, TRAITS_AXIS)))
        qXs, xns = block(X, U, UtX, UtX2, xsq, sm1_b, Q_b)
        perm_cols = [
            run(X, U, UtX, sm1_b, Q_b, qXs, xns, wrn_b, blk)[:mb, :kw]
            for blk, kw in idx_chunks
        ]
        row = (
            perm_cols[0] if len(perm_cols) == 1
            else jnp.concatenate(perm_cols, axis=1)
        )
        if ckpt is not None:
            ckpt.save(ms, me, row)
        trait_rows.append(row)
    maxlods = (
        trait_rows[0] if len(trait_rows) == 1
        else jnp.concatenate(trait_rows, axis=0)
    )
    res = BulkPermResult(
        maxlods=maxlods,
        h2_null_list=h2_list,
        sigma2_e_list=sigma2_list,
        nperms=nperms,
        original=original,
    )
    return _attach_adj_pvals(res) if _adj_pvals else res


def bulkscan_perms_sharded(
    Y,
    G,
    K,
    covar=None,
    *,
    mesh: Optional[Mesh] = None,
    nperms: int = 1000,
    rndseed: int = 0,
    method: str = "null-grid",
    h2_grid=None,
    add_intercept: bool = True,
    weights=None,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    solve_method: str = "qr",
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    precision: PrecisionConfig = DEFAULT_PRECISION,
    engine: str = "auto",
    trait_chunk: Optional[int] = None,
    perm_chunk: int = 2048,
    original: bool = True,
    tile_p: int = 64,
    interpret: bool = False,
    checkpoint=None,
    _adj_pvals: bool = True,
    missing: str = "error",
):
    """All-trait permutation maxima sharded over the device mesh.

    Same numerics as :func:`bulklmm_tpu.bulkscan_perms` (the chunk core is
    shared); traits shard the traits axis and permutation columns the
    markers axis, so every device owns an independent (trait-block x
    perm-block) tile of the output — no collectives anywhere (the
    genome-wide max over markers is computed against the replicated,
    MB-scale marker panel). The fused Pallas kernel runs per device under
    ``shard_map`` on GPU meshes; CPU/virtual meshes use the XLA engine.

    NOTE on ``perm_chunk`` semantics: here it is the PER-DEVICE permutation
    width — each chunk step processes ``perm_chunk x markers_axis_shards``
    permutation columns globally, so per-device memory per step matches
    the single-device engine at the same value (in single-device
    ``bulkscan_perms`` the keyword is the global width; results are
    unaffected either way).
    """
    from ..models.bulkperm import (
        BulkPermResult, _bulkperm_prep, _perm_common_inputs,
        _resolve_perm_engine,
    )
    from ..ops.bulkperm import permutation_indices
    from ..ops.rotation import resolve_kinship

    if mesh is None:
        mesh = make_mesh()
    from ..ops.lowrank import LowRankKinship

    if isinstance(K, LowRankKinship) and engine == "pallas":
        raise ValueError(
            "engine='pallas' is not available for LowRankKinship inputs "
            "(the fused kernel assumes the rotated basis); use 'auto'/'xla'."
        )

    from ..models.missing import (
        finite_flag, group_checkpoint, maybe_masked, raise_if_missing,
        subset_kinship,
    )

    masked = maybe_masked(
        Y, missing,
        lambda Ys, rows, traits, gi: bulkscan_perms_sharded(
            Ys, np.asarray(G)[rows], subset_kinship(K, rows),
            None if covar is None else np.asarray(covar)[rows],
            mesh=mesh, nperms=nperms, rndseed=rndseed, method=method,
            h2_grid=h2_grid, add_intercept=add_intercept,
            weights=None if weights is None else np.asarray(weights)[rows],
            prior_variance=prior_variance,
            prior_sample_size=prior_sample_size, reml=reml,
            solve_method=solve_method, optim_interval=optim_interval,
            decomp_scheme=decomp_scheme, precision=precision, engine=engine,
            trait_chunk=trait_chunk, perm_chunk=perm_chunk,
            original=original, tile_p=tile_p, interpret=interpret,
            checkpoint=group_checkpoint(checkpoint, gi),
            _adj_pvals=_adj_pvals,
        ),
        covar=covar, weights=weights, add_intercept=add_intercept,
        what="bulkscan_perms_sharded",
    )
    if masked is not None:
        return masked
    _finite = finite_flag(Y)  # background guard, checked at return

    from ..models.bulkperm import _data_fingerprint

    data_digest = (
        _data_fingerprint(Y, G, covar, weights, K)
        if checkpoint is not None else None
    )
    Y, G, K, covar, h2_grid, prior = _perm_common_inputs(
        Y, jnp.asarray(G), K, covar, method=method, engine=engine,
        h2_grid=h2_grid, weights=weights, add_intercept=add_intercept,
        prior_variance=prior_variance, prior_sample_size=prior_sample_size,
    )

    if isinstance(K, LowRankKinship):
        res_lr = _bulkscan_perms_lowrank_sharded(
            Y, G, K, covar, mesh,
            nperms=nperms, rndseed=rndseed, method=method, h2_grid=h2_grid,
            prior=prior, reml=reml, optim_interval=optim_interval,
            precision=precision, trait_chunk=trait_chunk,
            perm_chunk=perm_chunk, original=original, checkpoint=checkpoint,
            _adj_pvals=_adj_pvals, data_digest=data_digest,
        )
        raise_if_missing(_finite, "bulkscan_perms_sharded")
        return res_lr

    n, m = Y.shape
    dtype = precision.resolve_solve()
    Ut, lam = resolve_kinship(K, decomp_scheme, dtype)

    X0m, h2_list, sigma2_list, sqrtw, Qstack, wrn = _bulkperm_prep(
        Y.astype(dtype), G.astype(dtype), covar.astype(dtype), Ut, lam,
        h2_grid.astype(dtype),
        prior=prior, reml=reml, method=method, solve_method=solve_method,
        optim_interval=optim_interval, precision=precision,
    )

    mshards = mesh.shape[MARKERS_AXIS]
    # per-DEVICE perm width is bounded by the same policy as the other
    # entry points; global chunk = device width x marker shards; all
    # tiling quanta from the shared helper (also used by the streamed
    # composition — models/streaming.py::_perms_streamed_sharded)
    eng, trait_chunk, pc_dev, quantum, row_quant = _mesh_perm_tiling(
        mesh, engine=engine, n=n, p=X0m.shape[1], precision=precision,
        interpret=interpret, trait_chunk=trait_chunk,
        perm_chunk=perm_chunk,
    )

    idx = permutation_indices(n, nperms, rndseed, original=original)
    chunk_glob = pc_dev * mshards

    run = _bulkperm_sharded_fn(mesh, eng, n, precision, tile_p, interpret)
    X0m = jax.device_put(X0m, NamedSharding(mesh, P(None, None)))

    idx_chunks = _mesh_perm_idx_chunks(
        idx, mesh, chunk_glob=chunk_glob, row_quant=row_quant
    )

    from ..models.bulkperm import _perm_checkpoint

    ckpt = _perm_checkpoint(
        checkpoint, n=n, m=m, p=X0m.shape[1], nperms=nperms,
        rndseed=rndseed, method=method, reml=reml, original=original,
        trait_chunk=trait_chunk, h2_grid=h2_grid, prior=prior,
        rank="full-sharded", precision=precision, engine=eng,
        data_digest=data_digest,
    )

    trait_rows = []
    for ms in range(0, m, trait_chunk):
        me = min(ms + trait_chunk, m)
        mb = me - ms
        if ckpt is not None:
            done = ckpt.load(ms, me)
            if done is not None:
                trait_rows.append(jnp.asarray(done))
                continue
        sw_b, Q_b, wrn_b = sqrtw[ms:me], Qstack[ms:me], wrn[:, ms:me]
        if mb % quantum:
            pad = -mb % quantum
            sw_b = jnp.pad(sw_b, ((0, pad), (0, 0)))
            Q_b = jnp.pad(Q_b, ((0, pad), (0, 0), (0, 0)))
            wrn_b = jnp.pad(wrn_b, ((0, 0), (0, pad)))
        sw_b = jax.device_put(sw_b, NamedSharding(mesh, P(TRAITS_AXIS, None)))
        Q_b = jax.device_put(
            Q_b, NamedSharding(mesh, P(TRAITS_AXIS, None, None))
        )
        wrn_b = jax.device_put(wrn_b, NamedSharding(mesh, P(None, TRAITS_AXIS)))
        perm_cols = [
            run(X0m, sw_b, Q_b, wrn_b, blk)[:mb, :kw]
            for blk, kw in idx_chunks
        ]
        row = (
            perm_cols[0] if len(perm_cols) == 1
            else jnp.concatenate(perm_cols, axis=1)
        )
        if ckpt is not None:
            ckpt.save(ms, me, row)
        trait_rows.append(row)
    maxlods = (
        trait_rows[0] if len(trait_rows) == 1
        else jnp.concatenate(trait_rows, axis=0)
    )

    from ..models.bulkperm import _attach_adj_pvals

    res = BulkPermResult(
        maxlods=maxlods,
        h2_null_list=h2_list,
        sigma2_e_list=sigma2_list,
        nperms=nperms,
        original=original,
    )
    raise_if_missing(_finite, "bulkscan_perms_sharded")
    return _attach_adj_pvals(res) if _adj_pvals else res


def train_step_sharded(mesh: Mesh, Y, G, K, h2_grid=None, **kwargs) -> BulkScanResult:
    """One full sharded "step": rotate, grid-fit h2, produce the LOD matrix.

    This is the framework's equivalent of a training step — the complete
    data-to-result pipeline the driver dry-runs over an n-device mesh.
    """
    return bulkscan_sharded(Y, G, K, mesh=mesh, h2_grid=h2_grid, **kwargs)
