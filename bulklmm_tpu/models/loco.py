"""Leave-one-chromosome-out (LOCO) scans.

An addition — the reference (BulkLMM.jl) always scans against the
whole-genome kinship (src/kinship.jl:4-13 feeds every scan), so markers are
tested against a relatedness matrix that *contains themselves*, causing
proximal contamination (deflated signals near true QTL). The standard GWAS
remedy (GEMMA ``-loco``, BOLT-LMM, regenie) is to scan each chromosome's
markers against a kinship built from all OTHER chromosomes.

Kinship algebra: ``calc_kinship`` is an affine function of the marker
cross-product, so the per-leave-out kinships are assembled from ONE pass of
per-chromosome Gram matrices — ``K_{-c} = 2 (A - A_c) / (p - p_c) + 0.5``
with ``A_c = X_c X_c^T`` (one GEMM per chromosome, each marker touched
once) — rather than re-reading the panel per chromosome. The scan loop
materializes one leave-out kinship at a time and frees each chromosome's
Gram once consumed, so peak memory is C Grams + ONE (n, n) kinship.

Each chromosome then runs the ordinary engines (``bulkscan`` / ``scan``)
against its own kinship; results are reassembled in the original marker
order. With ``lowrank_k`` the per-chromosome kinship is never materialized:
the rank-k factors come straight from the leave-out genotype block
(``kinship_lowrank_from_geno``) and the Woodbury engine runs unrotated —
the path for n beyond the host-eigh wall.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.config import DEFAULT_PRECISION, PrecisionConfig
from .results import BulkScanResult, ScanResult

__all__ = ["loco_kinship", "bulkscan_loco", "bulkscan_perms_loco", "scan_loco"]


def _chrom_masks(chromosome, p):
    chromosome = np.asarray(chromosome)
    if chromosome.shape[0] != p:
        raise ValueError(
            f"chromosome labels must have one entry per marker: got "
            f"{chromosome.shape[0]} labels for {p} markers"
        )
    order = list(dict.fromkeys(chromosome.tolist()))  # encounter order
    if len(order) < 2:
        raise ValueError(
            "LOCO needs markers on at least 2 chromosomes (the leave-out "
            "kinship would otherwise be empty)"
        )
    return order, {c: chromosome == c for c in order}


def _chrom_grams(G, order, masks, dtype, gemm_precision):
    """Per-chromosome marker cross-products + their sum (one GEMM each)."""
    grams, counts = {}, {}
    total = None
    for c in order:
        Xc = jnp.asarray(G[:, masks[c]], dtype=dtype) - 0.5
        grams[c] = jnp.matmul(Xc, Xc.T, precision=gemm_precision)
        counts[c] = Xc.shape[1]
        total = grams[c] if total is None else total + grams[c]
    return grams, counts, total


def _leaveout_kinship(total, gram_c, p_rest):
    K = 2.0 * (total - gram_c) / p_rest + 0.5
    return jnp.fill_diagonal(K, 1.0, inplace=False)


def loco_kinship(
    geno, chromosome, precision: PrecisionConfig = DEFAULT_PRECISION
):
    """Dict ``chrom -> K_{-chrom}`` (kinship from all other chromosomes).

    Exactly ``calc_kinship(geno[:, chromosome != c])`` for every c, computed
    from one pass of per-chromosome cross-product GEMMs. Holds all C
    kinships at once — the scan wrappers below stream them one at a time
    instead; call this directly only when you want the full dict.
    """
    G = np.asarray(geno)
    n, p = G.shape
    order, masks = _chrom_masks(chromosome, p)
    grams, counts, total = _chrom_grams(
        G, order, masks, precision.resolve_solve(), precision.gemm_precision
    )
    return {
        c: _leaveout_kinship(total, grams[c], p - counts[c]) for c in order
    }


def _iter_loco(G, chromosome, *, lowrank_k, precision):
    """Yield ``(chrom, mask, K_{-chrom})`` one chromosome at a time.

    Dense path: Grams once, each leave-out kinship materialized only for
    its own iteration (the Gram is freed after use). Rank-k path: factors
    from the leave-out genotype block, one chromosome at a time.
    """
    G = np.asarray(G)
    p = G.shape[1]
    order, masks = _chrom_masks(chromosome, p)
    if lowrank_k:
        from ..ops.lowrank import kinship_lowrank_from_geno

        for c in order:
            yield c, masks[c], kinship_lowrank_from_geno(
                G[:, ~masks[c]], lowrank_k, precision=precision
            )
        return
    grams, counts, total = _chrom_grams(
        G, order, masks, precision.resolve_solve(), precision.gemm_precision
    )
    for c in order:
        K = _leaveout_kinship(total, grams.pop(c), p - counts[c])
        yield c, masks[c], K


def _scatter(buf, idx, val, p):
    """Accumulate a per-chromosome result field into a (p, ...) host array
    (allocated on first non-None value; dtype follows the engine's result
    dtype — upcasting permutation-scale panels to f64 would double the
    host footprint for no accuracy gain)."""
    if val is None:
        return buf
    v = np.asarray(val)
    if buf is None:
        buf = np.empty((p,) + v.shape[1:], dtype=v.dtype)
    buf[idx] = v
    return buf


def bulkscan_loco(
    Y,
    G,
    chromosome,
    covar=None,
    *,
    lowrank_k: int = 0,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    mesh=None,
    missing: str = "error",
    **kwargs,
) -> BulkScanResult:
    """Multi-trait LOCO scan: each chromosome's markers against the kinship
    of all other chromosomes, reassembled in the original marker order.

    ``chromosome``: (p,) labels (e.g. ``read_gmap(...).chromosome``).
    ``lowrank_k`` > 0 uses the rank-k engine per chromosome (no n x n
    kinship, no host eigh). ``mesh`` (a ``jax.sharding.Mesh``) runs each
    chromosome's scan on the device mesh (:func:`bulklmm_tpu.parallel.
    bulkscan_sharded` — numerics unchanged). Remaining keywords go to
    :func:`bulkscan` (method, reml, output_pvals, output_effects,
    trait_chunk, ...).
    Per-trait null h2 is chromosome-specific; ``h2_null_by_chrom`` maps
    ``chrom -> (m,)`` (or ``(p_c, m)`` panels for alt-grid).
    """
    from .bulkscan import bulkscan
    from .missing import maybe_masked, raise_if_missing

    G = np.asarray(G)
    Y2 = np.asarray(Y)
    Y2 = Y2[:, None] if Y2.ndim == 1 else Y2

    weights = kwargs.get("weights")
    masked = maybe_masked(
        Y2, missing,
        lambda Ys, rows, traits, gi: bulkscan_loco(
            Ys, G[rows], chromosome,
            None if covar is None else np.asarray(covar)[rows],
            lowrank_k=lowrank_k, precision=precision, mesh=mesh,
            **{**kwargs, **({"weights": np.asarray(weights)[rows]}
                            if weights is not None else {})},
        ),
        covar=covar, weights=weights,
        add_intercept=kwargs.get("add_intercept", True),
        what="bulkscan_loco",
    )
    if masked is not None:
        return masked
    raise_if_missing(np.isfinite(Y2).all(), "bulkscan_loco")
    p, m = G.shape[1], Y2.shape[1]

    L = np.empty((p, m), dtype=np.float64)
    pvals = beta = se = None
    h2_by_chrom = {}
    for c, mask, K in _iter_loco(
        G, chromosome, lowrank_k=lowrank_k, precision=precision
    ):
        if mesh is not None:
            from ..parallel.sharding import bulkscan_sharded

            res = bulkscan_sharded(
                Y2, G[:, mask], K, covar, mesh=mesh,
                precision=precision, **kwargs,
            )
        else:
            res = bulkscan(
                Y2, G[:, mask], K, covar, precision=precision, **kwargs
            )
        idx = np.flatnonzero(mask)
        L[idx] = np.asarray(res.L)
        h2_by_chrom[c] = (
            res.h2_null_list if res.h2_null_list is not None else res.h2_panel
        )
        pvals = _scatter(pvals, idx, res.log10Pvals_mat, p)
        beta = _scatter(beta, idx, res.beta_mat, p)
        se = _scatter(se, idx, res.beta_se_mat, p)

    result = BulkScanResult(L=L)
    result.h2_null_by_chrom = h2_by_chrom
    if pvals is not None:
        result.log10Pvals_mat = pvals
        result.chisq_df = kwargs.get("chisq_df", 1)
    if beta is not None:
        result.beta_mat, result.beta_se_mat = beta, se
    return result


def scan_loco(
    y,
    G,
    chromosome,
    covar=None,
    *,
    lowrank_k: int = 0,
    share_shuffles: bool = False,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    missing: str = "error",
    **kwargs,
) -> ScanResult:
    """Single-trait LOCO scan (see :func:`bulkscan_loco`).

    Remaining keywords go to :func:`scan` (assumption, reml,
    permutation_test/nperms/rndseed, output_pvals, output_effects, ...).
    The null model is chromosome-specific: ``h2_null_by_chrom`` /
    ``sigma2_by_chrom`` map ``chrom -> scalar``; ``h2_null`` / ``sigma2_e``
    hold the across-chromosome means for a quick summary.

    Permutation semantics: each chromosome permutes its own rotated null
    residuals (the reference's scheme, per-chromosome eigenbasis). By
    default chromosome i uses seed ``rndseed + i``, so column j of the
    stitched ``L_perms`` combines INDEPENDENT per-chromosome null
    replicates; genome-wide thresholds from
    :func:`~bulklmm_tpu.get_thresholds` then treat per-chromosome maxima
    as independent — a Šidák-like approximation that is exact when
    chromosomes are independent under the null and conservative (higher
    thresholds, FWER still controlled) under cross-chromosome positive
    dependence. ``share_shuffles=True`` reuses the SAME shuffle indices on
    every chromosome instead — the closest analog of shuffling the
    phenotype once and scanning the whole genome (per-chromosome maxima
    keep their positive dependence, giving smaller genome-wide maxima and
    tighter thresholds), at the cost of replicate-level dependence given
    y. Per-chromosome thresholds
    (``get_thresholds(res.L_perms[chrom == c])``) are exact either way.
    """
    from .scan import scan

    if kwargs.get("profile_ll"):
        raise ValueError(
            "profile_ll is a single-(marker, kinship) diagnostic; run "
            "scan(profile_ll=True) against the wanted LOCO kinship directly"
        )
    from .missing import validate_missing_kwarg

    validate_missing_kwarg(missing)
    G = np.asarray(G)
    y = np.asarray(y, dtype=np.float64)
    finite = np.isfinite(y).ravel() if y.ndim > 1 else np.isfinite(y)
    if not finite.all():
        # single trait: complete-case row subset; LOCO kinships are built
        # from the subset genotypes below (exact — K_ij depends only on
        # rows i, j of G)
        from .missing import _check_side_inputs, raise_if_missing

        raise_if_missing(missing != "error", "scan_loco")
        weights = kwargs.get("weights")
        _check_side_inputs(covar, weights, "scan_loco")
        rows = np.flatnonzero(finite)
        from .missing import _check_group_sizes, _ncov_total

        _check_group_sizes(
            [(rows, np.array([0]))],
            _ncov_total(covar, kwargs.get("add_intercept", True)),
            what="scan_loco", drop=False,
        )
        y, G = y[finite], G[rows]
        covar = None if covar is None else np.asarray(covar)[rows]
        if weights is not None:
            kwargs["weights"] = np.asarray(weights)[rows]
    p = G.shape[1]
    base_seed = int(kwargs.pop("rndseed", 0))

    lod = np.empty(p, dtype=np.float64)
    h2_each = perms = pvals = pvals_perms = beta = se = None
    h2_by_chrom, s2_by_chrom = {}, {}
    for i, (c, mask, K) in enumerate(_iter_loco(
        G, chromosome, lowrank_k=lowrank_k, precision=precision
    )):
        res = scan(y, G[:, mask], K, covar, precision=precision,
                   rndseed=base_seed if share_shuffles else base_seed + i,
                   **kwargs)
        idx = np.flatnonzero(mask)
        lod[idx] = np.asarray(res.lod)
        h2_by_chrom[c] = float(res.h2_null)
        s2_by_chrom[c] = float(res.sigma2_e)
        h2_each = _scatter(h2_each, idx, res.h2_each_marker, p)
        perms = _scatter(perms, idx, res.L_perms, p)
        pvals = _scatter(pvals, idx, res.log10pvals, p)
        pvals_perms = _scatter(pvals_perms, idx, res.log10Pvals_perms, p)
        beta = _scatter(beta, idx, res.beta, p)
        se = _scatter(se, idx, res.beta_se, p)

    result = ScanResult(
        sigma2_e=float(np.mean(list(s2_by_chrom.values()))),
        h2_null=float(np.mean(list(h2_by_chrom.values()))),
        lod=lod,
        h2_each_marker=h2_each,
        L_perms=perms,
        log10pvals=pvals,
        log10Pvals_perms=pvals_perms,
    )
    if beta is not None:
        result.beta, result.beta_se = beta, se
    result.h2_null_by_chrom = h2_by_chrom
    result.sigma2_by_chrom = s2_by_chrom
    return result


def bulkscan_perms_loco(
    Y,
    G,
    chromosome,
    covar=None,
    *,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    rndseed: int = 0,
    lowrank_k: int = 0,
    share_shuffles: bool = False,
    mesh=None,
    missing: str = "error",
    **kwargs,
):
    """All-trait LOCO permutation maxima: per chromosome, markers scan
    against the leave-that-chromosome-out kinship with its own null fits
    and whitened-residual shuffles; the genome-wide max per (trait,
    permutation) is the elementwise max of the per-chromosome maxima
    (LOD is monotone in r^2, so maxima stitch exactly).

    Permutation semantics match :func:`scan_loco`: by default chromosome i
    uses seed ``rndseed + i``, making each stitched replicate a max of
    INDEPENDENT per-chromosome draws — exact under cross-chromosome
    independence, conservative (higher thresholds, FWER still controlled)
    under positive dependence. ``share_shuffles=True`` reuses the same
    shuffle indices on every chromosome — the closest analog of one
    genome-wide phenotype shuffle (tighter thresholds, replicate-level
    dependence given Y). Remaining keywords go to
    :func:`bulklmm_tpu.bulkscan_perms` (nperms, method, h2_grid, engine,
    ...). ``h2_null_by_chrom`` / ``sigma2_by_chrom`` map ``chrom -> (m,)``;
    the result's ``h2_null_list`` / ``sigma2_e_list`` are the
    across-chromosome means. ``lowrank_k`` > 0 builds each leave-out
    kinship as a rank-k factorization (no n x n kinship, no host eigh)
    and tests on the Woodbury whitening engine.
    """
    import jax.numpy as _jnp

    from .bulkperm import BulkPermResult, _attach_adj_pvals, bulkscan_perms
    from .missing import (
        group_checkpoint, maybe_masked, raise_if_missing,
    )

    G = np.asarray(G)
    weights = kwargs.get("weights")
    _ckpt_top = kwargs.get("checkpoint")
    masked = maybe_masked(
        Y, missing,
        lambda Ys, rows, traits, gi: bulkscan_perms_loco(
            Ys, G[rows], chromosome,
            None if covar is None else np.asarray(covar)[rows],
            precision=precision, rndseed=rndseed, lowrank_k=lowrank_k,
            share_shuffles=share_shuffles, mesh=mesh,
            **{**kwargs,
               **({"weights": np.asarray(weights)[rows]}
                  if weights is not None else {}),
               **({"checkpoint": group_checkpoint(_ckpt_top, gi)}
                  if _ckpt_top is not None else {})},
        ),
        covar=covar, weights=weights,
        add_intercept=kwargs.get("add_intercept", True),
        what="bulkscan_perms_loco",
    )
    if masked is not None:
        return masked
    raise_if_missing(
        np.isfinite(np.asarray(Y)).all(), "bulkscan_perms_loco"
    )
    base_seed = int(rndseed)

    # per-chromosome checkpoint SUBDIRECTORIES: every chromosome is its own
    # sweep (different marker count, different seed) — one shared directory
    # would trip the config-mismatch guard on the second chromosome
    checkpoint = kwargs.pop("checkpoint", None)

    def _chrom_ckpt(c):
        if checkpoint is None:
            return None
        import hashlib
        from pathlib import Path

        safe = "".join(
            ch if ch.isalnum() or ch in "._-" else "_" for ch in str(c)
        )
        # sanitization alone can collide distinct labels ('1:A' vs '1 A');
        # a short hash of the RAW label keeps subdirectories unique so one
        # chromosome can never silently resume another's maxima
        tag = hashlib.sha1(str(c).encode()).hexdigest()[:8]
        return str(Path(checkpoint) / f"chr_{safe}_{tag}")

    maxlods = None
    h2_by_chrom, s2_by_chrom = {}, {}
    nperms = original = None
    for i, (c, mask, K) in enumerate(_iter_loco(
        G, chromosome, lowrank_k=lowrank_k, precision=precision
    )):
        if mesh is not None:
            from ..parallel.sharding import bulkscan_perms_sharded

            res = bulkscan_perms_sharded(
                Y, G[:, mask], K, covar, mesh=mesh, precision=precision,
                rndseed=base_seed if share_shuffles else base_seed + i,
                checkpoint=_chrom_ckpt(c),
                _adj_pvals=False,  # recomputed once on the stitched maxima
                **kwargs,
            )
        else:
            res = bulkscan_perms(
                Y, G[:, mask], K, covar, precision=precision,
                rndseed=base_seed if share_shuffles else base_seed + i,
                checkpoint=_chrom_ckpt(c),
                _adj_pvals=False,  # recomputed once on the stitched maxima
                **kwargs,
            )
        h2_by_chrom[c] = res.h2_null_list
        s2_by_chrom[c] = res.sigma2_e_list
        nperms, original = res.nperms, res.original
        maxlods = (
            res.maxlods if maxlods is None
            else _jnp.maximum(maxlods, res.maxlods)
        )

    result = BulkPermResult(
        maxlods=maxlods,
        h2_null_list=_jnp.mean(
            _jnp.stack(list(h2_by_chrom.values())), axis=0
        ),
        sigma2_e_list=_jnp.mean(
            _jnp.stack(list(s2_by_chrom.values())), axis=0
        ),
        nperms=nperms,
        original=original,
        h2_null_by_chrom=h2_by_chrom,
        sigma2_by_chrom=s2_by_chrom,
    )
    return _attach_adj_pvals(result)
