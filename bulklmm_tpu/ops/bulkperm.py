"""Bulk (multi-trait) permutation-scan math: per-trait whitened-residual
permutation null maxima for every trait at once.

The reference can permutation-test one trait per call (``scan_perms_lite``,
src/scan.jl:485-557): rotate, fit the null h2, whiten the residual with the
trait's sqrt-weights, shuffle it, residualize+normalize the markers against
the weighted covariates, one (p x nperms) correlation GEMM, keep the
per-permutation genome-wide max (src/analysis_helpers/
single_trait_analysis.jl:13-23). Thresholding 35,554 BXD traits that way is
35,554 sequential scans (~47 min at the README's 0.079 s/trait,
README.md:229-233).

This module batches the whole thing. Two identities make it GEMM-shaped:

1. **Self-adjoint residualization.** The reference residualizes the
   *markers* against the weighted covariates and correlates with the raw
   shuffled residual. Since the projector ``I - Q_j Q_j^T`` is symmetric,
   ``<(I-P_j) W_j^{1/2} x_i, s> = <W_j^{1/2} x_i, (I-P_j) s>`` — so per
   (trait j, marker i, permutation k) the numerator is one GEMM of raw
   weighted markers against per-trait quantities, with NO per-trait marker
   matrix materialized.
2. **Monotone max.** LOD is monotone in r^2, so the genome-wide max LOD per
   (trait, permutation) is a running max of ``num^2 / (xn * nrm2)`` — a pure
   reduction that fuses into the correlation GEMM (the Pallas engine keeps
   the (traits, perms) carry in registers; pallas/bulkperm_fused.py).

Per-trait quantities (weights, weighted-covariate orthobasis, whitened
residual) come from the same unrolled-Cholesky machinery as the
per-trait-weight scan kernel (ops/liteqtl.py, ops/smallchol.py) — batched
(m, c, c) linalg is never touched.

Permutation indices are SHARED across traits and identical to the
single-trait path's (``transform_permute``, threefry on ``rndseed``), so
column j of the bulk result is bit-for-bit the single-trait
``scan(..., permutation_test=True, rndseed=rndseed)`` null maxima for
trait j given the same h2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.config import DEFAULT_PRECISION, PrecisionConfig
from .smallchol import decovariate, fwd_subst, pair_indices, unrolled_cholesky
from .weights import make_weights


def permutation_indices(n: int, nperms: int, rndseed: int, *, original: bool = True):
    """(K, n) int32 shuffle-index matrix, K = nperms (+1 identity row first
    when ``original=True``).

    Row k applied as ``x[idx[k]]`` reproduces ``shuffle_vector`` /
    ``transform_permute`` column k exactly: ``jax.random.permutation(key, x)
    == x[jax.random.permutation(key, len(x))]`` (same threefry sort keys).
    """
    if nperms < 0 or (nperms == 0 and not original):
        raise ValueError(
            "The required number of permutations must be a positive integer "
            "(nperms=0 is allowed only with original=True, which keeps just "
            "the observed column)."
        )
    keys = jax.random.split(jax.random.PRNGKey(rndseed), nperms)
    idx = jax.vmap(lambda k: jax.random.permutation(k, n))(keys).astype(jnp.int32)
    if original:
        idx = jnp.concatenate([jnp.arange(n, dtype=jnp.int32)[None, :], idx], axis=0)
    return idx


def perm_trait_parts(
    Y0,
    C0,
    lam,
    h2_list,
    *,
    precision: PrecisionConfig = DEFAULT_PRECISION,
):
    """Per-trait whitening quantities from rotated operands.

    Returns ``(sqrtw, Q, wrn)``:

    - ``sqrtw`` (n, m): per-trait sqrt-weights ``sqrt(|makeweights(h2_j)|)``
      (abs guard as the reference, src/bulkscan_helpers.jl:138);
    - ``Q`` list of c arrays (n, m): per-trait orthonormal basis of the
      weighted covariates (unrolled Gram Cholesky — no batched QR);
    - ``wrn`` (n, m): whitened null residual
      ``W^{1/2}(y0 - C0 bhat)``, normalized to unit length (the shuffled
      vector's norm is permutation-invariant, so normalizing once folds the
      trait-side denominator away).
    """
    sdt = precision.resolve_kernel()
    pgp = precision.gemm_precision
    n, c = C0.shape

    W = jnp.abs(make_weights(h2_list, lam)).T.astype(sdt)  # (n, m)
    S = jnp.sqrt(W)
    # the covariate span leaves the traits at the solve dtype, so the
    # kernel-dtype residual below cancels only the weighted remainder
    slv = precision.resolve_solve()
    Y = decovariate(Y0.astype(slv), C0.astype(slv)).astype(sdt)
    C = C0.astype(sdt)

    pairs = pair_indices(c)
    CC = jnp.stack([C[:, k] * C[:, l] for k, l in pairs], axis=1)  # (n, npair)
    Gv = jnp.matmul(CC.T, W, precision=pgp)  # (npair, m)
    Lc = unrolled_cholesky({kl: Gv[i] for i, kl in enumerate(pairs)}, c)

    # Q^T = L^{-1} (W^{1/2} C)^T, as c arrays of (n, m)
    Q = fwd_subst(Lc, [C[:, k][:, None] * S for k in range(c)], c)

    Sy = S * Y  # (n, m) weighted traits
    zeta = [jnp.sum(Q[k] * Sy, axis=0) for k in range(c)]  # c x (m,)
    wr = Sy
    for k in range(c):
        wr = wr - Q[k] * zeta[k][None, :]
    # a fully covariate-explained trait residualizes to rounding noise —
    # the relative rank mask zeroes it (r = 0 for every marker x perm)
    # instead of normalizing the noise (ops/smallchol.py, COMPAT.md #15);
    # the tiny floor still guards 0/0
    from .smallchol import residual_keep_mask

    nrm2 = jnp.sum(wr * wr, axis=0)
    keep = residual_keep_mask(
        nrm2, jnp.sum(Sy * Sy, axis=0), eps=jnp.finfo(sdt).eps
    )
    wrn = (wr * keep[None, :]) / jnp.sqrt(
        jnp.maximum(nrm2, jnp.finfo(sdt).tiny)
    )[None, :]
    return S, Q, wrn


def perm_trait_marker_parts(
    X0m,
    sqrtw,
    Qstack,
    *,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    dtype=None,
):
    """Permutation-independent per-trait whitened-marker quantities for the
    full-rank XLA engine: covariate-basis projections ``pX`` (mb, c, p)
    and residual norms ``xn`` (mb, p) — computed once per trait block and
    reused by every permutation chunk.

    Never materializes a per-trait (n, p) weighted panel: row scaling
    commutes into the small operand (``Q_j (X ⊙ sw_j) = (Q_j ⊙ sw_j) X``,
    ``||X ⊙ sw_j||² = (sw_j²)ᵀ X²``), so both are GEMMs against the shared
    marker panel.

    ``dtype`` (default: the kernel dtype) is the compute dtype; the
    degenerate-marker mask keeps the kernel dtype's eps, the noise scale
    ``sqrtw`` and ``Qstack`` were computed at.
    """
    from .smallchol import cancel_keep_mask, residual_sq

    sdt = precision.resolve_kernel()
    cdt = sdt if dtype is None else dtype
    eps = jnp.finfo(sdt).eps
    pgp = precision.gemm_precision
    X = X0m.astype(cdt)  # (n, p)
    X2 = X * X

    def one(sw_j, q_j):
        # sw_j (n,), q_j (c, n)
        sw_j, q_j = sw_j.astype(cdt), q_j.astype(cdt)
        pX = jnp.matmul(q_j * sw_j[None, :], X, precision=pgp)  # (c, p)
        d1 = jnp.matmul(sw_j * sw_j, X2, precision=pgp)  # (p,)
        # same cancellation floor as every other engine (residual_sq);
        # covariate-collinear markers go to xn = +inf so the chunk core's
        # num^2 / xn is exactly 0 (COMPAT.md #15) — cancel_keep_mask, the
        # linear-in-eps variant for difference-of-squares norms
        xn = residual_sq(d1, [pX[a] for a in range(pX.shape[0])])
        keep = cancel_keep_mask(xn, d1, eps=eps)
        xn = jnp.where(keep > 0, xn, jnp.asarray(jnp.inf, xn.dtype))
        return pX, xn

    return jax.vmap(one)(sqrtw, Qstack)


def max_r2_perms_xla(
    X0m,
    sqrtw,
    Qstack,
    pXs,
    xns,
    wrn,
    perm_idx,
    *,
    precision: PrecisionConfig = DEFAULT_PRECISION,
):
    """(mb, Kc) max-over-markers squared correlation, XLA formulation —
    one (trait chunk, perm chunk) step.

    ``X0m`` (n, p) rotated markers; ``sqrtw`` (mb, n); ``Qstack``
    (mb, c, n); ``pXs``/``xns`` from :func:`perm_trait_marker_parts`;
    ``wrn`` (n, m) unit-normalized whitened residuals; ``perm_idx``
    (Kc, n).

    The numerator uses the self-adjoint split ``<(I-QQ^T)(X ⊙ sw_j), s> =
    (sw_j ⊙ s)^T X − (s^T Q_j^T) pX_j`` — two GEMMs per chunk, no per-trait
    (n, p) panel; the Pallas engine (pallas/bulkperm_fused.py) is the GPU
    fused path.
    """
    sdt = precision.resolve_kernel()
    gdt = precision.resolve_gemm()
    pgp = precision.gemm_precision
    tiny = jnp.finfo(sdt).tiny
    X = X0m.astype(sdt)
    Sperm = wrn[perm_idx]  # (Kc, n, m)

    def one(sw_j, q_j, pX, xn, sp_j):
        # sw_j (n,), q_j (c, n), pX (c, p), xn (p,), sp_j (Kc, n)
        num = (
            jnp.matmul(
                (sp_j * sw_j[None, :]).astype(gdt), X.astype(gdt),
                precision=pgp,
            ).astype(sdt)
            - jnp.matmul(
                jnp.matmul(sp_j, q_j.T, precision=pgp), pX, precision=pgp
            )
        )  # (Kc, p)
        r2 = (num * num) / jnp.maximum(xn, tiny)[None, :]
        return jnp.max(r2, axis=1)  # (Kc,)

    return jax.vmap(one, in_axes=(0, 0, 0, 0, 2))(
        sqrtw, Qstack, pXs, xns, Sperm
    )


def perm_chunk_cap(
    n: int, p: int, trait_chunk: int = 16, itemsize: int = 4,
    budget_bytes: int = 2 * 1024 * 1024 * 1024,
) -> int:
    """Permutation-chunk width bound for the full-rank engines.

    Per (trait chunk, perm chunk) step the XLA engine
    (:func:`max_r2_perms_xla`) materializes the (mb, Kc, p) numerator and
    the (Kc, n, mb) pre-shuffled residual gather; the fused kernel only the
    (mb, n, Kc) residual operand (pass ``p=0``). About three copies of each
    are live, sized at the wider of the GEMM and kernel itemsizes (the
    chunk core casts GEMM outputs up to the kernel dtype, e.g. MIXED = f32
    GEMMs, f64 kernel). Bound Kc so that stays inside ``budget_bytes``."""
    per_kc = 3 * itemsize * max(trait_chunk, 1) * (max(p, 0) + max(n, 1))
    return max(64, int(budget_bytes // per_kc))


def lowrank_perm_chunk_cap(
    n: int, p: int, trait_chunk: int = 16,
    budget_bytes: int = 2 * 1024 * 1024 * 1024,
) -> int:
    """Permutation-chunk width bound for the rank-k XLA engine: the
    (Kc, n, mb) pre-shuffled residual gather and the vmapped (mb, Kc, p)
    numerator both scale linearly in Kc — bound each at ~budget/2 so the
    'beyond the eigh wall' cohort sizes this engine exists for (n ~ 1e5)
    do not OOM under the full-rank-tuned default of 2048."""
    half = budget_bytes // 2
    per_kc = 4 * trait_chunk  # f32 x mb
    cap = min(half // (per_kc * max(n, 1)), half // (per_kc * max(p, 1)))
    return max(64, int(cap))


def perm_trait_parts_lowrank(
    Y,
    C,
    U,
    lam,
    h2_list,
    *,
    precision: PrecisionConfig = DEFAULT_PRECISION,
):
    """Per-trait whitening quantities on a rank-k kinship, in STANDARD
    coordinates (no rotation, no (n, n) kinship).

    The rank-k whitening operator is ``A_j = I + U diag(sqrt(w_j) - 1) U^T``
    with ``w_i = 1/(delta_j lam_i + 1)`` (ops/lowrank.py::whiten_lowrank) —
    the orthogonal complement of ``U`` has eigenvalue 0, hence weight 1.
    Under the null, ``A_j y`` has iid coordinates in the STANDARD basis, so
    shuffling standard coordinates of the whitened residual is exactly the
    rank-k analog of the full-rank path's shuffle of the rotated,
    reweighted residual (:func:`perm_trait_parts`).

    Returns ``(sm1, Q, wrn)``:

    - ``sm1`` (m, k): per-trait ``sqrt(w) - 1`` correction factors;
    - ``Q`` (m, c, n): per-trait orthonormal basis of the whitened
      covariates (unrolled Gram Cholesky, standard coordinates);
    - ``wrn`` (n, m): unit-normalized whitened null residuals
      ``(I - Q_j Q_j^T) A_j y_j``.
    """
    from .lowrank import _correction_weights

    sdt = precision.resolve_kernel()
    pgp = precision.gemm_precision
    c = C.shape[1]
    Ck = C.astype(sdt)
    Yk = Y.astype(sdt)
    Uk = U.astype(sdt)

    dm1 = _correction_weights(h2_list, lam)  # (m, k): w - 1
    sm1 = jnp.sqrt(1.0 + dm1) - 1.0  # (m, k): sqrt(w) - 1
    UtC = jnp.matmul(Uk.T, Ck, precision=pgp)  # (k, c)
    UtY = jnp.matmul(Uk.T, Yk, precision=pgp)  # (k, m)

    # whitened covariates, one (n, m) panel per covariate column:
    # A_j C[:, a] = C[:, a] + U (sm1_j ⊙ UtC[:, a])
    Cw = [
        Ck[:, a][:, None]
        + jnp.matmul(Uk, sm1.T * UtC[:, a][:, None], precision=pgp)
        for a in range(c)
    ]
    pairs = pair_indices(c)
    Gv = {ab: jnp.sum(Cw[ab[0]] * Cw[ab[1]], axis=0) for ab in pairs}
    Lc = unrolled_cholesky(Gv, c)
    Q = fwd_subst(Lc, Cw, c)  # c x (n, m)

    Yw = Yk + jnp.matmul(Uk, sm1.T * UtY, precision=pgp)  # (n, m)
    zeta = [jnp.sum(Q[a] * Yw, axis=0) for a in range(c)]
    wr = Yw
    for a in range(c):
        wr = wr - Q[a] * zeta[a][None, :]
    from .smallchol import residual_keep_mask

    nrm2 = jnp.sum(wr * wr, axis=0)
    # fully covariate-explained traits -> r = 0, not normalized noise
    keep = residual_keep_mask(
        nrm2, jnp.sum(Yw * Yw, axis=0), eps=jnp.finfo(sdt).eps
    )
    wrn = (wr * keep[None, :]) / jnp.sqrt(
        jnp.maximum(nrm2, jnp.finfo(sdt).tiny)
    )[None, :]
    Qstack = jnp.transpose(jnp.stack(Q, axis=0), (2, 0, 1))  # (m, c, n)
    return sm1, Qstack, wrn


def lowrank_perm_marker_parts(
    X, U, *, precision: PrecisionConfig = DEFAULT_PRECISION
):
    """Trait- and permutation-independent marker-side projections for the
    rank-k permutation engine, computed ONCE per scan: ``U^T X`` (k, p),
    its elementwise square, and the raw marker column norms."""
    sdt = precision.resolve_kernel()
    pgp = precision.gemm_precision
    Xk = X.astype(sdt)
    Uk = U.astype(sdt)
    UtX = jnp.matmul(Uk.T, Xk, precision=pgp)  # (k, p)
    return UtX, UtX * UtX, jnp.sum(Xk * Xk, axis=0)


def lowrank_perm_trait_marker_parts(
    X, U, UtX, UtX2, xsq, sm1, Qstack, *,
    precision: PrecisionConfig = DEFAULT_PRECISION,
):
    """Permutation-independent per-trait(-block) whitened-marker
    quantities: covariate-basis projections ``qX`` (mb, c, p) and residual
    norms ``xn`` (mb, p) of the whitened, covariate-residualized markers —
    computed once per trait chunk and reused by every permutation chunk."""
    from .smallchol import residual_sq

    sdt = precision.resolve_kernel()
    pgp = precision.gemm_precision
    Xk = X.astype(sdt)
    Uk = U.astype(sdt)

    from .smallchol import cancel_keep_mask

    def one(sm1_j, q_j):
        # sm1_j (k,), q_j (c, n)
        dm1_j = sm1_j * sm1_j + 2.0 * sm1_j  # w - 1
        qU = jnp.matmul(q_j, Uk, precision=pgp)  # (c, k)
        qX = (
            jnp.matmul(q_j, Xk, precision=pgp)
            + jnp.matmul(qU * sm1_j[None, :], UtX, precision=pgp)
        )  # (c, p)
        # ||(I - QQ^T) A_j x||^2 with the same cancellation floor as the
        # rank-k scan kernel (residual_sq; D1 pattern of _nd_parts_lowrank);
        # covariate-collinear markers -> xn = +inf -> r^2 = 0 exactly
        # (cancel_keep_mask: difference-of-squares noise is linear in eps)
        d1 = xsq + jnp.matmul(dm1_j, UtX2, precision=pgp)  # ||A_j x||^2
        xn = residual_sq(d1, [qX[a] for a in range(qX.shape[0])])
        keep = cancel_keep_mask(xn, d1, eps=jnp.finfo(sdt).eps)
        xn = jnp.where(keep > 0, xn, jnp.asarray(jnp.inf, xn.dtype))
        return qX, xn

    return jax.vmap(one)(sm1, Qstack)


def max_r2_perms_lowrank_xla(
    X,
    U,
    UtX,
    sm1,
    Qstack,
    qXs,
    xns,
    wrn,
    perm_idx,
    *,
    precision: PrecisionConfig = DEFAULT_PRECISION,
):
    """(mb, Kc) max-over-markers squared correlation under rank-k
    whitening, one (trait chunk, perm chunk) step.

    ``X`` (n, p) UNROTATED markers; ``U`` (n, k); ``UtX`` (k, p) from
    :func:`lowrank_perm_marker_parts`; ``sm1`` (mb, k) per-trait
    ``sqrt(w) - 1``; ``Qstack`` (mb, c, n); ``qXs``/``xns`` from
    :func:`lowrank_perm_trait_marker_parts`; ``wrn`` (n, m); ``perm_idx``
    (Kc, n).

    Never materializes a per-trait whitened marker panel: every whitened
    inner product expands to the raw product plus a rank-k correction
    through the shared ``U^T X`` projection (the same Woodbury split as the
    rank-k scan kernels, ops/lowrank.py::_nd_parts_lowrank), so the
    per-trait work is GEMM-shaped in (Kc, n), (Kc, k) and (Kc, p).
    """
    sdt = precision.resolve_kernel()
    gdt = precision.resolve_gemm()
    pgp = precision.gemm_precision
    tiny = jnp.finfo(sdt).tiny
    Xk = X.astype(sdt)
    Uk = U.astype(sdt)
    Sperm = wrn[perm_idx]  # (Kc, n, mb)

    def one(sm1_j, q_j, qX, xn, sp_j):
        # <(I - QQ^T) A_j x, s> = <x, s> + rank-k correction - <qX, Q s>
        spU = jnp.matmul(sp_j, Uk, precision=pgp)  # (Kc, k)
        num = (
            jnp.matmul(
                sp_j.astype(gdt), Xk.astype(gdt), precision=pgp
            ).astype(sdt)
            + jnp.matmul(
                (spU * sm1_j[None, :]).astype(gdt), UtX.astype(gdt),
                precision=pgp,
            ).astype(sdt)
            - jnp.matmul(
                jnp.matmul(sp_j, q_j.T, precision=pgp), qX, precision=pgp
            )
        )  # (Kc, p)
        r2 = (num * num) / jnp.maximum(xn, tiny)[None, :]
        return jnp.max(r2, axis=1)  # (Kc,)

    return jax.vmap(one, in_axes=(0, 0, 0, 0, 2))(
        sm1, Qstack, qXs, xns, Sperm
    )


def maxr2_to_lod(maxr2, n: int, *, precision: PrecisionConfig = DEFAULT_PRECISION):
    """Genome-wide max LOD from max r^2 (monotone transform), with the same
    cancellation floor as the fused kernel (r2 can round to >= 1 for a
    marker perfectly correlated with the residual)."""
    from .liteqtl import _fast_log
    from .lod import log10_f32_accurate

    one_minus = jnp.maximum(1.0 - maxr2, jnp.finfo(maxr2.dtype).tiny)
    if _fast_log(precision):
        return -(n / 2.0) * log10_f32_accurate(one_minus.astype(jnp.float32))
    return -(n / 2.0) * jnp.log10(one_minus)
