"""Unrolled small-Cholesky helpers for covariate-sized (c x c) systems.

c (intercept + covariates) is tiny and static, so the factorization and
substitutions unroll into c^2-ish fused elementwise ops over arbitrarily
batched operands — no ``jnp.linalg`` primitive. Batched (m, c, c) LU/inv
is a slow path on accelerators (padded tiny-matrix layouts) and
batched Householder QR cost ~30x in the Brent likelihood loops; this module
is the single home for the pattern shared by ``ops.wls.wls_ell``,
``ops.liteqtl`` and the fused Pallas kernel.

Entries are keyed dicts: ``G[(k, l)]`` for k <= l holds the (k, l) Gram
entry as an array broadcastable against the substitution right-hand sides.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import jax.numpy as jnp


def pair_indices(c: int) -> List[Tuple[int, int]]:
    """Upper-triangular (k, l), k <= l, ordering for Gram entries."""
    return [(k, l) for k in range(c) for l in range(k, c)]


def unrolled_cholesky(G: Dict[Tuple[int, int], jnp.ndarray], c: int):
    """Lower-triangular factor entries ``L[(i, k)]`` of G = L L^T."""
    L: Dict[Tuple[int, int], jnp.ndarray] = {}
    for k in range(c):
        s = G[(k, k)]
        for q in range(k):
            s = s - L[(k, q)] * L[(k, q)]
        L[(k, k)] = jnp.sqrt(s)
        for i in range(k + 1, c):
            s = G[(k, i)] if (k, i) in G else G[(i, k)]
            for q in range(k):
                s = s - L[(i, q)] * L[(k, q)]
            L[(i, k)] = s / L[(k, k)]
    return L


def fwd_subst(L, rows: Sequence[jnp.ndarray], c: int) -> List[jnp.ndarray]:
    """Solve ``L z = rows`` by forward substitution; rows may be any shapes
    broadcastable against the factor entries (e.g. (m,) scalars-per-trait or
    (p, m) marker blocks)."""
    z: List[jnp.ndarray] = []
    for k in range(c):
        s = rows[k]
        for q in range(k):
            s = s - L[(k, q)] * z[q]
        z.append(s / L[(k, k)])
    return z


def decovariate(M: jnp.ndarray, C: jnp.ndarray) -> jnp.ndarray:
    """``M`` (n, k) minus its least-squares fit on the columns of ``C``
    (n, c), as an explicit residual at the operands' dtype. A column that
    collapses to rounding noise (a monomorphic marker, a trait the
    covariates explain) comes back exactly zero (:func:`residual_keep_mask`).

    Every scan statistic is invariant under ``x -> x + C a``: the engines
    residualize against the (weighted) covariates anyway. Their f32 GEMMs
    and normal-equations combines are not: an uncentered genotype column
    (mean ~0.5) carries several times its informative norm^2, and
    ``D = D1 - sum Z^2`` rounds at that scale. Applied at the solve dtype,
    before the cast to the GEMM dtype, this leaves the f32 arithmetic only
    the informative part."""
    c = C.shape[1]
    L = unrolled_cholesky(
        {(k, l): jnp.dot(C[:, k], C[:, l]) for k, l in pair_indices(c)}, c
    )
    R = M
    for q in fwd_subst(L, [C[:, k] for k in range(c)], c):  # C L^-T columns
        R = R - q[:, None] * jnp.matmul(q, R)[None, :]
    keep = residual_keep_mask(jnp.sum(R * R, axis=0), jnp.sum(M * M, axis=0))
    return R * keep[None, :]


def residual_sq(total_sq: jnp.ndarray, zeta: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """``||r||^2 = total_sq - sum zeta_k^2`` with a cancellation floor.

    The normal-equations identity can cancel slightly negative under f32 for
    inputs nearly collinear with the covariates (the reference's explicit
    residualization is nonnegative by construction); clamp at a tiny
    positive multiple of the total so downstream sqrt/log never produce NaN
    — a genuinely collinear input then yields |r| -> 1 (huge LOD), matching
    the reference's degenerate behavior rather than poisoning the row.
    """
    out = total_sq
    for zk in zeta:
        out = out - zk * zk
    eps = jnp.finfo(out.dtype).eps
    return jnp.maximum(out, 4.0 * eps * total_sq)


def residual_keep_mask(post, pre, rel: float = 1024.0, *, eps=None):
    """1.0 where a covariate-residualized column retains genuine variance,
    0.0 where it collapsed to rounding noise — monomorphic or
    covariate-collinear markers, fully covariate-explained traits.

    Normalizing a rounding-noise residual produces a random unit vector
    whose correlations with anything are O(1/sqrt(n)) NOISE (~0.1 LOD at
    n = 50, amplified by grid maximization in alt-grid) instead of the
    exact r = 0 a zero-information column must contribute. The reference
    refuses such columns outright (src/util.jl:47-71 ``checkZeros`` throws
    on zero-variance columns); we zero their correlations so bulk engines
    keep running on real panels, which always contain a few (COMPAT.md
    #13). LAPACK-style relative rank test on norms: keep iff
    ``||residual|| > rel * eps * ||pre-residualization||`` (compared in
    squares — valid ONLY for ``post`` summed from an EXPLICIT residual
    vector, whose noise floor is ``(eps ||x||)^2``; for difference-of-
    squares norms use :func:`cancel_keep_mask`). ``1024 eps`` is ~1e-4
    relative in f32, far above projection rounding noise ~c*eps and far
    below any genuine signal.

    ``eps``: noise scale of the dtype the residual was COMPUTED in. Pass
    ``jnp.finfo(precision.resolve_kernel()).eps`` whenever operands were
    rounded through the kernel dtype — under x64 mixed arithmetic the
    result array can promote to f64 while the noise stays f32-sized, and
    the default (``post.dtype`` eps) would then be ~1e9x too small.
    """
    post = jnp.asarray(post)
    if eps is None:
        eps = jnp.finfo(post.dtype).eps
    return (post > (rel * eps) ** 2 * pre).astype(post.dtype)


def cancel_keep_mask(post, pre, rel: float = 1024.0, *, eps=None):
    """Keep mask for residual norms computed by CANCELLATION —
    ``residual_sq``'s normal-equations identity ``||x||^2 - sum zeta^2``.

    A difference of squares has absolute noise ``~eps * pre`` (and
    ``residual_sq`` floors exactly there, at ``4 eps pre``), so the
    explicit-residual threshold ``(rel eps)^2 pre`` of
    :func:`residual_keep_mask` sits ~1/eps BELOW the noise and never
    fires. Keep iff ``post > rel * eps * pre`` — linear in eps: ~250x
    above the ``residual_sq`` floor, and a genuine marker keeps >= 99.99%
    (f64) / 99.99 R^2 %% (f32, where a marker that collinear is noise
    anyway; the reference refuses such columns outright,
    src/util.jl:47-71). Same ``eps`` convention as
    :func:`residual_keep_mask`: pass the KERNEL dtype's eps when operands
    were rounded through it.
    """
    post = jnp.asarray(post)
    if eps is None:
        eps = jnp.finfo(post.dtype).eps
    return (post > rel * eps * pre).astype(post.dtype)
