"""Fused bulk-permutation kernel, Pallas on Triton: genome-wide
permutation maxima for a block of traits without materializing any
(markers x traits x perms) correlations.

Reference semantics: per trait, ``scan_perms_lite``'s hot GEMM + per-column
max (src/scan.jl:534-543 + src/analysis_helpers/single_trait_analysis.jl:15)
— here for every trait at once (ops/bulkperm.py derives the batching
identities).

Why a kernel: the full (p, m, nperms) correlation tensor at BXD scale is
7,321 x 35,554 x 1,001 ~ 1 TB in f32. The XLA engine
(ops/bulkperm.py::max_r2_perms_xla) writes each trait's (Kc, p) numerator
to device memory and reads it back for the max. What the user needs is
only its max over markers: each program here owns a group of traits and
one permutation tile, loops over every marker tile inside the block, and
keeps the running max of r^2 in registers. Blocks are independent, so the
result is deterministic and needs no atomics.

The self-adjoint projector identity moves the covariate residualization
to the (n,)-scale trait side, where XLA does it ONCE per trait:

    <(I-P_t)(X ⊙ sw_t), s_k> = <X, sw_t ⊙ (I-P_t) s_k>

so the XLA prep hands the kernel ``S2[t] = sw_t ⊙ (I-P_t) S_t`` (the
shuffled unit residuals, covariate-residualized and weight-folded) and
``inv_xn[t, i] = keep / ||(I-P_t)(x_i ⊙ sw_t)||^2`` (from the XLA engine's
own ``perm_trait_marker_parts`` — the degenerate-marker mask arrives as
inv_xn = 0 exactly, COMPAT.md #15). Per (trait, marker tile) the kernel
runs ONE dot ``X_tile @ S2[t]``, looped over n-tiles, and a masked
``max(num^2 * inv_xn)``. Dots run at the caller's GEMM precision
(altgrid_fused.py::kernel_dot_precision).

The kernel emits max r^2; the monotone LOD transform runs outside, at
the solve dtype (altgrid_fused.py::lod_from_one_minus_r2).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .altgrid_fused import (
    _pad, _pad_to, kernel_dot_precision, lod_from_one_minus_r2,
)

_HI = jax.lax.Precision.HIGHEST

_TM = 8  # traits per program
_TK = 64  # permutations per program
_TN = 16  # n-tile of the contraction (Triton's smallest dot)
_NUM_WARPS = 4
_NUM_STAGES = 3


def _kernel(x_ref, s_ref, ixn_ref, o_ref, *, p_tiles, n_tiles, tp, tn, tk,
            dot_precision):
    """One program = _TM traits x one permutation tile x every marker tile.

    x_ref:   (p_pad, n_pad)     rotated markers, transposed (shared by all
                                traits)
    s_ref:   (mb, n_pad, k_pad) weight-folded, covariate-residualized
                                shuffled unit residuals  sw_t ⊙ (I-P_t) S_t
    ixn_ref: (mb, p_pad)        per-(trait, marker) 1/||residualized
                                weighted marker||^2, 0 where masked
    o_ref:   (mb, k_pad)        max over markers of r^2 per (trait, perm)
    """
    t0 = pl.program_id(0) * _TM
    kc = pl.ds(pl.program_id(1) * tk, tk)

    def marker_step(i, best):
        rows = pl.ds(i * tp, tp)
        out = []
        for t in range(_TM):

            def n_step(q, acc):
                nn = pl.ds(q * tn, tn)
                return acc + pl.dot(
                    x_ref[rows, nn], s_ref[t0 + t, nn, kc],
                    precision=dot_precision,
                )

            num = jax.lax.fori_loop(
                0, n_tiles, n_step, jnp.zeros((tp, tk), jnp.float32)
            )
            # padded markers are all-zero AND their inv_xn is 0 -> r2 = 0;
            # degenerate (monomorphic / covariate-collinear) markers arrive
            # with inv_xn = 0 exactly (COMPAT.md #15)
            r2 = (num * num) * ixn_ref[t0 + t, rows][:, None]
            out.append(jnp.maximum(best[t], jnp.max(r2, axis=0)))
        return tuple(out)

    best = jax.lax.fori_loop(
        0, p_tiles, marker_step,
        tuple(jnp.zeros((tk,), jnp.float32) for _ in range(_TM)),
    )
    for t in range(_TM):
        o_ref[t0 + t, kc] = best[t]


def fused_perm_maxlods(
    X0m,
    S2,
    inv_xn,
    *,
    n: int,
    precision,
    tile_p: int = 64,
    interpret: bool = False,
):
    """(mb, K) genome-wide max LODs for a block of traits.

    X0m: (n, p) rotated markers; S2: (mb, n, K) weight-folded,
    covariate-residualized shuffled unit residuals
    ``sw_t ⊙ (I-P_t) S_t`` (see :func:`fused_perm_prep`); inv_xn: (mb, p)
    reciprocal residualized-weighted-marker norms, 0 where the
    degenerate-marker mask fired. ``n`` is the true sample count (LOD
    factor). ``tile_p`` (markers per dot) is a power of two, at least 16.
    f32 kernel; composable under jit.
    """
    f32 = jnp.float32
    mb = S2.shape[0]
    p = X0m.shape[1]
    K = S2.shape[2]
    if mb % _TM:
        raise ValueError(f"trait block must be a multiple of {_TM} (got {mb})")

    n_pad, p_pad, k_pad = (
        _pad_to(n, _TN), _pad_to(p, tile_p), _pad_to(K, _TK)
    )
    Xt = _pad(X0m.T.astype(f32), (p_pad, n_pad))
    Sp = _pad(S2.astype(f32), (mb, n_pad, k_pad))
    Ip = _pad(inv_xn.astype(f32), (mb, p_pad))

    kernel = functools.partial(
        _kernel, p_tiles=p_pad // tile_p, n_tiles=n_pad // _TN,
        tp=tile_p, tn=_TN, tk=_TK,
        dot_precision=kernel_dot_precision(precision.gemm_precision),
    )
    maxr2 = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((mb, k_pad), f32),
        grid=(mb // _TM, k_pad // _TK),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        interpret=interpret,
        name="bulkperm_fused",
    )(Xt, Sp, Ip)
    one_minus = 1.0 - maxr2[:, :K].astype(precision.resolve_solve())
    return lod_from_one_minus_r2(one_minus, n, precision).astype(
        precision.resolve_kernel()
    )


def fused_perm_trait_block(X0m, sqrtw_blk, Qblk, *, precision):
    """Permutation-INDEPENDENT trait-block prep for
    :func:`fused_perm_maxlods`, computed once per trait block and reused
    by every permutation chunk (the pallas analog of the XLA engine's
    hoisted ``_bulkperm_xla_trait_block``).

    Returns ``inv_xn`` (mb, p): ``keep / ||(I-P_t)(x_i ⊙ sw_t)||^2`` from
    :func:`ops.bulkperm.perm_trait_marker_parts` (masked degenerate
    markers arrive as xn = +inf there, so 1/xn = 0 exactly). The norms are
    a difference of squares, so they are taken at the solve dtype (f64
    under BALANCED; once per trait block, a few GFLOP at BXD width): in
    f32 their cancellation was the largest error term of the permutation
    maxima.
    """
    from ..ops.bulkperm import perm_trait_marker_parts

    _, xns = perm_trait_marker_parts(
        X0m, sqrtw_blk, Qblk, precision=precision,
        dtype=precision.resolve_solve(),
    )
    inv = (1.0 / xns).astype(jnp.float32)
    # a kept xn below ~1e-38 (marker amplitudes ~1e-19, below any real
    # dataset) overflows 1/xn to +inf in f32, and a zero num^2 times inf
    # would NaN the row's max — clamp nonfinite to 0
    return jnp.where(jnp.isfinite(inv), inv, jnp.zeros_like(inv))


def fused_perm_chunk_inputs(sqrtw_blk, Qblk, wrn_blk, idx_blk):
    """Per-(trait block, perm chunk) prep for :func:`fused_perm_maxlods`.

    Returns ``S2`` (mb, n, Kc): shuffled unit residuals, covariate-
    residualized against each trait's weighted-covariate orthobasis and
    folded with the trait's sqrt-weights — ``sw_t ⊙ (I - Q_t^T Q_t) S_t``
    (the self-adjoint move of the projector from the marker side, so the
    kernel runs ONE dot per (trait, marker tile)).
    """
    f32 = jnp.float32
    St = jnp.transpose(wrn_blk[idx_blk], (2, 1, 0)).astype(f32)  # (mb, n, Kc)
    Q = Qblk.astype(f32)  # (mb, c, n)
    proj = jnp.einsum("tcn,tnk->tck", Q, St, precision=_HI)
    Sr = St - jnp.einsum("tcn,tck->tnk", Q, proj, precision=_HI)
    return sqrtw_blk.astype(f32)[:, :, None] * Sr


def fused_perm_prep(X0m, sqrtw_blk, Qblk, wrn_blk, idx_blk, *, precision):
    """Both prep stages in one call — for single-chunk callers (the
    shard_map body runs one chunk per device call, so nothing is wasted)."""
    S2 = fused_perm_chunk_inputs(sqrtw_blk, Qblk, wrn_blk, idx_blk)
    inv_xn = fused_perm_trait_block(X0m, sqrtw_blk, Qblk, precision=precision)
    return S2, inv_xn
