"""Fused alt-grid (grid-approximated Exact-LMM) kernel, Pallas on Triton.

Reference semantics: ``bulkscan_alt_grid`` evaluates, for every
(marker, trait) pair, the alternative-model log-likelihood at each h2 grid
point and keeps the max (reference src/bulkscan.jl:428-527; its ``tmax!``
counter bug — h2_panel picking ``hsq_list[count]`` instead of the argmax —
is fixed here, as in models/bulkscan.py).

Why a kernel: the XLA formulation (``lax.scan`` over grid points in
models/bulkscan.py::_alt_grid_impl) writes the (p, m) correlation matrix
and reads and writes the (p, m) running max and argmax carries in device
memory on every grid step. Here each program owns one (TP, TM) output
tile and loops over all g grid steps inside the block, with the running
min and argmin in registers, so the (p, m) outputs are written once.
Blocks are independent: there is no cross-block reduction.

Two identities keep the loop cheap:

1. **No transcendentals in the loop.** Maximizing
   ``logL1_k = -(n/2) ln(1 - r_k^2) + ell0_k`` over k is equivalent to
   minimizing ``u_k = (1 - r_k^2) * exp(-(2/n)(ell0_k - max_k ell0_k))``
   (a monotone transform; the per-(grid, trait) factors are computed once
   outside the kernel at (g, m) scale). The kernel emits ``min_k u_k`` and
   ``LOD = -(n/2) log10(min_k u_k)`` (== (max_k logL1 - max_k ell0)/ln10)
   is one elementwise pass outside it (:func:`lod_from_one_minus_r2`).
2. **Markers are never residualized per grid step.** The trait operand is
   already residualized against the weighted covariates ``Q_k`` and
   normalized, so the projector drops out of the marker side:
   ``<(I - Q_k Q_k^T)(s_k ⊙ x), y00_k> = <x, s_k ⊙ y00_k>``. The kernel
   contracts the raw rotated markers (shared by every grid step) against
   the (g, n, m) stack ``s_k ⊙ y00_k`` and scales by the precomputed
   (g, p) inverse residual marker norms. The contraction over n is a loop
   over n-tiles, so any sample count compiles.

All dots run at the caller's GEMM precision as bf16 splits on the tensor
cores (:func:`kernel_dot_precision`): six passes for ``Precision.HIGHEST``,
three for the THROUGHPUT tier's ``Precision.HIGH``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..ops.lod import log10_f32_accurate
from ..ops.smallchol import residual_keep_mask
from ..ops.weights import make_weights

_TN = 16  # n-tile of the contraction (Triton's smallest dot)
_NUM_WARPS = 4
_NUM_STAGES = 3


def kernel_dot_precision(gemm_precision):
    """Triton dot algorithm for a ``PrecisionConfig.gemm_precision``.

    HIGHEST runs as a six-pass bf16 split on the tensor cores with f32
    accumulation. On an H100 at full BXD width it measured more accurate
    than Triton's IEEE f32 dot (an 80-long FMA chain per output): max
    |dLOD| vs f64 6.2e-6 vs 9.5e-6 (alt-grid) and 1.40e-5 vs 1.99e-5
    (permutation maxima). It was faster for alt-grid (0.0191 vs 0.0223 s)
    and about 12% slower for the permutations (2.208 vs 1.963 s); PERF.md
    has the run. HIGH (THROUGHPUT) runs as the three-pass split; Triton's
    own HIGH would be single-pass TF32."""
    if gemm_precision == jax.lax.Precision.HIGH:
        return jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    return jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X6


def _kernel(x_ref, y_ref, ixn_ref, c_ref, u_ref, k_ref=None, *,
            g, n_tiles, tn, tp, tm, dot_precision):
    """One (TP, TM) output tile, every grid step.

    x_ref:   (n_pad, p_pad)    raw rotated markers
    y_ref:   (g, n_pad, m_pad) s_k ⊙ y00_k: weighted, covariate-residualized,
                               unit-norm traits per grid step
    ixn_ref: (g, p_pad)        keep / ||residualized weighted marker||
    c_ref:   (g, m_pad)        exp(-(2/n)(ell0[k] - ell0max)) per trait
    u_ref:   (p_pad, m_pad)    min over k of u_k
    k_ref:   (p_pad, m_pad)    int8 argmin grid index, or None
                               (``output_h2_panel=False``)
    """
    rows = pl.ds(pl.program_id(0) * tp, tp)
    cols = pl.ds(pl.program_id(1) * tm, tm)
    tiny = jnp.finfo(jnp.float32).tiny

    def grid_step(k, carry):
        umin, kmin = carry

        def n_step(t, acc):
            nn = pl.ds(t * tn, tn)
            return acc + pl.dot(
                x_ref[nn, rows], y_ref[k, nn, cols], trans_a=True,
                precision=dot_precision,
            )

        num = jax.lax.fori_loop(
            0, n_tiles, n_step, jnp.zeros((tp, tm), jnp.float32)
        )
        r = num * ixn_ref[k, rows][:, None]
        # r^2 can round to >= 1 for a marker perfectly correlated with a
        # trait; the floor keeps u a normal positive number, whose log the
        # epilogue takes
        u = jnp.maximum(1.0 - r * r, tiny) * c_ref[k, cols][None, :]
        upd = u < umin  # strict: first min wins, like Julia findmax
        return jnp.where(upd, u, umin), jnp.where(upd, k, kmin)

    umin, kmin = jax.lax.fori_loop(
        0, g, grid_step,
        (jnp.full((tp, tm), jnp.inf, jnp.float32),
         jnp.zeros((tp, tm), jnp.int32)),
    )
    u_ref[rows, cols] = umin
    if k_ref is not None:
        k_ref[rows, cols] = kmin.astype(jnp.int8)


def lod_from_one_minus_r2(one_minus, n, precision):
    """``-(n/2) log10(one_minus)`` of a kernel's f32 output, at the solve
    dtype: an f32 log's ~1e-7 absolute error times n/2 is a visible share
    of the 1e-5 LOD bar, and this epilogue is one elementwise pass. An
    all-f32 config keeps the accurate-f32 polynomial log (ops/lod.py).
    Floored at f32-tiny: r2 can round to >= 1 for a perfectly correlated
    marker."""
    sdt = precision.resolve_solve()
    one_minus = jnp.maximum(one_minus.astype(sdt),
                            jnp.finfo(jnp.float32).tiny)
    if jnp.dtype(sdt) == jnp.float32:
        return (-0.5 * n) * log10_f32_accurate(one_minus)
    return (-0.5 * n) * jnp.log10(one_minus)


def _pad(x, shape):
    return jnp.pad(x, [(0, s - d) for s, d in zip(shape, x.shape)])


def _pad_to(n, tile):
    return n + (-n) % tile


def altgrid_operands(Y0, X0m, C0, lam, h2_grid, *, prior, reml, precision):
    """Per-grid-step operands of the kernel, computed in XLA at (g, n, m),
    (g, p) and (g, m) scale.

    Returns ``(Yt, ixn, cmat)``: ``Yt`` (g, n, m) weighted, covariate-
    residualized, unit-norm traits folded with the sqrt-weights; ``ixn``
    (g, p) inverse residualized weighted marker norms, 0 where the
    degenerate-marker mask fires; ``cmat`` (g, m) likelihood factors. The
    residualization and masks are those of
    ``ops.liteqtl.weighted_correlation_shared``, in the kernel dtype.
    """
    from ..models.bulkscan import grid_null_ell

    sdt = precision.resolve_kernel()
    pgp = precision.gemm_precision
    eps = jnp.finfo(sdt).eps
    tiny = jnp.finfo(sdt).tiny
    n = Y0.shape[0]

    # (g, m) null log-likelihoods at the solve dtype (f64 under BALANCED),
    # exactly as the XLA path evaluates them
    ells = grid_null_ell(Y0, C0, lam, h2_grid, prior, reml=reml)
    ell0max = jnp.max(ells, axis=0)
    cmat = jnp.exp(-(2.0 / n) * (ells - ell0max[None, :])).astype(jnp.float32)

    X = X0m.astype(sdt)
    Y = Y0.astype(sdt)
    C = C0.astype(sdt)

    def one(h2):
        s = jnp.sqrt(jnp.abs(make_weights(h2, lam))).astype(sdt)
        q, _ = jnp.linalg.qr(C * s[:, None], mode="reduced")

        def residual(M):
            Mw = M * s[:, None]
            Mr = Mw - jnp.matmul(q, jnp.matmul(q.T, Mw, precision=pgp),
                                 precision=pgp)
            nrm2 = jnp.sum(Mr * Mr, axis=0)
            keep = residual_keep_mask(nrm2, jnp.sum(Mw * Mw, axis=0), eps=eps)
            return Mr, keep / jnp.sqrt(jnp.maximum(nrm2, tiny))

        Yr, iyn = residual(Y)
        _, ixn = residual(X)
        return (s[:, None] * Yr * iyn[None, :]).astype(jnp.float32), ixn

    # sequential over the grid: one (n, p) residual temporary at a time
    Yt, ixn = jax.lax.map(one, h2_grid)
    return Yt, ixn.astype(jnp.float32), cmat


def fused_alt_grid(
    Y0,
    X0m,
    C0,
    lam,
    h2_grid,
    *,
    prior,
    reml: bool = False,
    precision,
    tile_p: int = 64,
    tile_m: int = 64,
    interpret: bool = False,
    output_h2_panel: bool = True,
):
    """(p, m) alt-grid LOD matrix + (p, m) argmax h2 panel, fused.
    ``output_h2_panel=False`` skips the argmin store and returns
    ``(L, None)``.

    Y0/X0m/C0/lam: eigen-rotated traits (n, m), markers (n, p), covariates
    (n, c), eigenvalues (n,). Numerics match ``_alt_grid_impl`` with a
    float32 GEMM dtype; the per-(grid, trait) null likelihoods ``ell0`` are
    evaluated at the input dtype outside the kernel. Tiles are powers of
    two (Triton's block shapes), at least 16 (its smallest dot).
    Composable under jit; called via models/bulkscan.py
    (``bulkscan(..., method="alt-grid")`` selects it on a GPU).
    """
    n, m = Y0.shape
    p = X0m.shape[1]
    g = int(h2_grid.shape[0])
    if g > 127:
        raise ValueError("h2 grid larger than 127 points (int8 argmax panel)")

    Yt, ixn, cmat = altgrid_operands(
        Y0, X0m, C0, lam, h2_grid, prior=prior, reml=reml, precision=precision
    )
    n_pad, p_pad, m_pad = (
        _pad_to(n, _TN), _pad_to(p, tile_p), _pad_to(m, tile_m)
    )
    # zero padding drops out of every dot; padded markers get ixn = 0 and
    # padded traits factor 1, and both are sliced off below
    X = _pad(X0m.astype(jnp.float32), (n_pad, p_pad))
    Yt = _pad(Yt, (g, n_pad, m_pad))
    ixn = _pad(ixn, (g, p_pad))
    cmat = jnp.pad(cmat, ((0, 0), (0, m_pad - m)), constant_values=1.0)

    kernel = functools.partial(
        _kernel, g=g, n_tiles=n_pad // _TN, tn=_TN, tp=tile_p,
        tm=tile_m, dot_precision=kernel_dot_precision(precision.gemm_precision),
    )
    u_shape = jax.ShapeDtypeStruct((p_pad, m_pad), jnp.float32)
    out = pl.pallas_call(
        kernel,
        out_shape=(
            (u_shape, jax.ShapeDtypeStruct((p_pad, m_pad), jnp.int8))
            if output_h2_panel else u_shape
        ),
        grid=(p_pad // tile_p, m_pad // tile_m),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        interpret=interpret,
        name="altgrid_fused",
    )(X, Yt, ixn, cmat)

    umin, kmin = out if output_h2_panel else (out, None)
    L = lod_from_one_minus_r2(umin[:p, :m], n, precision).astype(Y0.dtype)
    if kmin is None:
        return L, None
    return L, h2_grid[kmin[:p, :m].astype(jnp.int32)]
