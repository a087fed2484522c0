"""Kinship (genetic-relatedness) matrix from genotype probabilities.

Parity: reference ``calcKinship`` (src/kinship.jl:4-13):

    X = G - 0.5;  K = 2 * (X X^T) / p + 0.5;  diag(K) = 1

One rank-n GEMM over all markers — a single device matmul. For
marker counts too large for one device, ``calc_kinship_sharded`` computes the
same GEMM over a marker-sharded mesh axis with a ``psum`` reduction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.config import DEFAULT_PRECISION, PrecisionConfig


def calc_kinship(
    geno,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    *,
    marker_chunk: int = 0,
):
    """Kinship matrix from an (n, p) genotype-probability matrix.

    ``marker_chunk`` > 0 streams marker blocks through a ``lax.scan``
    accumulation so panels too large for device memory (biobank p ~ 10^6)
    never materialize at once; 0 (default) is the single-GEMM path.
    """
    dtype = precision.resolve_solve()
    X = jnp.asarray(geno, dtype=dtype) - 0.5
    p = X.shape[1]
    if marker_chunk and marker_chunk < p:
        pad = (-p) % marker_chunk
        if pad:
            # zero-pad: (X - 0.5) padding contributes 0 to the cross-product
            X = jnp.concatenate([X, jnp.zeros((X.shape[0], pad), dtype=dtype)], axis=1)
        k = X.shape[1] // marker_chunk
        blocks = jnp.moveaxis(X.reshape(X.shape[0], k, marker_chunk), 1, 0)

        def step(acc, blk):
            return acc + jnp.matmul(blk, blk.T, precision=precision.gemm_precision), None

        acc0 = jnp.zeros((X.shape[0], X.shape[0]), dtype=dtype)
        XXt, _ = jax.lax.scan(step, acc0, blocks)
    else:
        XXt = jnp.matmul(X, X.T, precision=precision.gemm_precision)
    K = 2.0 * XXt / p + 0.5
    K = jnp.fill_diagonal(K, 1.0, inplace=False)
    return K


def calc_kinship_sharded(geno_shard, axis_name: str):
    """Kinship from a marker-sharded genotype block inside ``shard_map``.

    ``geno_shard`` is this device's (n, p_local) slice; the cross-product and
    the marker count are both summed over ``axis_name`` so every device ends
    with the identical full (n, n) kinship.

    IMPORTANT: shards must contain REAL marker columns only. Zero-padding a
    shard would be silently wrong here: the ``- 0.5`` shift turns padded
    zeros into -0.5 columns that contribute 0.25 to every cross-product
    entry, and the psum'd marker count would include them. Pad-then-scan
    callers should drop pad columns before calling (or use
    :func:`calc_kinship` with ``marker_chunk``, which pads *after* the
    shift).
    """
    X = geno_shard - 0.5
    local = jnp.matmul(X, X.T, precision=jax.lax.Precision.HIGHEST)
    total = jax.lax.psum(local, axis_name)
    p_total = jax.lax.psum(X.shape[1], axis_name)
    K = 2.0 * total / p_total + 0.5
    return jnp.fill_diagonal(K, 1.0, inplace=False)
