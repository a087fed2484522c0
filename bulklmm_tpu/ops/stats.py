"""Array utilities: centering/scaling/standardization and permutation shuffles.

Functional counterparts of the reference's in-place utilities
(src/util.jl:9-160) — JAX code never mutates, so ``colCenter!`` et al.
become pure functions. Zero-divide guards mirror ``checkZeros``
(src/util.jl:47-56) but raise eagerly only on concrete inputs.

``shuffle_vector`` replaces the MersenneTwister-seeded ``shuffleVector``
(src/util.jl:162-179) with JAX's counter-based threefry PRNG: deterministic
under a seed, but not bit-identical to Julia's stream (parity for permutation
tests is distributional — see tests/test_permutation.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _check_nonzero(x):
    if isinstance(x, jnp.ndarray) and not isinstance(x, jax.core.Tracer):
        import numpy as np

        if np.any(np.isclose(np.asarray(x), 0.0, atol=float(jnp.finfo(x.dtype).eps), rtol=0.0)):
            raise ValueError("Dividing by zeros: the divisor contains zeros.")


def col_center(A):
    """Subtract each column's mean (reference colCenter!, src/util.jl:9)."""
    return A - jnp.mean(A, axis=0, keepdims=True)


def row_center(A):
    """Subtract each row's mean (reference rowCenter!, src/util.jl:28)."""
    return A - jnp.mean(A, axis=1, keepdims=True)


def col_divide(A, x):
    """Divide column j by x[j] (reference colDivide!, src/util.jl:58)."""
    _check_nonzero(x)
    return A / jnp.asarray(x)[None, :]


def row_divide(A, x):
    """Divide row i by x[i] (reference rowDivide!, src/util.jl:98)."""
    _check_nonzero(x)
    return A / jnp.asarray(x)[:, None]


def row_multiply(A, x):
    """Multiply row i by x[i] (reference rowMultiply, src/util.jl:121-158)."""
    return A * jnp.asarray(x)[:, None]


def col_standardize(A):
    """Center and scale each column to unit sample std (ddof=1)
    (reference colStandardize, src/util.jl:80-96)."""
    c = col_center(A)
    s = jnp.std(c, axis=0, ddof=1)
    _check_nonzero(s)
    return c / s[None, :]


def shuffle_vector(key, x, nshuffle: int, *, original: bool = True):
    """(n, nshuffle [+1]) matrix of independent random permutations of ``x``.

    Column 0 is the original vector when ``original=True`` (reference
    shuffleVector, src/util.jl:162-179).
    """
    x = jnp.asarray(x)
    keys = jax.random.split(key, nshuffle)
    perms = jax.vmap(lambda k: jax.random.permutation(k, x))(keys)  # (ns, n)
    out = perms.T
    if original:
        out = jnp.concatenate([x[:, None], out], axis=1)
    return out


def check_covar_full_rank(covar, add_intercept: bool) -> None:
    """Refuse rank-deficient covariate designs at the public entry points.

    A dependent covariate column — a duplicated/linearly-dependent column,
    or a constant column colliding with the auto-added intercept — makes
    the null model unidentifiable; under jit the downstream Gram Cholesky
    would produce silent NaN/garbage (the reference fails opaquely inside
    its QR/Cholesky solves too, src/wls.jl). Host-side check: c is tiny,
    the rank test costs microseconds. No-op for traced inputs (the entry
    points are never jitted; this is belt-and-braces).
    """
    import numpy as np

    try:
        C = np.asarray(covar, dtype=np.float64)
    except Exception:  # traced values cannot be validated host-side
        return
    if C.ndim == 1:
        C = C[:, None]
    if add_intercept:
        C = np.concatenate([np.ones((C.shape[0], 1)), C], axis=1)
    if np.linalg.matrix_rank(C) < C.shape[1]:
        raise ValueError(
            "covariates are rank-deficient (linearly dependent columns, or "
            "a constant column together with the auto-added intercept): the "
            "null model is unidentifiable. Drop the dependent column(s), or "
            "pass add_intercept=False if the covariates already include an "
            "intercept."
        )
