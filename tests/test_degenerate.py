"""Degenerate-input robustness matrix.

Reference failure surface being matched:

- ``src/util.jl:47-71`` — ``checkZeros``: standardizing a zero-variance
  column throws ("Dividing by zeros");
- ``src/lmm.jl:19-21`` — h2 = 1 throws in ``makeweights``;
- ``src/transform_helpers.jl:27-30`` — non-SPD kinship warns (negative
  eigenvalues).

This framework's policy (COMPAT.md #10, #15-#17):

- degenerate MARKERS (monomorphic, covariate-collinear) carry no
  association information: they produce LOD ~ 0 via the r=0 floor instead
  of NaN-poisoning whole rows or genome-wide max-reductions, and healthy
  markers' results are bit-unaffected by a degenerate neighbor;
- h2 = 1 clamps finitely under jit (delta capped) — the optimizer never
  evaluates the closed endpoint;
- exactly singular kinships (duplicate individuals) rotate fine: zero
  eigenvalues give finite weights for every h2 < 1;
- rank-deficient COVARIATES are refused at the entry points with a clear
  host-side error (the null model is unidentifiable; under jit, silent
  NaN would be the only alternative);
- rank-k factorizations with k > rank(K) zero-pad the spectrum and
  reproduce the full-rank engine exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import bulklmm_tpu as bl
from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact
from bulklmm_tpu.utils.config import BALANCED, FAST32

PRECISIONS = [
    pytest.param(FAST32, 2e-3, id="fast32"),
    pytest.param(BALANCED, 1e-5, id="balanced"),
]
METHODS = ["null-grid", "null-exact", "alt-grid"]


@pytest.fixture(scope="module")
def deg():
    rng = np.random.default_rng(77)
    n, p, m = 48, 20, 6
    Gh = rng.choice([0.0, 0.5, 1.0], size=(n, p))  # healthy panel
    covar = rng.normal(size=(n, 2))
    # two degenerate marker columns appended to the healthy panel:
    mono = np.full((n, 1), 0.5)  # monomorphic (zero variance)
    colin = 0.7 + 0.3 * covar[:, :1]  # exactly in span{intercept, covar}
    G = np.concatenate([Gh, mono, colin], axis=1)
    K = np.asarray(bl.calc_kinship(Gh))
    Y = rng.normal(size=(n, m))
    Y[:, 1] += 0.9 * (Gh[:, 7] - Gh[:, 7].mean())
    # h2 -> 1 trait: almost pure genetic signal
    w, V = np.linalg.eigh(K)
    g = V @ (np.sqrt(np.maximum(w, 0.0)) * rng.normal(size=n))
    Y[:, 4] = g + 1e-6 * rng.normal(size=n)
    return Gh, G, K, Y, covar


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("precision,tol", PRECISIONS)
def test_bulkscan_degenerate_markers(deg, method, precision, tol):
    """Monomorphic + covariate-collinear markers across all three bulk
    methods x FAST32/BALANCED: finite everywhere, ~0 LOD at the degenerate
    columns, healthy columns unaffected."""
    Gh, G, K, Y, covar = deg
    res = bl.bulkscan(Y, G, K, covar, method=method, precision=precision)
    L = np.asarray(res.L)
    assert np.all(np.isfinite(L)), method
    assert np.max(np.abs(L[-2:])) < tol, (method, L[-2:].max())
    ref = bl.bulkscan(Y, Gh, K, covar, method=method, precision=precision)
    assert np.max(np.abs(L[:-2] - np.asarray(ref.L))) < tol


@pytest.mark.parametrize("precision,tol", PRECISIONS)
def test_scan_degenerate_markers_null_alt_perms(deg, precision, tol):
    """Single-trait scan on the degenerate panel: null, exact-alt (per-
    marker Brent on a rank-deficient augmented design), and the
    permutation path must all stay finite with ~0 LOD at the degenerate
    columns."""
    Gh, G, K, Y, covar = deg
    y = Y[:, 1]
    r_null = bl.scan(y, G, K, covar, precision=precision)
    assert np.all(np.isfinite(np.asarray(r_null.lod)))
    assert np.max(np.abs(np.asarray(r_null.lod[-2:]))) < tol
    ref = bl.scan(y, Gh, K, covar, precision=precision)
    assert np.max(np.abs(np.asarray(r_null.lod[:-2]) - np.asarray(ref.lod))) < tol
    r_alt = bl.scan(y, G, K, covar, assumption="alt", precision=precision)
    assert np.all(np.isfinite(np.asarray(r_alt.lod)))
    assert np.max(np.abs(np.asarray(r_alt.lod[-2:]))) < max(tol, 1e-4)
    r_perm = bl.scan(
        y, G, K, covar, permutation_test=True, nperms=16, precision=precision
    )
    assert np.all(np.isfinite(np.asarray(r_perm.L_perms)))


@pytest.mark.parametrize("precision,tol", PRECISIONS)
def test_bulkperm_degenerate_markers(deg, precision, tol):
    """Genome-wide permutation maxima are max-reductions over markers — a
    single NaN marker would poison every trait x perm cell. Degenerate
    columns must contribute r^2 = 0 and leave the maxima identical to the
    healthy panel's."""
    Gh, G, K, Y, covar = deg
    res = bl.bulkscan_perms(Y, G, K, covar, nperms=16, rndseed=3,
                            precision=precision)
    mx = np.asarray(res.maxlods)
    assert np.all(np.isfinite(mx))
    ref = bl.bulkscan_perms(Y, Gh, K, covar, nperms=16, rndseed=3,
                            precision=precision)
    assert np.max(np.abs(mx - np.asarray(ref.maxlods))) < tol


@pytest.mark.parametrize("precision,tol", PRECISIONS)
def test_streamed_degenerate_markers(deg, precision, tol):
    Gh, G, K, Y, covar = deg
    res = bl.bulkscan_streamed(Y, G, K, covar, marker_block=9,
                               precision=precision)
    L = np.asarray(res.L)
    assert np.all(np.isfinite(L))
    assert np.max(np.abs(L[-2:])) < tol
    ref = bl.bulkscan(Y, Gh, K, covar, precision=precision)
    assert np.max(np.abs(L[:-2] - np.asarray(ref.L))) < tol


@pytest.mark.parametrize("precision,tol", PRECISIONS)
def test_lowrank_degenerate_markers_and_k_beyond_rank(deg, precision, tol):
    """Rank-k engine on the degenerate panel, with k PAST rank(K) (the
    healthy panel has p=20 founders, so rank(K) <= 20 << k=40): the
    zero-padded spectrum must reproduce the full-rank engine, and the
    degenerate markers must floor to LOD 0 through the Woodbury kernels
    too."""
    Gh, G, K, Y, covar = deg
    lr = kinship_lowrank_exact(K, 40, dtype=jnp.float64)  # k > rank(K)
    assert float(jnp.min(lr.lam)) >= 0.0
    res = bl.bulkscan(Y, G, lr, covar, precision=precision)
    L = np.asarray(res.L)
    assert np.all(np.isfinite(L))
    # bound 5e-4: at the double-degenerate corner (h2 -> 1 trait x
    # collinear marker) the Woodbury norms are themselves f32 cancellation
    # differences, so the relative rank mask cannot separate noise from
    # signal there; the residue is bounded LOD noise, not NaN (COMPAT.md #15)
    assert np.max(np.abs(L[-2:])) < max(tol, 5e-4)
    full = bl.bulkscan(Y, G, K, covar, precision=precision)
    # exclude the h2 -> 1 trait (col 4) from exact-parity: at the clamped
    # boundary the profile likelihood is flat and the rotated vs Woodbury
    # formulations can land on adjacent grid points (both are exact LMMs
    # for the same truncated kinship; bounded difference, checked finite)
    cols = [0, 1, 2, 3, 5]
    assert np.max(np.abs(L[:, cols] - np.asarray(full.L)[:, cols])) < max(tol, 1e-4)
    assert np.all(np.isfinite(np.asarray(full.L)))
    # permutation maxima through the rank-k whitening path
    pm = bl.bulkscan_perms(Y, G, lr, covar, nperms=8, rndseed=1,
                           precision=precision)
    assert np.all(np.isfinite(np.asarray(pm.maxlods)))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("precision,tol", PRECISIONS)
def test_singular_kinship_duplicate_individuals(deg, method, precision, tol):
    """Duplicate individuals make K exactly singular (reference warns about
    non-SPD kinships, src/transform_helpers.jl:27-30). Rotation handles it:
    zero eigenvalues give finite weights for h2 < 1. All engines finite;
    null-grid checked against the independent dense-Sigma oracle (Sigma =
    h2 K + (1-h2) I is PD for h2 < 1 even when K is singular)."""
    Gh, G, K, Y, covar = deg
    Gd = Gh.copy()
    Gd[1] = Gd[0]  # individuals 0 and 1 identical
    # K' = S K S^T with S duplicating row 0 into row 1: exactly singular,
    # symmetric PSD — the duplicate-individuals kinship
    Kd = np.array(bl.calc_kinship(Gd))  # copy: calc_kinship can be read-only
    Kd[1, :] = Kd[0, :]
    Kd[:, 1] = Kd[:, 0]
    assert np.linalg.matrix_rank(Kd) < Kd.shape[0]
    res = bl.bulkscan(Y, Gd, Kd, covar, method=method, precision=precision)
    assert np.all(np.isfinite(np.asarray(res.L)))
    if method == "null-grid":
        from oracle_dense import bulkscan_null_grid_dense

        d = bulkscan_null_grid_dense(
            Y, Gd, Kd, np.arange(0.0, 0.91, 0.1), covar=covar
        )
        assert np.max(np.abs(np.asarray(res.L) - d["lod"])) < max(tol, 1e-4)
    # single-trait + permutations stay finite too
    r = bl.scan(Y[:, 1], Gd, Kd, covar, permutation_test=True, nperms=8,
                precision=precision)
    assert np.all(np.isfinite(np.asarray(r.L_perms)))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("precision,tol", PRECISIONS)
def test_h2_near_one_trait(deg, method, precision, tol):
    """A trait that is almost pure genetic signal drives the null fit to
    the h2 -> 1 boundary (the reference THROWS there, src/lmm.jl:19-21;
    we clamp delta finitely, COMPAT.md #10). Everything must stay finite
    and h2 estimates must stay in [0, 1]."""
    Gh, G, K, Y, covar = deg
    res = bl.bulkscan(Y, Gh, K, covar, method=method, precision=precision)
    assert np.all(np.isfinite(np.asarray(res.L)))
    if res.h2_null_list is not None:
        h2 = np.asarray(res.h2_null_list)
        assert np.all((h2 >= 0.0) & (h2 <= 1.0))
    r = bl.scan(Y[:, 4], Gh, K, covar, precision=precision)
    assert np.all(np.isfinite(np.asarray(r.lod)))
    assert 0.0 <= float(r.h2_null) <= 1.0


def test_collinear_covariates_refused(deg):
    """Rank-deficient covariates make the null model unidentifiable; every
    entry point refuses them with a clear host-side error instead of
    producing silent NaN under jit (the reference fails opaquely inside
    its QR/Cholesky solves)."""
    Gh, G, K, Y, covar = deg
    dup = np.concatenate([covar, 2.0 * covar[:, :1]], axis=1)  # dependent
    const = np.concatenate([covar, np.ones((covar.shape[0], 1))], axis=1)
    lr = kinship_lowrank_exact(K, 10, dtype=jnp.float64)
    for bad in (dup, const):  # const collides with the added intercept
        with pytest.raises(ValueError, match="[Cc]ovariate"):
            bl.scan(Y[:, 0], Gh, K, bad)
        with pytest.raises(ValueError, match="[Cc]ovariate"):
            bl.bulkscan(Y, Gh, K, bad)
        with pytest.raises(ValueError, match="[Cc]ovariate"):
            bl.bulkscan_perms(Y, Gh, K, bad, nperms=4)
        with pytest.raises(ValueError, match="[Cc]ovariate"):
            bl.bulkscan_streamed(Y, Gh, K, bad, marker_block=8)
        with pytest.raises(ValueError, match="[Cc]ovariate"):
            bl.bulkscan(Y, Gh, lr, bad)
    # a well-conditioned covariate matrix still passes
    ok = bl.bulkscan(Y, Gh, K, covar)
    assert np.all(np.isfinite(np.asarray(ok.L)))


def test_per_trait_affine_scale_invariance(deg):
    """LOD scores are invariant under per-trait affine rescaling (the
    correlation form divides out scale; the intercept absorbs shift) —
    must hold across 24+ orders of magnitude without over/underflow
    (measured 6e-14 in f64, round-4 probe)."""
    Gh, G, K, Y, covar = deg
    base = np.asarray(bl.bulkscan(Y, Gh, K, covar).L)
    for expo in (-12, 12):
        scale = 10.0 ** expo
        Ls = np.asarray(bl.bulkscan(Y * scale + 7.0 * scale, Gh, K, covar).L)
        assert np.isfinite(Ls).all()
        assert np.max(np.abs(Ls - base)) < 1e-9, expo
    r = bl.scan(Y[:, 1] * 1e12, Gh, K, covar, permutation_test=True, nperms=8)
    assert np.all(np.isfinite(np.asarray(r.L_perms)))


def test_per_marker_affine_scale_invariance(deg):
    """LODs are invariant under per-MARKER affine re-encoding (0/1 vs
    -1/1 vs dosage scalings): each marker enters its design alone with an
    intercept. Holds at wild mixed scales (measured 4e-14 in f64)."""
    Gh, G, K, Y, covar = deg
    rng = np.random.default_rng(9)
    p = Gh.shape[1]
    base = np.asarray(bl.bulkscan(Y, Gh, K, covar).L)
    scales = rng.uniform(0.5, 2.0, p) * 10.0 ** rng.integers(-8, 9, p)
    G2 = Gh * scales[None, :] + (rng.normal(size=p) * scales)[None, :]
    L2 = np.asarray(bl.bulkscan(Y, G2, K, covar).L)
    assert np.isfinite(L2).all()
    assert np.max(np.abs(L2 - base)) < 1e-9
    L3 = np.asarray(bl.bulkscan(Y, 2.0 * Gh - 1.0, K, covar).L)
    assert np.max(np.abs(L3 - base)) < 1e-9
