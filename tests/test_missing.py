"""Missing-phenotype (NaN mask) support.

Oracle guarantee under test: a masked run equals the engine run on the
hand-subsetted complete-case data, per trait (the reference has no
missing-data story at all — its tour requires a 'nomissing' input file,
/root/reference/README.md:157, src/readData.jl:159 — so the oracle here is
the engine itself on subset data, which earlier layers verify against
scipy/dense-Sigma oracles)."""

import numpy as np
import pytest

import bulklmm_tpu as bl
from bulklmm_tpu.models.missing import (
    ColSubsetOut, RowSubsetView, missing_groups, subset_kinship,
)
from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact
from bulklmm_tpu.ops.rotation import decompose_kinship


@pytest.fixture(scope="module")
def nan_data():
    rng = np.random.default_rng(11)
    n, p, m = 52, 40, 8
    G = rng.uniform(0, 1, (n, p))
    K = np.asarray(bl.calc_kinship(G))
    X = G - 0.5
    g_eff = X[:, 7][:, None] * rng.normal(0.9, 0.1, m)
    poly = rng.multivariate_normal(np.zeros(n), K, size=m).T
    Y = g_eff + 0.7 * poly + 0.5 * rng.normal(size=(n, m))
    # traits 0,1 share a pattern; 3 and 5 have their own; rest complete
    Y[2:7, 0] = np.nan
    Y[2:7, 1] = np.nan
    Y[10:13, 3] = np.nan
    Y[[1, 20, 30], 5] = np.nan
    return G, Y, K


def _obs(Y, j):
    return np.isfinite(Y[:, j])


# ---------------------------------------------------------------------------
# grouping / subsetting primitives
# ---------------------------------------------------------------------------


def test_missing_groups_partition(nan_data):
    _, Y, _ = nan_data
    finite = np.isfinite(Y)
    groups = missing_groups(finite, drop=False)
    # every trait in exactly one group; group rows = the traits' pattern
    seen = np.concatenate([t for _, t in groups])
    assert sorted(seen) == list(range(Y.shape[1]))
    for rows, traits in groups:
        for j in traits:
            np.testing.assert_array_equal(rows, np.flatnonzero(finite[:, j]))
    # traits 0 and 1 share one group
    g01 = [t for _, t in groups if 0 in t][0]
    assert 1 in g01


def test_subset_kinship_types(nan_data):
    G, _, K = nan_data
    rows = np.arange(5, 40)
    sub = np.asarray(subset_kinship(K, rows))
    np.testing.assert_allclose(sub, K[np.ix_(rows, rows)], rtol=0, atol=0)
    # a cached decomposition reconstructs K before subsetting
    dec = decompose_kinship(K)
    sub2 = np.asarray(subset_kinship(dec, rows))
    np.testing.assert_allclose(sub2, K[np.ix_(rows, rows)], atol=1e-12)
    # rank-k: exact refactorization of U[rows] diag(lam) U[rows]^T with
    # orthonormal output factors
    lr = kinship_lowrank_exact(K, 20)
    lrs = subset_kinship(lr, rows)
    U, lam = np.asarray(lr.U), np.asarray(lr.lam)
    want = (U[rows] * lam) @ U[rows].T
    got = (np.asarray(lrs.U) * np.asarray(lrs.lam)) @ np.asarray(lrs.U).T
    np.testing.assert_allclose(got, want, atol=1e-10)
    UtU = np.asarray(lrs.U).T @ np.asarray(lrs.U)
    np.testing.assert_allclose(UtU, np.eye(UtU.shape[0]), atol=1e-10)


def test_row_subset_view_and_col_out():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(30, 50))
    rows = np.array([0, 3, 7, 29])
    v = RowSubsetView(A, rows)
    assert v.shape == (4, 50)
    np.testing.assert_array_equal(v[:, 10:20], A[rows, 10:20])
    np.testing.assert_array_equal(v[1:3], A[rows[1:3]])
    out = np.zeros((6, 5))
    w = ColSubsetOut(out, np.array([1, 3]))
    w[2:4] = np.array([[1.0, 2.0], [3.0, 4.0]])
    assert out[2, 1] == 1.0 and out[2, 3] == 2.0 and out[3, 3] == 4.0
    np.testing.assert_array_equal(w[2:4], [[1.0, 2.0], [3.0, 4.0]])


# ---------------------------------------------------------------------------
# default policy: refuse with the remediation recipe
# ---------------------------------------------------------------------------


def test_default_errors_everywhere(nan_data):
    G, Y, K = nan_data
    chrom = np.repeat([1, 2], G.shape[1] // 2)
    for f in (
        lambda: bl.scan(Y[:, 0], G, K),
        lambda: bl.scan_perms_lite(Y[:, 0], G, None, K, nperms=4),
        lambda: bl.bulkscan(Y, G, K),
        lambda: bl.bulkscan(Y, G, K, method="alt-grid"),
        lambda: bl.bulkscan_perms(Y, G, K, nperms=4),
        lambda: bl.bulkscan_streamed(Y, G, K, marker_block=16),
        lambda: bl.bulkscan_perms_streamed(Y, G, K, nperms=4,
                                           marker_block=16),
        lambda: bl.bulkscan_loco(Y, G, chrom),
        lambda: bl.bulkscan_perms_loco(Y, G, chrom, nperms=4),
        lambda: bl.scan_loco(Y[:, 0], G, chrom),
    ):
        with pytest.raises(ValueError, match="missing='mask'"):
            f()


def test_invalid_missing_kwarg(nan_data):
    G, Y, K = nan_data
    with pytest.raises(ValueError, match="must be one of"):
        bl.bulkscan(Y, G, K, missing="impute")


def test_complete_Y_identical_results(nan_data):
    """missing='mask' on a complete Y is a no-op (no grouping, no copy)."""
    G, Y, K = nan_data
    Yc = np.nan_to_num(Y, nan=0.0)
    a = bl.bulkscan(Yc, G, K, missing="mask")
    b = bl.bulkscan(Yc, G, K)
    np.testing.assert_array_equal(np.asarray(a.L), np.asarray(b.L))


# ---------------------------------------------------------------------------
# masked == complete-case oracle, across methods and engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
def test_bulkscan_masked_oracle(nan_data, method):
    G, Y, K = nan_data
    res = bl.bulkscan(Y, G, K, method=method, missing="mask",
                      output_pvals=True)
    for j in (0, 3, 5, 6):
        r = _obs(Y, j)
        ref = bl.bulkscan(Y[r][:, [j]], G[r], K[np.ix_(r, r)], method=method,
                          output_pvals=True)
        np.testing.assert_allclose(
            np.asarray(res.L[:, j]), np.asarray(ref.L[:, 0]), atol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(res.log10Pvals_mat[:, j]),
            np.asarray(ref.log10Pvals_mat[:, 0]), atol=1e-12,
        )
        if method == "alt-grid":
            np.testing.assert_allclose(
                np.asarray(res.h2_panel[:, j]),
                np.asarray(ref.h2_panel[:, 0]), atol=1e-12,
            )
        else:
            np.testing.assert_allclose(
                np.asarray(res.h2_null_list[j]),
                np.asarray(ref.h2_null_list[0]), atol=1e-12,
            )


def test_bulkscan_masked_effects(nan_data):
    G, Y, K = nan_data
    res = bl.bulkscan(Y, G, K, missing="mask", output_effects=True)
    r = _obs(Y, 1)
    ref = bl.bulkscan(Y[r][:, [1]], G[r], K[np.ix_(r, r)],
                      output_effects=True)
    np.testing.assert_allclose(
        np.asarray(res.beta_mat[:, 1]), np.asarray(ref.beta_mat[:, 0]),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(res.beta_se_mat[:, 1]), np.asarray(ref.beta_se_mat[:, 0]),
        atol=1e-12,
    )


def test_bulkscan_masked_covar_weights(nan_data):
    """Covariates and heteroskedastic weights subset row-wise with the
    pattern groups."""
    G, Y, K = nan_data
    rng = np.random.default_rng(3)
    covar = rng.normal(size=(Y.shape[0], 2))
    w = rng.uniform(0.5, 2.0, Y.shape[0])
    res = bl.bulkscan(Y, G, K, covar, weights=w, missing="mask")
    r = _obs(Y, 0)
    ref = bl.bulkscan(Y[r][:, [0]], G[r], K[np.ix_(r, r)], covar[r],
                      weights=w[r])
    np.testing.assert_allclose(
        np.asarray(res.L[:, 0]), np.asarray(ref.L[:, 0]), atol=1e-12
    )


def test_masked_lowrank_kinship(nan_data):
    """LowRankKinship inputs subset through the exact rank-k
    refactorization; oracle = the engine on the hand-subset factors."""
    G, Y, K = nan_data
    lr = kinship_lowrank_exact(K, 24)
    res = bl.bulkscan(Y, G, lr, missing="mask")
    for j in (0, 3):
        r = _obs(Y, j)
        rows = np.flatnonzero(r)
        lrs = subset_kinship(lr, rows)
        ref = bl.bulkscan(Y[r][:, [j]], G[r], lrs)
        np.testing.assert_allclose(
            np.asarray(res.L[:, j]), np.asarray(ref.L[:, 0]), atol=1e-10
        )


def test_masked_decomposition_input(nan_data):
    """A cached KinshipDecomposition works: the subset re-decomposes."""
    G, Y, K = nan_data
    dec = decompose_kinship(K)
    res = bl.bulkscan(Y, G, dec, missing="mask")
    ref = bl.bulkscan(Y, G, K, missing="mask")
    np.testing.assert_allclose(
        np.asarray(res.L), np.asarray(ref.L), atol=1e-9
    )


def test_drop_mode(nan_data):
    G, Y, K = nan_data
    res = bl.bulkscan(Y, G, K, missing="drop")
    r = np.isfinite(Y).all(axis=1)
    ref = bl.bulkscan(Y[r], G[r], K[np.ix_(r, r)])
    np.testing.assert_array_equal(np.asarray(res.L), np.asarray(ref.L))


def test_scan_masked_perms_and_profile(nan_data):
    G, Y, K = nan_data
    r = _obs(Y, 0)
    res = bl.scan(Y[:, 0], G, K, permutation_test=True, nperms=24,
                  rndseed=7, missing="mask")
    ref = bl.scan(Y[r, 0], G[r], K[np.ix_(r, r)], permutation_test=True,
                  nperms=24, rndseed=7)
    np.testing.assert_array_equal(
        np.asarray(res.L_perms), np.asarray(ref.L_perms)
    )
    assert float(res.h2_null) == float(ref.h2_null)
    # alt assumption: per-marker h2 on the subset
    ra = bl.scan(Y[:, 0], G, K, assumption="alt", missing="mask")
    rr = bl.scan(Y[r, 0], G[r], K[np.ix_(r, r)], assumption="alt")
    np.testing.assert_allclose(
        np.asarray(ra.lod), np.asarray(rr.lod), atol=1e-12
    )


def test_bulkperm_masked_oracle_and_adj_pvals(nan_data):
    G, Y, K = nan_data
    res = bl.bulkscan_perms(Y, G, K, nperms=16, rndseed=9, missing="mask")
    for j in (1, 3, 7):
        r = _obs(Y, j)
        ref = bl.bulkscan_perms(Y[r][:, [j]], G[r], K[np.ix_(r, r)],
                                nperms=16, rndseed=9)
        # same shuffle indices (same n_obs + seed); group batching (m_g
        # traits per GEMM) only reorders f64 summation vs the m = 1 oracle
        np.testing.assert_allclose(
            np.asarray(res.maxlods[j]), np.asarray(ref.maxlods[0]),
            atol=1e-9,
        )
        np.testing.assert_allclose(
            np.asarray(res.log10_adj_pvals[j]),
            np.asarray(ref.log10_adj_pvals[0]), atol=1e-9,
        )
    assert res.nperms == 16 and res.original


def test_streamed_masked_memmap_out(nan_data, tmp_path):
    """Streamed masked scan writes through a memmap out in place; the
    lazy RowSubsetView never materializes the full row-subset panel."""
    G, Y, K = nan_data
    p, m = G.shape[1], Y.shape[1]
    out = np.memmap(tmp_path / "L.dat", dtype=np.float64, mode="w+",
                    shape=(p, m))
    res = bl.bulkscan_streamed(Y, G, K, marker_block=16, out=out,
                               missing="mask")
    ref = bl.bulkscan(Y, G, K, missing="mask")
    assert res.L is out
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref.L),
                               atol=1e-12)


def test_streamed_perms_masked_checkpoint(nan_data, tmp_path):
    """Masked streamed perm sweeps checkpoint per pattern group
    (pattern_NNN subdirectories) and resume to the identical result."""
    G, Y, K = nan_data
    kw = dict(nperms=12, rndseed=4, marker_block=16, missing="mask")
    base = bl.bulkscan_perms_streamed(Y, G, K, **kw)
    ck = tmp_path / "ck"
    a = bl.bulkscan_perms_streamed(Y, G, K, checkpoint=str(ck), **kw)
    np.testing.assert_array_equal(np.asarray(a.maxlods),
                                  np.asarray(base.maxlods))
    subdirs = sorted(d.name for d in ck.iterdir())
    assert subdirs and all(d.startswith("pattern_") for d in subdirs)
    # resume from the completed per-group checkpoints
    b = bl.bulkscan_perms_streamed(Y, G, K, checkpoint=str(ck), **kw)
    np.testing.assert_array_equal(np.asarray(b.maxlods),
                                  np.asarray(base.maxlods))


def test_loco_masked_oracle(nan_data):
    G, Y, K = nan_data
    chrom = np.repeat([1, 2], G.shape[1] // 2)
    res = bl.bulkscan_loco(Y, G, chrom, missing="mask")
    r = _obs(Y, 3)
    ref = bl.bulkscan_loco(Y[r][:, [3]], G[r], chrom)
    np.testing.assert_allclose(
        np.asarray(res.L[:, 3]), np.asarray(ref.L[:, 0]), atol=1e-12
    )
    for c in (1, 2):
        np.testing.assert_allclose(
            np.asarray(res.h2_null_by_chrom[c][3]),
            np.asarray(ref.h2_null_by_chrom[c][0]), atol=1e-12,
        )
    rs = bl.scan_loco(Y[:, 3], G, chrom, missing="mask")
    np.testing.assert_allclose(
        np.asarray(rs.lod), np.asarray(ref.L[:, 0]), atol=1e-12
    )


def test_sharded_masked_matches_unsharded(nan_data):
    from bulklmm_tpu.parallel import (
        bulkscan_perms_sharded, bulkscan_sharded, make_mesh,
    )

    G, Y, K = nan_data
    mesh = make_mesh(8)
    res = bulkscan_sharded(Y, G, K, mesh=mesh, missing="mask")
    ref = bl.bulkscan(Y, G, K, missing="mask")
    np.testing.assert_allclose(np.asarray(res.L), np.asarray(ref.L),
                               atol=1e-10)
    rp = bulkscan_perms_sharded(Y, G, K, mesh=mesh, nperms=12, rndseed=2,
                                missing="mask")
    refp = bl.bulkscan_perms(Y, G, K, nperms=12, rndseed=2, missing="mask")
    np.testing.assert_allclose(np.asarray(rp.maxlods),
                               np.asarray(refp.maxlods), atol=1e-10)


# ---------------------------------------------------------------------------
# ill-defined cases refuse with named traits
# ---------------------------------------------------------------------------


def test_degenerate_trait_refused(nan_data):
    """A trait with fewer than c + 2 observations cannot be tested."""
    G, Y, K = nan_data
    Yb = Y.copy()
    Yb[2:, 2] = np.nan  # trait 2: 2 observations left
    with pytest.raises(ValueError, match=r"trait\(s\) \[2\]"):
        bl.bulkscan(Yb, G, K, missing="mask")
    # drop mode: no fully-observed individuals at all
    Yall = Y.copy()
    Yall[0, 2] = np.nan
    Yall[np.arange(Y.shape[0]), np.arange(Y.shape[0]) % Y.shape[1]] = np.nan
    with pytest.raises(ValueError, match="drop"):
        bl.bulkscan(Yall, G, K, missing="drop")


def test_nan_covar_weights_refused(nan_data):
    G, Y, K = nan_data
    covar = np.ones((Y.shape[0], 1))
    covar[3, 0] = np.nan
    with pytest.raises(ValueError, match="covar"):
        bl.bulkscan(Y, G, K, covar, missing="mask")
    w = np.ones(Y.shape[0])
    w[4] = np.nan
    with pytest.raises(ValueError, match="weights"):
        bl.bulkscan(Y, G, K, weights=w, missing="mask")


def test_pattern_count_warning():
    rng = np.random.default_rng(5)
    n, p, m = 90, 12, 70
    G = rng.uniform(0, 1, (n, p))
    K = np.asarray(bl.calc_kinship(G))
    Y = rng.normal(size=(n, m))
    for j in range(m):  # every trait its own distinct pattern
        Y[j, j % m] = np.nan
    with pytest.warns(UserWarning, match="missingness patterns"):
        bl.bulkscan(Y, G, K, missing="mask")


def test_cli_missing_flag(tmp_path):
    """--missing mask end-to-end through the CLI (subprocess)."""
    import os
    import subprocess
    import sys

    rng = np.random.default_rng(8)
    n, p, m = 30, 16, 4
    G = rng.uniform(0, 1, (n, p))
    Y = rng.normal(size=(n, m))
    Y[2:5, 1] = np.nan
    np.savez(tmp_path / "g.npz", geno=G)
    np.savez(tmp_path / "y.npz", pheno=Y)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env_cmd = [sys.executable, "-m", "bulklmm_tpu", "bulkscan",
               "--geno", "g.npz", "--pheno", "y.npz", "-o", "out.npz"]
    r = subprocess.run(env_cmd, cwd=tmp_path, env=env,
                       capture_output=True, text=True)
    assert r.returncode != 0 and "missing" in (r.stderr + r.stdout)
    r = subprocess.run(env_cmd + ["--missing", "mask"], cwd=tmp_path,
                       env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-800:]
    L = np.load(tmp_path / "out.npz")["L"]
    obs = np.isfinite(Y[:, 1])
    ref = bl.bulkscan(Y[obs][:, [1]], G[obs],
                      np.asarray(bl.calc_kinship(G))[np.ix_(obs, obs)])
    np.testing.assert_allclose(L[:, 1], np.asarray(ref.L[:, 0]), atol=1e-6)


def test_cli_podscan_missing_drop(tmp_path):
    """podscan --missing drop: listwise deletion from the full trait
    matrix (identical rows on every process); --missing mask is refused
    with the recipe (pattern geometry does not compose with the pod's
    trait sharding)."""
    import os
    import subprocess
    import sys

    rng = np.random.default_rng(9)
    n, p, m = 30, 16, 4
    G = rng.uniform(0, 1, (n, p))
    Y = rng.normal(size=(n, m))
    Y[3:6, 2] = np.nan
    np.savez(tmp_path / "g.npz", geno=G)
    np.savez(tmp_path / "y.npz", pheno=Y)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    base = [sys.executable, "-m", "bulklmm_tpu", "podscan",
            "--geno", "g.npz", "--pheno", "y.npz", "-o", "pod.npz"]
    r = subprocess.run(base + ["--missing", "mask"], cwd=tmp_path, env=env,
                       capture_output=True, text=True)
    assert r.returncode != 0 and "drop" in (r.stderr + r.stdout)
    r = subprocess.run(base + ["--missing", "drop"], cwd=tmp_path, env=env,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-800:]
    shard = np.load(tmp_path / "lod_shard_00000.npz")
    rows = np.isfinite(Y).all(axis=1)
    ref = bl.bulkscan(Y[rows], G[rows],
                      np.asarray(bl.calc_kinship(G[rows])))
    # CLI default is BALANCED (f32 kernels) vs the in-process f64 ref
    np.testing.assert_allclose(shard["lod"], np.asarray(ref.L), atol=2e-5)


def test_masked_composes_with_h2_panel_flag_and_scan_profile(nan_data):
    """Round-5 feature compositions: missing='mask' x
    output_h2_panel=False (alt-grid), and a masked single-trait scan with
    profile_ll attached."""
    G, Y, K = nan_data
    res = bl.bulkscan(Y, G, K, method="alt-grid", missing="mask",
                      output_h2_panel=False)
    ref = bl.bulkscan(Y, G, K, method="alt-grid", missing="mask")
    assert res.h2_panel is None
    np.testing.assert_allclose(np.asarray(res.L), np.asarray(ref.L),
                               atol=1e-12)
    # profile_ll runs on the subset data (rows dropped before rotation)
    r = _obs(Y, 0)
    out, prof = bl.scan(Y[:, 0], G, K, missing="mask", profile_ll=True,
                        marker_id=3)
    out_ref, prof_ref = bl.scan(Y[r, 0], G[r], K[np.ix_(r, r)],
                                profile_ll=True, marker_id=3)
    np.testing.assert_allclose(np.asarray(prof[0]), np.asarray(prof_ref[0]),
                               atol=1e-10)


def test_masked_vector_trait_and_inf_values(nan_data):
    """1-D Y through bulkscan with missing='mask'; +/-inf counts as
    missing exactly like NaN (isfinite semantics)."""
    G, Y, K = nan_data
    y = Y[:, 3].copy()
    res = bl.bulkscan(y, G, K, missing="mask")
    r = np.isfinite(y)
    ref = bl.bulkscan(y[r], G[r], K[np.ix_(r, r)])
    np.testing.assert_allclose(np.asarray(res.L), np.asarray(ref.L),
                               atol=1e-12)
    y2 = Y[:, 6].copy()
    y2[4] = np.inf
    y2[9] = -np.inf
    res2 = bl.bulkscan(y2, G, K, missing="mask")
    r2 = np.isfinite(y2)
    ref2 = bl.bulkscan(y2[r2], G[r2], K[np.ix_(r2, r2)])
    np.testing.assert_allclose(np.asarray(res2.L), np.asarray(ref2.L),
                               atol=1e-12)


def test_missing_kwarg_validated_eagerly_on_complete_data(nan_data):
    """A typo'd missing= policy must fail even when the current inputs
    happen to be complete (code-review r5)."""
    G, Y, K = nan_data
    Yc = np.nan_to_num(Y, nan=0.0)
    chrom = np.repeat([1, 2], G.shape[1] // 2)
    for f in (
        lambda: bl.scan(Yc[:, 0], G, K, missing="maks"),
        lambda: bl.scan_perms_lite(Yc[:, 0], G, None, K, nperms=4,
                                   missing="maks"),
        lambda: bl.scan_loco(Yc[:, 0], G, chrom, missing="maks"),
        lambda: bl.bulkscan(Yc, G, K, missing="maks"),
    ):
        with pytest.raises(ValueError, match="must be one of"):
            f()


def test_cli_podscan_drop_with_kinship_file(tmp_path):
    """--missing drop + --kinship FILE: the full-cohort kinship is
    subset to the dropped-row geometry (code-review r5)."""
    import os
    import subprocess
    import sys

    rng = np.random.default_rng(10)
    n, p, m = 28, 14, 4
    G = rng.uniform(0, 1, (n, p))
    Y = rng.normal(size=(n, m))
    Y[2:4, 1] = np.nan
    K = np.asarray(bl.calc_kinship(G))
    np.savez(tmp_path / "g.npz", geno=G)
    np.savez(tmp_path / "y.npz", pheno=Y)
    np.savez(tmp_path / "K.npz", kinship=K)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "bulklmm_tpu", "podscan",
         "--geno", "g.npz", "--pheno", "y.npz", "--kinship", "K.npz",
         "--missing", "drop", "-o", "pod.npz"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr[-800:]
    shard = np.load(tmp_path / "lod_shard_00000.npz")
    rows = np.isfinite(Y).all(axis=1)
    ref = bl.bulkscan(Y[rows], G[rows], K[np.ix_(rows, rows)])
    np.testing.assert_allclose(shard["lod"], np.asarray(ref.L), atol=2e-5)


def test_streamed_masked_h5py_dataset(nan_data, tmp_path):
    """RowSubsetView over an h5py dataset (the lazy-container class the
    fingerprint and streaming docs promise): masked streamed scan equals
    the in-memory masked run without ever materializing the full panel."""
    h5py = pytest.importorskip("h5py")
    G, Y, K = nan_data
    f = tmp_path / "g.h5"
    with h5py.File(f, "w") as h:
        h.create_dataset("geno", data=G)
    ref = bl.bulkscan(Y, G, K, missing="mask")
    with h5py.File(f, "r") as h:
        res = bl.bulkscan_streamed(Y, h["geno"], K, marker_block=16,
                                   missing="mask")
    np.testing.assert_allclose(np.asarray(res.L), np.asarray(ref.L),
                               atol=1e-12)


def test_masked_streamed_and_loco_on_mesh(nan_data):
    """missing='mask' composes with mesh= on the streamed and LOCO
    engines (each pattern group runs its sharded/streamed engine on the
    row subset)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from bulklmm_tpu.parallel import make_mesh

    G, Y, K = nan_data
    mesh = make_mesh(8, marker_shards=2)
    ref = bl.bulkscan(Y, G, K, missing="mask")
    res = bl.bulkscan_streamed(Y, G, K, marker_block=16, mesh=mesh,
                               missing="mask")
    np.testing.assert_allclose(np.asarray(res.L), np.asarray(ref.L),
                               atol=1e-9)
    chrom = np.repeat([1, 2], G.shape[1] // 2)
    ref_l = bl.bulkscan_loco(Y, G, chrom, missing="mask")
    res_l = bl.bulkscan_loco(Y, G, chrom, mesh=mesh, missing="mask")
    np.testing.assert_allclose(np.asarray(res_l.L), np.asarray(ref_l.L),
                               atol=1e-9)
    resp = bl.bulkscan_perms_streamed(Y, G, K, nperms=12, rndseed=2,
                                      marker_block=16, mesh=mesh,
                                      missing="mask")
    refp = bl.bulkscan_perms(Y, G, K, nperms=12, rndseed=2,
                             missing="mask")
    np.testing.assert_allclose(np.asarray(resp.maxlods),
                               np.asarray(refp.maxlods), atol=1e-9)
