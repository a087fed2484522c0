"""Bulk permutation engine (models/bulkperm.py): per-trait genome-wide
permutation null maxima + thresholds for all traits at once.

Strategy mirrors the reference's fast-path == exact-path consistency tests
(test/bulkscan_test.jl:86-107 h2-injection trick): with each trait's exact
fitted h2 injected into the grid, the bulk engine's per-trait rows must
reproduce the single-trait permutation path (``scan(...,
permutation_test=True)`` + max over markers) — same shuffle indices by
construction.
"""

import numpy as np
import pytest

import bulklmm_tpu as bl


@pytest.fixture(scope="module")
def perm_data():
    rng = np.random.default_rng(11)
    n, p, m = 52, 96, 4
    G = rng.choice([0.0, 0.5, 1.0], size=(n, p))
    K = np.asarray(bl.calc_kinship(G))
    lam, U = np.linalg.eigh(K)
    Y = np.stack(
        [
            U @ (np.sqrt(np.abs(lam)) * rng.normal(size=n)) * s
            + rng.normal(size=n)
            for s in [0.3, 1.0, 0.0, 2.0]
        ],
        axis=1,
    )
    Y[:, 1] += G[:, 7] * 2.0
    return G, Y, K


@pytest.fixture(scope="module")
def singles(perm_data):
    """Single-trait permutation references: fitted h2 + (m, 1+nperms)
    genome-wide maxima (column 0 observed)."""
    G, Y, K = perm_data
    h2s, maxima = [], []
    for j in range(Y.shape[1]):
        r = bl.scan(Y[:, j], G, K, permutation_test=True, nperms=24, rndseed=7)
        h2s.append(float(r.h2_null))
        full = np.concatenate(
            [np.asarray(r.lod)[:, None], np.asarray(r.L_perms)], axis=1
        )
        maxima.append(full.max(axis=0))
    return np.asarray(h2s), np.stack(maxima)


def test_bulkscan_perms_matches_single_trait_with_injected_h2(perm_data, singles):
    G, Y, K = perm_data
    h2s, ref = singles
    res = bl.bulkscan_perms(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s
    )
    assert np.max(np.abs(np.asarray(res.h2_null_list) - h2s)) < 1e-12
    assert res.maxlods.shape == ref.shape
    assert np.max(np.abs(res.maxlods - ref)) < 1e-4
    # observed column == genome-wide max of the bulk scan itself
    L = np.asarray(bl.bulkscan(Y, G, K, method="null-grid", h2_grid=h2s).L)
    assert np.max(np.abs(res.lod_max - L.max(axis=0))) < 1e-4


def test_bulkscan_perms_chunking_invariance(perm_data, singles):
    G, Y, K = perm_data
    h2s, _ = singles
    a = bl.bulkscan_perms(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s
    )
    b = bl.bulkscan_perms(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s,
        trait_chunk=3, perm_chunk=7,
    )
    # different chunk shapes reassociate the XLA reductions -> ulp-level
    np.testing.assert_allclose(
        np.asarray(a.maxlods), np.asarray(b.maxlods), atol=1e-12
    )


def test_bulkscan_perms_pallas_interpret_matches_xla(perm_data, singles):
    G, Y, K = perm_data
    h2s, _ = singles
    a = bl.bulkscan_perms(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s
    )
    b = bl.bulkscan_perms(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s,
        engine="pallas", interpret=True, trait_chunk=3,  # exercises padding
    )
    assert np.max(np.abs(a.maxlods - b.maxlods)) < 1e-5
    # tile_p < p forces multiple marker tiles: exercises the in-block
    # running-max loop over marker tiles
    c = bl.bulkscan_perms(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s,
        engine="pallas", interpret=True, tile_p=32,
    )
    assert np.max(np.abs(a.maxlods - c.maxlods)) < 1e-5


def test_bulkscan_perms_pallas_throughput_tier(perm_data, singles):
    """THROUGHPUT reaches the fused kernel as the three-pass bf16 dot
    algorithm (pallas/altgrid_fused.py::kernel_dot_precision):
    screening-tier accuracy vs the exact path."""
    from bulklmm_tpu.utils.config import THROUGHPUT

    G, Y, K = perm_data
    h2s, _ = singles
    a = bl.bulkscan_perms(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s
    )
    t = bl.bulkscan_perms(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s,
        engine="pallas", interpret=True, precision=THROUGHPUT,
    )
    err = np.max(np.abs(np.asarray(a.maxlods) - np.asarray(t.maxlods)))
    assert np.all(np.isfinite(np.asarray(t.maxlods)))
    assert err < 2e-2  # screening tier (bf16x3), not the 1e-5 parity bar
    assert err > 0.0  # and it genuinely took the 3-pass branch


def test_bulkscan_perms_deterministic_and_seed_sensitive(perm_data):
    G, Y, K = perm_data
    a = bl.bulkscan_perms(Y, G, K, nperms=16, rndseed=3)
    b = bl.bulkscan_perms(Y, G, K, nperms=16, rndseed=3)
    c = bl.bulkscan_perms(Y, G, K, nperms=16, rndseed=4)
    np.testing.assert_array_equal(a.maxlods, b.maxlods)
    assert np.any(a.maxlods[:, 1:] != c.maxlods[:, 1:])
    # observed column does not depend on the seed
    np.testing.assert_allclose(a.maxlods[:, 0], c.maxlods[:, 0], atol=1e-6)


def test_bulkscan_perms_null_exact_matches_scan_h2(perm_data):
    G, Y, K = perm_data
    res = bl.bulkscan_perms(Y, G, K, nperms=8, rndseed=1, method="null-exact")
    for j in range(Y.shape[1]):
        r = bl.scan(Y[:, j], G, K)
        assert abs(float(res.h2_null_list[j]) - float(r.h2_null)) < 1e-5, j
        assert abs(float(res.sigma2_e_list[j]) - float(r.sigma2_e)) < 1e-5, j


def test_get_thresholds_bulk_rows_match_single_trait(perm_data, singles):
    G, Y, K = perm_data
    h2s, _ = singles
    res = bl.bulkscan_perms(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s
    )
    thr = bl.get_thresholds_bulk(res.perm_maxima, [0.10, 0.05])
    assert thr.thrs.shape == (2, Y.shape[1])
    for j in range(Y.shape[1]):
        r = bl.scan(Y[:, j], G, K, permutation_test=True, nperms=24, rndseed=7)
        t = bl.get_thresholds(np.asarray(r.L_perms), [0.10, 0.05])
        np.testing.assert_allclose(thr.thrs[:, j], t.thrs, atol=2e-4)


def test_bulkscan_perms_adjusted_pvals(perm_data):
    G, Y, K = perm_data
    res = bl.bulkscan_perms(Y, G, K, nperms=40, rndseed=2)
    assert res.log10_adj_pvals.shape == (Y.shape[1],)
    # bounded by the permutation resolution
    assert np.all(res.log10_adj_pvals <= np.log10(41.0) + 1e-12)
    assert np.all(res.log10_adj_pvals >= -1e-12)
    # the planted-signal trait is the most genome-wide significant
    assert np.argmax(res.log10_adj_pvals) == 1


def test_bulkscan_perms_with_covariates_and_weights(perm_data):
    G, Y, K = perm_data
    rng = np.random.default_rng(5)
    covar = rng.normal(size=(Y.shape[0], 2))
    w = rng.uniform(0.5, 2.0, size=Y.shape[0])
    res = bl.bulkscan_perms(
        Y, G, K, covar, weights=w, nperms=12, rndseed=9, method="null-grid"
    )
    assert np.all(np.isfinite(res.maxlods))
    # single-trait consistency under covariates+weights via h2 injection
    j = 1
    r = bl.scan(
        Y[:, j], G, K, covar, weights=w, permutation_test=True,
        nperms=12, rndseed=9,
    )
    res_j = bl.bulkscan_perms(
        Y, G, K, covar, weights=w, nperms=12, rndseed=9,
        method="null-grid", h2_grid=np.array([float(r.h2_null)]),
    )
    full = np.concatenate(
        [np.asarray(r.lod)[:, None], np.asarray(r.L_perms)], axis=1
    )
    assert np.max(np.abs(res_j.maxlods[j] - full.max(axis=0))) < 1e-4


def test_bulkscan_perms_validation(perm_data):
    G, Y, K = perm_data
    with pytest.raises(ValueError, match="null-grid"):
        bl.bulkscan_perms(Y, G, K, method="alt-grid")
    with pytest.raises(ValueError, match="engine"):
        bl.bulkscan_perms(Y, G, K, engine="banana")
    lr = bl.LowRankKinship(
        U=np.linalg.eigh(K)[1][:, -4:], lam=np.linalg.eigh(K)[0][-4:]
    )
    # rank-k runs through the Woodbury whitening engine on both the single-
    # device and sharded entry points; only the fused Pallas kernel (rotated
    # basis) is incompatible with it
    with pytest.raises(ValueError, match="pallas"):
        bl.parallel.bulkscan_perms_sharded(Y, G, lr, nperms=4, engine="pallas")


def test_bulkscan_perms_sharded_matches_unsharded(perm_data, singles):
    """8-device virtual mesh: traits axis, then a (4 x 2) mesh where the
    permutation columns shard the markers axis. Collective-free by design —
    every device owns an independent output tile."""
    G, Y, K = perm_data
    h2s, _ = singles
    ref = bl.bulkscan_perms(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s
    )
    for kw in ({}, {"marker_shards": 2}):
        mesh = bl.parallel.make_mesh(**kw)
        res = bl.parallel.bulkscan_perms_sharded(
            Y, G, K, mesh=mesh, nperms=24, rndseed=7,
            method="null-grid", h2_grid=h2s,
        )
        np.testing.assert_allclose(
            np.asarray(res.maxlods), np.asarray(ref.maxlods), atol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(res.h2_null_list), np.asarray(ref.h2_null_list),
            atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(res.log10_adj_pvals),
            np.asarray(ref.log10_adj_pvals), atol=1e-12,
        )


def test_bulkscan_perms_sharded_pallas_interpret(perm_data, singles):
    """The fused kernel runs per device under shard_map (interpret mode on
    the CPU mesh)."""
    G, Y, K = perm_data
    h2s, _ = singles
    ref = bl.bulkscan_perms(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s
    )
    mesh = bl.parallel.make_mesh(4)
    res = bl.parallel.bulkscan_perms_sharded(
        Y, G, K, mesh=mesh, nperms=24, rndseed=7,
        method="null-grid", h2_grid=h2s, engine="pallas", interpret=True,
    )
    assert np.max(np.abs(np.asarray(res.maxlods) - np.asarray(ref.maxlods))) < 1e-5


def test_bulkscan_perms_streamed_matches_in_memory(perm_data, singles):
    G, Y, K = perm_data
    h2s, _ = singles
    ref = bl.bulkscan_perms(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s
    )
    # 96 markers in 3 blocks of 40 (last padded) through the same chunk core
    res = bl.bulkscan_perms_streamed(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s,
        marker_block=40,
    )
    np.testing.assert_allclose(
        np.asarray(res.maxlods), np.asarray(ref.maxlods), atol=1e-12
    )
    res_p = bl.bulkscan_perms_streamed(
        Y, G, K, nperms=24, rndseed=7, method="null-grid", h2_grid=h2s,
        marker_block=40, engine="pallas", interpret=True,
    )
    assert np.max(np.abs(np.asarray(res_p.maxlods) - np.asarray(ref.maxlods))) < 1e-5


def test_bulkscan_perms_loco_stitches_per_chromosome_maxima(perm_data):
    G, Y, K = perm_data
    p = G.shape[1]
    chrom = np.array(["1"] * (p // 2) + ["2"] * (p - p // 2))
    res = bl.bulkscan_perms_loco(Y, G, chrom, nperms=16, rndseed=5)
    # manual composition: chromosome i scans against the leave-out kinship
    # with seed 5 + i; stitched maxima = elementwise max
    expected = None
    for i, c in enumerate(["1", "2"]):
        mask = chrom == c
        Kc = np.asarray(bl.calc_kinship(G[:, ~mask]))
        r = bl.bulkscan_perms(Y, G[:, mask], Kc, nperms=16, rndseed=5 + i)
        np.testing.assert_allclose(
            np.asarray(res.h2_null_by_chrom[c]), np.asarray(r.h2_null_list),
            atol=1e-12,
        )
        e = np.asarray(r.maxlods)
        expected = e if expected is None else np.maximum(expected, e)
    np.testing.assert_allclose(np.asarray(res.maxlods), expected, atol=1e-12)
    # adjusted p-values recomputed on the stitched maxima
    assert res.log10_adj_pvals.shape == (Y.shape[1],)


@pytest.fixture(scope="module")
def lowrank_data():
    """Exactly-rank-k kinship: the rank-k Woodbury likelihood is exact, so
    the low-rank engine must agree with full-rank wherever the two compute
    basis-invariant quantities."""
    rng = np.random.default_rng(23)
    n, p, m, k = 30, 48, 4, 6
    A = rng.normal(size=(n, k))
    K = A @ A.T / k
    K = K / np.mean(np.diag(K))
    G = rng.uniform(0, 1, (n, p))
    L = np.linalg.cholesky(K + 1e-9 * np.eye(n))
    Y = 0.7 * (L @ rng.normal(size=(n, m))) + 0.5 * rng.normal(size=(n, m))
    return G, Y, K, k


def test_bulkscan_perms_lowrank_matches_full_rank_invariants(lowrank_data):
    """h2 / sigma2 fits and the OBSERVED column are whitening-basis
    invariant -> rank-k == full-rank on an exactly-rank-k kinship. (The
    permuted columns are different-but-equally-valid null draws: full-rank
    shuffles rotated coordinates, rank-k shuffles standard coordinates.)"""
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact

    G, Y, K, k = lowrank_data
    lr = kinship_lowrank_exact(K, k)
    res = bl.bulkscan_perms(Y, G, lr, nperms=16, rndseed=3)
    full = bl.bulkscan_perms(Y, G, K, nperms=16, rndseed=3)
    np.testing.assert_allclose(
        np.asarray(res.h2_null_list), np.asarray(full.h2_null_list), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(res.sigma2_e_list), np.asarray(full.sigma2_e_list),
        atol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(res.maxlods[:, 0]), np.asarray(full.maxlods[:, 0]),
        atol=1e-9,
    )
    assert res.log10_adj_pvals.shape == (Y.shape[1],)
    assert np.isfinite(np.asarray(res.maxlods)).all()


def test_bulkscan_perms_lowrank_numpy_oracle(lowrank_data):
    """Every (trait, permutation) entry against a dense numpy oracle that
    whitens explicitly with A_j = I + U (sqrt(w_j) - 1) U^T and shuffles
    the whitened residual's standard coordinates with the SAME indices."""
    from bulklmm_tpu.ops.bulkperm import permutation_indices
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact

    G, Y, K, k = lowrank_data
    n, m = Y.shape
    lr = kinship_lowrank_exact(K, k)
    nperms = 12
    res = bl.bulkscan_perms(Y, G, lr, nperms=nperms, rndseed=5)

    U = np.asarray(lr.U, dtype=np.float64)
    lam = np.asarray(lr.lam, dtype=np.float64)
    idx = np.asarray(permutation_indices(n, nperms, 5, original=True))
    C = np.ones((n, 1))
    expected = np.empty((m, nperms + 1))
    for j in range(m):
        h2 = float(res.h2_null_list[j])
        w = 1.0 / (h2 / (1.0 - h2) * lam + 1.0)
        A = np.eye(n) + U @ np.diag(np.sqrt(w) - 1.0) @ U.T
        Cw, Xw, yw = A @ C, A @ G, A @ Y[:, j]
        bhat = np.linalg.lstsq(Cw, yw, rcond=None)[0]
        r0 = yw - Cw @ bhat
        Xr = Xw - Cw @ np.linalg.lstsq(Cw, Xw, rcond=None)[0]
        for kk in range(nperms + 1):
            s = r0[idx[kk]]
            r = (Xr.T @ s) / (
                np.linalg.norm(Xr, axis=0) * np.linalg.norm(s)
            )
            expected[j, kk] = -(n / 2.0) * np.log10(1.0 - np.max(r * r))
    np.testing.assert_allclose(np.asarray(res.maxlods), expected, atol=1e-8)


def test_bulkscan_perms_lowrank_chunking_and_validation(lowrank_data):
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact

    G, Y, K, k = lowrank_data
    lr = kinship_lowrank_exact(K, k)
    ref = bl.bulkscan_perms(Y, G, lr, nperms=16, rndseed=3, method="null-exact")
    chunked = bl.bulkscan_perms(
        Y, G, lr, nperms=16, rndseed=3, method="null-exact",
        trait_chunk=1, perm_chunk=5,
    )
    np.testing.assert_allclose(
        np.asarray(chunked.maxlods), np.asarray(ref.maxlods), atol=1e-12
    )
    with pytest.raises(ValueError, match="pallas"):
        bl.bulkscan_perms(Y, G, lr, nperms=4, engine="pallas")
    with pytest.raises(ValueError, match="rank-k"):
        bl.bulkscan_perms(Y, G, lr, nperms=4, weights=np.ones(Y.shape[0]))


def test_bulkscan_perms_loco_lowrank(perm_data):
    """LOCO x rank-k composition: per-chromosome leave-out kinships as
    rank-k factorizations, permutation-tested on the Woodbury whitening
    engine, maxima stitched across chromosomes."""
    G, Y, K = perm_data
    p = G.shape[1]
    chrom = np.array(["1"] * (p // 2) + ["2"] * (p - p // 2))
    res = bl.bulkscan_perms_loco(
        Y, G, chrom, nperms=12, rndseed=5, lowrank_k=24
    )
    m = Y.shape[1]
    assert res.maxlods.shape == (m, 13)
    assert np.isfinite(np.asarray(res.maxlods)).all()
    assert set(res.h2_null_by_chrom) == {"1", "2"}
    assert res.log10_adj_pvals.shape == (m,)
    # rank high enough to capture the leave-out spectra (n=52, k=24
    # against ~48-marker chromosomes): observed column near the dense
    # LOCO engine's
    dense = bl.bulkscan_perms_loco(Y, G, chrom, nperms=12, rndseed=5)
    # rank truncation can flip a trait's grid-h2 bin, shifting its observed
    # max LOD slightly — approximation-level agreement only
    np.testing.assert_allclose(
        np.asarray(res.maxlods[:, 0]), np.asarray(dense.maxlods[:, 0]),
        atol=0.25,
    )


def test_perm_engine_caps_and_fallback():
    """Engine + chunk-cap policy: the kernel on a GPU at f32 GEMM dtype,
    XLA elsewhere; the kernel's cap counts no markers (it never builds a
    (Kc, p) numerator); the rank-k cap scales down with n and p but never
    below 64."""
    from types import SimpleNamespace

    from bulklmm_tpu.models.bulkperm import _resolve_perm_engine
    from bulklmm_tpu.ops.bulkperm import lowrank_perm_chunk_cap, perm_chunk_cap
    from bulklmm_tpu.utils.config import FAST32

    gpu = SimpleNamespace(platform="gpu")
    assert _resolve_perm_engine("auto", 79, precision=FAST32, device=gpu) \
        == ("pallas", None)
    assert _resolve_perm_engine("xla", 79, precision=FAST32, device=gpu) \
        == ("xla", None)
    eng, cap = _resolve_perm_engine(
        "auto", 79, precision=FAST32, device=gpu, p=7321
    )
    assert eng == "pallas" and cap == perm_chunk_cap(79, 0, trait_chunk=1024)
    assert cap >= 1001  # BXD's 1,000 permutations run as one chunk
    # biobank n: the kernel's (mb, n, Kc) operand bounds the chunk
    assert perm_chunk_cap(5000, 0, trait_chunk=1024) < 2048

    assert lowrank_perm_chunk_cap(100_000, 30_208) >= 64
    # at n = 1e5 the cap keeps the (Kc, n, 16) gather ~<= 1 GB
    assert lowrank_perm_chunk_cap(100_000, 30_208) * 100_000 * 16 * 4 \
        <= 1.1 * 2**30
    assert lowrank_perm_chunk_cap(500, 500) >= 2048


def test_bulkscan_perms_streamed_lowrank_matches_in_memory(lowrank_data):
    """Marker-streamed rank-k perms == in-memory rank-k perms: same chunk
    core, maxima folded over host marker blocks via elementwise max."""
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact

    G, Y, K, k = lowrank_data
    lr = kinship_lowrank_exact(K, k)
    ref = bl.bulkscan_perms(Y, G, lr, nperms=16, rndseed=3)
    # 48 markers in 3 blocks of 20 (last zero-padded)
    res = bl.bulkscan_perms_streamed(
        Y, G, lr, nperms=16, rndseed=3, marker_block=20
    )
    np.testing.assert_allclose(
        np.asarray(res.maxlods), np.asarray(ref.maxlods), atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(res.h2_null_list), np.asarray(ref.h2_null_list),
        atol=1e-12,
    )
    with pytest.raises(ValueError, match="pallas"):
        bl.bulkscan_perms_streamed(Y, G, lr, nperms=4, engine="pallas")


def test_bulkscan_perms_loco_share_shuffles(perm_data):
    """share_shuffles=True uses the SAME shuffle indices on every
    chromosome (manual composition check); default uses rndseed + i."""
    G, Y, K = perm_data
    p = G.shape[1]
    chrom = np.array(["1"] * (p // 2) + ["2"] * (p - p // 2))
    shared = bl.bulkscan_perms_loco(
        Y, G, chrom, nperms=12, rndseed=5, share_shuffles=True
    )
    indep = bl.bulkscan_perms_loco(Y, G, chrom, nperms=12, rndseed=5)
    # observed column identical; permuted columns differ
    np.testing.assert_allclose(
        np.asarray(shared.maxlods[:, 0]), np.asarray(indep.maxlods[:, 0]),
        atol=1e-12,
    )
    assert np.any(
        np.asarray(shared.maxlods[:, 1:]) != np.asarray(indep.maxlods[:, 1:])
    )
    # manual composition: both chromosomes at the SAME seed
    expected = None
    for c in ["1", "2"]:
        mask = chrom == c
        Kc = np.asarray(bl.calc_kinship(G[:, ~mask]))
        e = np.asarray(bl.bulkscan_perms(
            Y, G[:, mask], Kc, nperms=12, rndseed=5
        ).maxlods)
        expected = e if expected is None else np.maximum(expected, e)
    np.testing.assert_allclose(np.asarray(shared.maxlods), expected, atol=1e-12)


def test_bulkscan_perms_streamed_from_memmap(perm_data, tmp_path):
    """The streamed perm engine reads marker blocks from an np.memmap
    (the p-beyond-RAM input path) identically to an in-memory panel."""
    G, Y, K = perm_data
    mm = np.memmap(tmp_path / "geno.dat", dtype=np.float64, mode="w+",
                   shape=G.shape)
    mm[:] = G
    mm.flush()
    ref = bl.bulkscan_perms(Y, G, K, nperms=12, rndseed=3)
    res = bl.bulkscan_perms_streamed(
        Y, mm, K, nperms=12, rndseed=3, marker_block=40
    )
    np.testing.assert_allclose(
        np.asarray(res.maxlods), np.asarray(ref.maxlods), atol=1e-12
    )


def test_bulkscan_perms_nperms_zero_and_engine_guards(perm_data):
    G, Y, K = perm_data
    # nperms=0 with original=True: observed column only
    res = bl.bulkscan_perms(Y, G, K, nperms=0)
    assert res.maxlods.shape == (Y.shape[1], 1)
    assert res.log10_adj_pvals is None
    # nperms=0 without the observed column is meaningless -> clear error
    with pytest.raises(ValueError, match="positive integer"):
        bl.bulkscan_perms(Y, G, K, nperms=0, original=False)
    # explicit pallas off the GPU without interpret -> clear error (not a
    # Triton lowering failure)
    from bulklmm_tpu.utils.config import FAST32

    with pytest.raises(ValueError, match="GPU backend|interpret"):
        bl.bulkscan_perms(Y, G, K, nperms=4, engine="pallas", precision=FAST32)
    # explicit pallas under an f64 GEMM config -> silent-downgrade guard
    with pytest.raises(ValueError, match="f32|float32"):
        bl.bulkscan_perms(Y, G, K, nperms=4, engine="pallas")


def test_bulkscan_perms_sharded_perm_chunking_invariance(perm_data, singles):
    """The sharded engine chunks the permutation axis like the other entry
    points (bounded per-device width); chunked == unchunked."""
    G, Y, K = perm_data
    h2s, _ = singles
    mesh = bl.parallel.make_mesh(marker_shards=2)
    a = bl.parallel.bulkscan_perms_sharded(
        Y, G, K, mesh=mesh, nperms=24, rndseed=7,
        method="null-grid", h2_grid=h2s,
    )
    b = bl.parallel.bulkscan_perms_sharded(
        Y, G, K, mesh=mesh, nperms=24, rndseed=7,
        method="null-grid", h2_grid=h2s, perm_chunk=5,
    )
    np.testing.assert_allclose(
        np.asarray(a.maxlods), np.asarray(b.maxlods), atol=1e-12
    )


@pytest.mark.parametrize("platform,engine,want", [
    ("gpu", "auto", "pallas"),
    ("cpu", "auto", "xla"),
    ("gpu", "xla", "xla"),
    ("gpu", "pallas", "pallas"),
])
def test_engine_choice_per_platform(platform, engine, want):
    """One function decides where the fused kernels run: "auto" takes them
    on a CUDA GPU only, and explicit "pallas" off the GPU raises unless
    interpret=True (never chosen by the library)."""
    from types import SimpleNamespace

    from bulklmm_tpu.pallas import kernels_apply, resolve_engine
    from bulklmm_tpu.utils.config import BALANCED

    dev = SimpleNamespace(platform=platform)
    assert kernels_apply(dev) == (platform == "gpu")
    assert resolve_engine(engine, BALANCED, device=dev) == want
    cpu = SimpleNamespace(platform="cpu")
    assert resolve_engine("pallas", BALANCED, device=cpu,
                          interpret=True) == "pallas"
    with pytest.raises(ValueError, match="GPU backend"):
        resolve_engine("pallas", BALANCED, device=cpu)


def test_engine_choice_needs_f32_gemms_and_small_grid():
    """Auto keeps XLA for an f64 GEMM config (the f32 kernel would
    downgrade it; explicit "pallas" raises) and for an alt-grid h2 grid
    longer than the int8 argmin panel holds."""
    from types import SimpleNamespace

    from bulklmm_tpu.models.bulkscan import _altgrid_engine
    from bulklmm_tpu.pallas import resolve_engine
    from bulklmm_tpu.utils.config import BALANCED, EXACT64

    gpu = SimpleNamespace(platform="gpu")
    assert resolve_engine("auto", EXACT64, device=gpu) == "xla"
    with pytest.raises(ValueError, match="f32|float32"):
        resolve_engine("pallas", EXACT64, device=gpu)
    assert _altgrid_engine("auto", BALANCED, 10, device=gpu) == "pallas"
    assert _altgrid_engine("auto", BALANCED, 128, device=gpu) == "xla"


def test_perm_chunk_cap_policy():
    """The full-rank engines get a memory-aware perm-chunk cap: ~3 live
    copies of the (mb, Kc, p) numerator at the wider itemsize."""
    import jax.numpy as jnp

    from types import SimpleNamespace

    from bulklmm_tpu.models.bulkperm import _resolve_perm_engine
    from bulklmm_tpu.ops.bulkperm import perm_chunk_cap
    from bulklmm_tpu.utils.config import EXACT64, FAST32, PrecisionConfig

    # f64 at BXD scale must chunk well below the 2048 default
    cap64 = perm_chunk_cap(79, 7321, trait_chunk=16, itemsize=8)
    assert 64 <= cap64 < 1001
    # f32 at BXD scale must NOT force extra chunks at nperms=1000
    cap32 = perm_chunk_cap(79, 7321, trait_chunk=16, itemsize=4)
    assert cap32 >= 1001
    # tiny test shapes are never constrained (CPU suite unaffected)
    assert perm_chunk_cap(30, 50, trait_chunk=16, itemsize=8) > 10_000

    # engine resolution threads the cap through for every XLA engine
    gpu = SimpleNamespace(platform="gpu")
    eng, cap = _resolve_perm_engine(
        "auto", 79, precision=EXACT64, device=gpu, p=7321, trait_block=16,
    )
    assert eng == "xla" and cap == cap64
    eng, cap = _resolve_perm_engine(
        "xla", 79, precision=FAST32, p=7321, trait_block=16,
    )
    assert eng == "xla" and cap == cap32
    # MIXED (f32 GEMMs, f64 kernel) is sized at the wider itemsize
    mixed = PrecisionConfig(solve_dtype=jnp.float64, gemm_dtype=jnp.float32)
    _, cap = _resolve_perm_engine(
        "xla", 79, precision=mixed, p=7321, trait_block=16,
    )
    assert cap == cap64


def test_bulkperm_checkpoint_resume(perm_data, tmp_path):
    """Resumable sweeps: per-trait-chunk maxima persist;
    a rerun loads completed chunks (verified via file mtimes) and computes
    only the missing ones, matching an uninterrupted run exactly."""
    import os

    G, Y, K = perm_data
    ref = bl.bulkscan_perms(Y, G, K, nperms=49, rndseed=9, trait_chunk=3)
    ck = tmp_path / "ck"
    a = bl.bulkscan_perms(
        Y, G, K, nperms=49, rndseed=9, trait_chunk=3, checkpoint=str(ck)
    )
    assert np.max(np.abs(np.asarray(a.maxlods) - np.asarray(ref.maxlods))) < 1e-12
    chunks = sorted(ck.glob("maxlods_*.npy"))
    assert len(chunks) == -(-Y.shape[1] // 3)
    # simulate preemption: drop the last two chunks, keep the rest
    kept = {c: os.stat(c).st_mtime_ns for c in chunks[:-2]}
    for c in chunks[-2:]:
        c.unlink()
    b = bl.bulkscan_perms(
        Y, G, K, nperms=49, rndseed=9, trait_chunk=3, checkpoint=str(ck)
    )
    assert np.max(np.abs(np.asarray(b.maxlods) - np.asarray(ref.maxlods))) < 1e-12
    for c, mt in kept.items():
        assert os.stat(c).st_mtime_ns == mt, "completed chunk was recomputed"
    # config mismatch is refused, not silently mixed
    with pytest.raises(ValueError, match="different"):
        bl.bulkscan_perms(
            Y, G, K, nperms=50, rndseed=9, trait_chunk=3, checkpoint=str(ck)
        )


def test_bulkperm_checkpoint_refuses_edited_inputs(perm_data, tmp_path):
    """Same shapes + same seed but EDITED input contents (e.g. a corrected
    phenotype CSV between runs) must refuse to resume — the fingerprint
    carries a content digest of Y/G/covar/K, not just shapes and config
    (ADVICE r3, medium)."""
    G, Y, K = perm_data
    ck = tmp_path / "ck"
    bl.bulkscan_perms(Y, G, K, nperms=9, rndseed=9, trait_chunk=3,
                      checkpoint=str(ck))
    Y2 = np.asarray(Y).copy()
    Y2[3, 1] += 0.25  # one corrected phenotype entry, same shape/dtype
    with pytest.raises(ValueError, match="different"):
        bl.bulkscan_perms(Y2, G, K, nperms=9, rndseed=9, trait_chunk=3,
                          checkpoint=str(ck))
    # a changed genotype panel is refused too
    G2 = np.asarray(G).copy()
    G2[0, 0] += 0.5
    with pytest.raises(ValueError, match="different"):
        bl.bulkscan_perms(Y, G2, K, nperms=9, rndseed=9, trait_chunk=3,
                          checkpoint=str(ck))
    # unchanged inputs still resume cleanly
    bl.bulkscan_perms(Y, G, K, nperms=9, rndseed=9, trait_chunk=3,
                      checkpoint=str(ck))


def test_data_fingerprint_overcap_catches_single_cell_edits():
    """Arrays over the hash cap use row-sampling PLUS a full-pass per-row
    weighted checksum: a single edited cell in an UNSAMPLED row — the
    motivating corrected-phenotype case — and a within-row swap must both
    change the digest (code-review r4)."""
    from bulklmm_tpu.models.bulkperm import _data_fingerprint

    rng = np.random.default_rng(0)
    a = rng.normal(size=(5000, 40))  # 1.6 MB
    cap = 1 << 14  # 16 KB: forces the over-cap path (~1024-row sample)
    base = _data_fingerprint(a, max_bytes=cap)
    assert _data_fingerprint(a.copy(), max_bytes=cap) == base

    # rows sampled by linspace(0, 4999, 1024) — row 2 is NOT in the sample
    edited = a.copy()
    edited[2, 17] += 1e-6
    assert _data_fingerprint(edited, max_bytes=cap) != base

    swapped = a.copy()
    swapped[2, 5], swapped[2, 6] = a[2, 6], a[2, 5]  # row sum preserved
    assert _data_fingerprint(swapped, max_bytes=cap) != base


def test_streamed_perm_checkpoint_every(perm_data, tmp_path):
    """checkpoint_every=N saves the streamed accumulator every N marker
    blocks (plus the final one) instead of after every block (ADVICE r3):
    result identical, fewer sync points."""
    G, Y, K = perm_data
    ref = bl.bulkscan_perms(Y, G, K, nperms=19, rndseed=5)
    ck = tmp_path / "ck"
    res = bl.bulkscan_perms_streamed(
        np.asarray(Y), np.asarray(G), K, nperms=19, rndseed=5,
        marker_block=7, checkpoint=str(ck), checkpoint_every=3,
    )
    assert np.max(np.abs(np.asarray(res.maxlods) - np.asarray(ref.maxlods))) < 1e-9
    # final state present and complete despite the sparser cadence
    import numpy as _np

    st = _np.load(ck / "acc_state.npz")
    nblocks = -(-G.shape[1] // 7)
    assert int(st["blocks_done"]) == nblocks
    with pytest.raises(ValueError):
        bl.bulkscan_perms_streamed(
            np.asarray(Y), np.asarray(G), K, nperms=19, rndseed=5,
            marker_block=7, checkpoint=str(ck), checkpoint_every=0,
        )


def test_bulkperm_checkpoint_kill_and_resume(perm_data, tmp_path):
    """True kill-and-resume: a subprocess sweep is SIGKILLed after its first
    chunk lands on disk; the resumed run equals an uninterrupted one."""
    import os
    import signal
    import subprocess
    import sys
    import time as _t

    G, Y, K = perm_data
    data = tmp_path / "data.npz"
    np.savez(data, Y=Y, G=G, K=K)
    ck = tmp_path / "ck"
    script = (
        "import numpy as np, jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "import bulklmm_tpu as bl\n"
        f"z = np.load(r'{data}')\n"
        f"bl.bulkscan_perms(z['Y'], z['G'], z['K'], nperms=199, rndseed=4,\n"
        f"                  trait_chunk=2, checkpoint=r'{ck}')\n"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", script], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    deadline = _t.time() + 240
    try:
        # kill the exact child PID the moment its first chunk publishes
        while _t.time() < deadline:
            if len(list(ck.glob("maxlods_*.npy"))) >= 1:
                break
            if proc.poll() is not None:
                break
            _t.sleep(0.05)
        if proc.poll() is None:
            os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait(timeout=60)
    n_before = len(list(ck.glob("maxlods_*.npy")))
    assert n_before >= 1, "sweep finished before the kill could land"
    total_chunks = -(-Y.shape[1] // 2)
    res = bl.bulkscan_perms(
        Y, G, K, nperms=199, rndseed=4, trait_chunk=2, checkpoint=str(ck)
    )
    ref = bl.bulkscan_perms(Y, G, K, nperms=199, rndseed=4, trait_chunk=2)
    assert len(list(ck.glob("maxlods_*.npy"))) == total_chunks
    assert np.max(np.abs(np.asarray(res.maxlods) - np.asarray(ref.maxlods))) < 1e-12


def test_bulkperm_checkpoint_sharded_and_lowrank(perm_data, tmp_path):
    """Checkpointing on the sharded and rank-k engines (same file format)."""
    import jax

    G, Y, K = perm_data
    lr = bl.LowRankKinship(
        U=np.linalg.eigh(K)[1][:, -8:], lam=np.linalg.eigh(K)[0][-8:]
    )
    ref = bl.bulkscan_perms(Y, G, lr, nperms=29, rndseed=2, trait_chunk=4)
    ck = tmp_path / "lr"
    a = bl.bulkscan_perms(
        Y, G, lr, nperms=29, rndseed=2, trait_chunk=4, checkpoint=str(ck)
    )
    assert np.max(np.abs(np.asarray(a.maxlods) - np.asarray(ref.maxlods))) < 1e-12
    b = bl.bulkscan_perms(
        Y, G, lr, nperms=29, rndseed=2, trait_chunk=4, checkpoint=str(ck)
    )
    assert np.max(np.abs(np.asarray(b.maxlods) - np.asarray(ref.maxlods))) < 1e-12
    if len(jax.devices()) >= 8:
        from bulklmm_tpu.parallel import bulkscan_perms_sharded, make_mesh

        mesh = make_mesh(8, marker_shards=2)
        cks = tmp_path / "sh"
        s1 = bulkscan_perms_sharded(
            Y, G, K, mesh=mesh, nperms=29, rndseed=2, trait_chunk=4,
            checkpoint=str(cks),
        )
        s2 = bulkscan_perms_sharded(
            Y, G, K, mesh=mesh, nperms=29, rndseed=2, trait_chunk=4,
            checkpoint=str(cks),
        )
        assert np.max(np.abs(np.asarray(s1.maxlods) - np.asarray(s2.maxlods))) < 1e-12


def test_bulkperm_checkpoint_refuses_precision_and_engine_mismatch(
    perm_data, tmp_path
):
    """Resuming under a different precision (or engine) must be refused —
    it would silently mix numerics across trait chunks in one FWER matrix."""
    from bulklmm_tpu.utils.config import EXACT64, FAST32

    G, Y, K = perm_data
    ck = tmp_path / "ck"
    bl.bulkscan_perms(
        Y, G, K, nperms=9, rndseed=1, trait_chunk=2,
        checkpoint=str(ck), precision=EXACT64,
    )
    with pytest.raises(ValueError, match="precision"):
        bl.bulkscan_perms(
            Y, G, K, nperms=9, rndseed=1, trait_chunk=2,
            checkpoint=str(ck), precision=FAST32,
        )


def test_bulkperm_loco_checkpoint_per_chromosome(perm_data, tmp_path):
    """LOCO sweeps checkpoint into per-chromosome subdirectories; a rerun
    resumes every chromosome and matches the uncheckpointed run."""
    G, Y, K = perm_data
    chrom = np.repeat(["1", "2"], [60, G.shape[1] - 60])
    ck = tmp_path / "loco"
    ref = bl.bulkscan_perms_loco(Y, G, chrom, nperms=9, rndseed=4)
    a = bl.bulkscan_perms_loco(
        Y, G, chrom, nperms=9, rndseed=4, checkpoint=str(ck)
    )
    names = sorted(d.name for d in ck.iterdir())
    assert len(names) == 2
    # sanitized label + a hash of the RAW label (collision-proof: '1:A'
    # and '1 A' sanitize identically but must not share a directory)
    assert names[0].startswith("chr_1_") and names[1].startswith("chr_2_")
    b = bl.bulkscan_perms_loco(
        Y, G, chrom, nperms=9, rndseed=4, checkpoint=str(ck)
    )
    for r in (a, b):
        assert np.max(np.abs(np.asarray(r.maxlods) - np.asarray(ref.maxlods))) < 1e-12


def test_bulkperm_loco_checkpoint_label_collision(perm_data, tmp_path):
    """Labels that sanitize identically ('1:A' vs '1 A') must get distinct
    checkpoint subdirectories — one chromosome must never resume
    another's maxima (round-3 review finding, empirically confirmed)."""
    G, Y, K = perm_data
    chrom = np.repeat(["1:A", "1 A"], [48, G.shape[1] - 48])
    ck = tmp_path / "coll"
    ref = bl.bulkscan_perms_loco(
        Y, G, chrom, nperms=9, rndseed=4, share_shuffles=True
    )
    a = bl.bulkscan_perms_loco(
        Y, G, chrom, nperms=9, rndseed=4, share_shuffles=True,
        checkpoint=str(ck),
    )
    assert len(list(ck.iterdir())) == 2, "colliding labels shared a directory"
    b = bl.bulkscan_perms_loco(
        Y, G, chrom, nperms=9, rndseed=4, share_shuffles=True,
        checkpoint=str(ck),
    )
    for r in (a, b):
        assert np.max(np.abs(np.asarray(r.maxlods) - np.asarray(ref.maxlods))) < 1e-12


def test_data_fingerprint_lazy_container_never_materialized(tmp_path):
    """Over-cap lazy containers (h5py-style: shape/dtype + slicing, no
    cheap whole-array materialization) must be digested strictly by slice
    (ADVICE r4): np.asarray on the WHOLE object would pull a > RAM dataset
    into memory."""
    from bulklmm_tpu.models.bulkperm import _data_fingerprint

    rng = np.random.default_rng(7)
    arr = rng.normal(size=(4000, 50))

    class LazyRows:
        shape = arr.shape
        dtype = arr.dtype

        def __getitem__(self, idx):
            return arr[idx]

        def __array__(self, *a, **k):
            raise AssertionError("whole lazy container materialized")

    cap = 1 << 14
    lazy_digest = _data_fingerprint(LazyRows(), max_bytes=cap)
    # same bytes via a different container type -> same digest (resume a
    # memmap-backed sweep from an in-memory rerun and vice versa)
    assert lazy_digest == _data_fingerprint(arr, max_bytes=cap)


def test_data_fingerprint_memmap_matches_ndarray(tmp_path):
    """A memmap-backed panel and its in-memory copy digest identically on
    both the under-cap and over-cap paths; the checksum is pure-integer so
    it cannot drift with the BLAS build (ADVICE r4)."""
    from bulklmm_tpu.models.bulkperm import _data_fingerprint

    rng = np.random.default_rng(8)
    arr = rng.normal(size=(1000, 30))
    f = tmp_path / "g.dat"
    mm = np.memmap(f, dtype=arr.dtype, mode="w+", shape=arr.shape)
    mm[:] = arr
    mm.flush()
    ro = np.memmap(f, dtype=arr.dtype, mode="r", shape=arr.shape)
    for cap in (1 << 30, 1 << 12):  # under-cap and over-cap
        assert (_data_fingerprint(ro, max_bytes=cap)
                == _data_fingerprint(arr, max_bytes=cap))
    # single-byte edit in an unsampled row still caught through the memmap
    edited = arr.copy()
    edited[3, 7] = np.nextafter(edited[3, 7], np.inf)
    assert (_data_fingerprint(edited, max_bytes=1 << 12)
            != _data_fingerprint(arr, max_bytes=1 << 12))
