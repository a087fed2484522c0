"""Leave-one-chromosome-out scans (models/loco.py).

An addition (GEMMA -loco / BOLT-LMM practice; the reference always scans
against the whole-genome kinship). The ground truth is compositional: for
every chromosome c, LOCO results must equal the ordinary engines run with
``calc_kinship(G[:, chrom != c])``.
"""

import numpy as np
import pytest

import bulklmm_tpu as bl


@pytest.fixture(scope="module")
def loco_data(bxd_like):
    p = bxd_like["p"]
    # 4 chromosomes of unequal size, labels in encounter order
    chrom = np.repeat(["1", "2", "3", "X"], [40, 32, 28, p - 100])
    return bxd_like["G"], bxd_like["Y"][:, :4], chrom


def test_loco_kinship_equals_subset_kinship(loco_data):
    G, Y, chrom = loco_data
    Ks = bl.loco_kinship(G, chrom)
    assert set(Ks) == {"1", "2", "3", "X"}
    for c, K in Ks.items():
        direct = np.asarray(bl.calc_kinship(G[:, chrom != c]))
        assert np.max(np.abs(np.asarray(K) - direct)) < 1e-9, c


def test_bulkscan_loco_matches_per_chromosome_runs(loco_data):
    G, Y, chrom = loco_data
    res = bl.bulkscan_loco(Y, G, chrom, output_effects=True)
    for c in ("1", "3", "X"):
        mask = chrom == c
        Kc = np.asarray(bl.calc_kinship(G[:, ~mask]))
        ref = bl.bulkscan(Y, G[:, mask], Kc, output_effects=True)
        assert np.max(np.abs(res.L[mask] - np.asarray(ref.L))) < 1e-9, c
        assert np.max(np.abs(res.beta_mat[mask]
                             - np.asarray(ref.beta_mat))) < 1e-9, c
        assert np.allclose(np.asarray(res.h2_null_by_chrom[c]),
                           np.asarray(ref.h2_null_list))


def test_scan_loco_with_perms_and_thresholds(loco_data):
    G, Y, chrom = loco_data
    y = Y[:, 0]
    res = bl.scan_loco(y, G, chrom, permutation_test=True, nperms=32,
                       rndseed=5, output_pvals=True)
    assert res.L_perms.shape == (G.shape[1], 32)
    assert set(res.h2_null_by_chrom) == {"1", "2", "3", "X"}
    # genome-wide thresholds work on the assembled permutation matrix
    thr = bl.get_thresholds(res.L_perms, [0.05])
    assert np.isfinite(float(thr.thrs[0]))
    # per-chromosome parity of the observed LODs
    mask = chrom == "2"
    Kc = np.asarray(bl.calc_kinship(G[:, ~mask]))
    ref = bl.scan(y, G[:, mask], Kc, permutation_test=True, nperms=32,
                  rndseed=5)
    assert np.max(np.abs(res.lod[mask] - np.asarray(ref.lod))) < 1e-6
    assert abs(res.h2_null_by_chrom["2"] - float(ref.h2_null)) < 1e-6


def test_scan_loco_perms_use_distinct_per_chromosome_seeds(loco_data):
    """Chromosome i permutes with rndseed + i: identical shuffle indices
    across chromosomes would make the stitched per-chromosome maxima
    conditionally dependent given y and bias genome-wide thresholds low."""
    G, Y, chrom = loco_data
    y = Y[:, 2]
    res = bl.scan_loco(y, G, chrom, permutation_test=True, nperms=16,
                       rndseed=5)
    for i, c in enumerate(["1", "2"]):
        mask = chrom == c
        Kc = np.asarray(bl.calc_kinship(G[:, ~mask]))
        ref = bl.scan(y, G[:, mask], Kc, permutation_test=True, nperms=16,
                      rndseed=5 + i)
        assert np.max(np.abs(res.L_perms[mask]
                             - np.asarray(ref.L_perms))) < 1e-9, c


def test_scan_loco_alt_assumption(loco_data):
    G, Y, chrom = loco_data
    res = bl.scan_loco(Y[:, 1], G, chrom, assumption="alt")
    assert res.h2_each_marker.shape == (G.shape[1],)
    mask = chrom == "1"
    Kc = np.asarray(bl.calc_kinship(G[:, ~mask]))
    ref = bl.scan(Y[:, 1], G[:, mask], Kc, assumption="alt")
    assert np.max(np.abs(res.h2_each_marker[mask]
                         - np.asarray(ref.h2_each_marker))) < 1e-9


def test_loco_lowrank_engine(loco_data):
    """lowrank_k routes every chromosome through the rank-k Woodbury engine;
    at k = n it reproduces the dense LOCO scan."""
    G, Y, chrom = loco_data
    n = G.shape[0]
    dense = bl.bulkscan_loco(Y, G, chrom)
    low = bl.bulkscan_loco(Y, G, chrom, lowrank_k=n)
    assert np.max(np.abs(dense.L - low.L)) < 5e-4


def test_loco_guards(loco_data):
    G, Y, chrom = loco_data
    with pytest.raises(ValueError, match="2 chromosomes"):
        bl.bulkscan_loco(Y, G, np.repeat("1", G.shape[1]))
    with pytest.raises(ValueError, match="one entry per marker"):
        bl.bulkscan_loco(Y, G, chrom[:-3])


def test_bulkscan_loco_on_mesh_matches_single_device(loco_data):
    """LOCO x sharded composition: per-chromosome scans run on the device
    mesh; results must equal the single-device LOCO engine."""
    import jax

    from bulklmm_tpu.parallel import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    G, Y, chrom = loco_data
    mesh = make_mesh(8, marker_shards=2)
    a = bl.bulkscan_loco(Y[:, :5], G, chrom, mesh=mesh)
    b = bl.bulkscan_loco(Y[:, :5], G, chrom)
    assert np.max(np.abs(np.asarray(a.L) - np.asarray(b.L))) < 1e-9
    pa = bl.bulkscan_perms_loco(Y[:, :5], G, chrom, mesh=mesh, nperms=19, rndseed=3)
    pb = bl.bulkscan_perms_loco(Y[:, :5], G, chrom, nperms=19, rndseed=3)
    assert np.max(np.abs(np.asarray(pa.maxlods) - np.asarray(pb.maxlods))) < 1e-9
    assert np.max(np.abs(np.asarray(pa.log10_adj_pvals) - np.asarray(pb.log10_adj_pvals))) < 1e-9
