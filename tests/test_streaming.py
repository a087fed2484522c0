"""Marker-streamed bulk scans (models/streaming.py).

The streamed engine must reproduce the in-memory engines exactly: each
block runs the identical kernels, the per-trait null fit is
marker-independent, and the final partial block is padded with zero
markers whose results are dropped.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import bulklmm_tpu as bl
from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact


@pytest.fixture(scope="module")
def cohort():
    rng = np.random.default_rng(23)
    n, p, m = 50, 53, 11  # p deliberately not a multiple of the block size
    G = rng.choice([0.0, 0.5, 1.0], size=(n, p))
    K = np.asarray(bl.calc_kinship(G))
    Y = rng.normal(size=(n, m))
    Y[:, 2] += 0.8 * (G[:, 19] - G[:, 19].mean())
    covar = rng.normal(size=(n, 2))
    return G, K, Y, covar


def test_streamed_null_grid_matches_inmemory(cohort):
    G, K, Y, covar = cohort
    ref = bl.bulkscan(Y, G, K, covar, method="null-grid")
    st = bl.bulkscan_streamed(Y, G, K, covar, method="null-grid",
                              marker_block=16)
    assert st.L.shape == ref.L.shape
    assert np.max(np.abs(st.L - np.asarray(ref.L))) < 1e-6  # f32 out array
    assert np.allclose(np.asarray(st.h2_null_list),
                       np.asarray(ref.h2_null_list))


def test_streamed_null_exact_matches_inmemory(cohort):
    G, K, Y, covar = cohort
    ref = bl.bulkscan(Y, G, K, method="null-exact")
    st = bl.bulkscan_streamed(Y, G, K, method="null-exact", marker_block=16)
    assert np.max(np.abs(st.L - np.asarray(ref.L))) < 1e-5
    assert np.max(np.abs(np.asarray(st.h2_null_list)
                         - np.asarray(ref.h2_null_list))) < 1e-6


def test_streamed_alt_grid_matches_inmemory(cohort):
    G, K, Y, covar = cohort
    ref = bl.bulkscan(Y, G, K, covar, method="alt-grid", engine="xla")
    st = bl.bulkscan_streamed(Y, G, K, covar, method="alt-grid",
                              marker_block=16)
    assert np.max(np.abs(st.L - np.asarray(ref.L))) < 1e-6
    assert np.allclose(st.h2_panel, np.asarray(ref.h2_panel))


def test_streamed_reml_pvals_and_memmap(cohort, tmp_path):
    G, K, Y, covar = cohort
    ref = bl.bulkscan(Y, G, K, covar, method="null-grid", reml=True,
                      output_pvals=True)
    out = np.memmap(tmp_path / "lods.dat", dtype=np.float32, mode="w+",
                    shape=(G.shape[1], Y.shape[1]))
    st = bl.bulkscan_streamed(Y, G, K, covar, method="null-grid", reml=True,
                              output_pvals=True, marker_block=16, out=out)
    assert st.L is out
    assert np.max(np.abs(out - np.asarray(ref.L))) < 1e-6
    assert np.max(np.abs(st.log10Pvals_mat
                         - np.asarray(ref.log10Pvals_mat))) < 1e-5


def test_streamed_lowrank_all_methods(cohort):
    G, K, Y, covar = cohort
    lr = kinship_lowrank_exact(K, 20, dtype=jnp.float64)
    for meth, tol in (("null-grid", 1e-6), ("null-exact", 1e-5),
                      ("alt-grid", 1e-6)):
        ref = bl.bulkscan(Y, G, lr, covar, method=meth)
        st = bl.bulkscan_streamed(Y, G, lr, covar, method=meth,
                                  marker_block=16)
        assert np.max(np.abs(st.L - np.asarray(ref.L))) < tol, meth


def test_streamed_guards(cohort):
    G, K, Y, covar = cohort
    with pytest.raises(ValueError, match="method"):
        bl.bulkscan_streamed(Y, G, K, method="banana")
    bad = np.empty((3, 3), dtype=np.float32)
    with pytest.raises(ValueError, match="shape"):
        bl.bulkscan_streamed(Y, G, K, out=bad)
    with pytest.raises(ValueError, match="engine"):
        bl.bulkscan_streamed(Y, G, K, engine="palas")
    with pytest.raises(ValueError, match="alt-grid"):
        bl.bulkscan_streamed(Y, G, K, method="null-grid", engine="pallas")
    with pytest.raises(ValueError, match="shape"):
        bl.bulkscan_streamed(Y, G, K, output_pvals=True, out_pvals=bad)
    lr = kinship_lowrank_exact(K, 10, dtype=jnp.float64)
    with pytest.raises(ValueError, match="LowRank"):
        bl.bulkscan_streamed(Y, G, lr, method="alt-grid", engine="pallas")


def test_streamed_pvals_blockwise_memmap(cohort, tmp_path):
    """P-values are computed per block on the host (never a full-matrix
    device round-trip) and can land in a caller-provided memmap."""
    G, K, Y, covar = cohort
    p, m = G.shape[1], Y.shape[1]
    ref = bl.bulkscan(Y, G, K, covar, method="alt-grid", engine="xla",
                      output_pvals=True)
    pv = np.memmap(tmp_path / "pv.dat", dtype=np.float32, mode="w+",
                   shape=(p, m))
    st = bl.bulkscan_streamed(Y, G, K, covar, method="alt-grid",
                              output_pvals=True, out_pvals=pv,
                              marker_block=16)
    assert st.log10Pvals_mat is pv
    assert np.max(np.abs(pv - np.asarray(ref.log10Pvals_mat))) < 1e-5
    # low-rank route too
    lr = kinship_lowrank_exact(K, 20, dtype=jnp.float64)
    ref_lr = bl.bulkscan(Y, G, lr, covar, output_pvals=True)
    st_lr = bl.bulkscan_streamed(Y, G, lr, covar, output_pvals=True,
                                 marker_block=16)
    assert np.max(np.abs(st_lr.log10Pvals_mat
                         - np.asarray(ref_lr.log10Pvals_mat))) < 1e-5


@pytest.fixture(scope="module")
def vmesh():
    import jax

    from bulklmm_tpu.parallel import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8, marker_shards=2)


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
def test_streamed_on_mesh_matches_inmemory(cohort, vmesh, method):
    """Streamed x sharded composition: host marker
    blocks placed P(None, 'markers'), traits P(None, 'traits'); per-block
    kernels run sharded. Must equal the in-memory engine; odd trait count
    and a block width that does not divide the markers axis exercise the
    padding/rounding paths."""
    G, K, Y, covar = cohort
    res = bl.bulkscan_streamed(
        Y[:, :7], G, K, method=method, marker_block=13, mesh=vmesh
    )
    ref = bl.bulkscan(Y[:, :7], G, K, method=method)
    assert np.max(np.abs(np.asarray(res.L) - np.asarray(ref.L))) < 1e-9
    if method == "alt-grid":
        assert np.max(np.abs(np.asarray(res.h2_panel) - np.asarray(ref.h2_panel))) < 1e-9
    else:
        assert res.h2_null_list.shape == (7,)
        assert np.max(np.abs(np.asarray(res.h2_null_list) - np.asarray(ref.h2_null_list))) < 1e-12


def test_streamed_on_mesh_lowrank_and_effects(cohort, vmesh):
    G, K, Y, covar = cohort
    lr = kinship_lowrank_exact(K, 20, dtype=jnp.float64)
    res = bl.bulkscan_streamed(Y[:, :6], G, lr, marker_block=16, mesh=vmesh)
    ref = bl.bulkscan(Y[:, :6], G, lr)
    assert np.max(np.abs(np.asarray(res.L) - np.asarray(ref.L))) < 1e-9
    # effects stream through the same sharded per-block pass
    re2 = bl.bulkscan_streamed(
        Y[:, :6], G, K, marker_block=16, mesh=vmesh, output_effects=True
    )
    rf2 = bl.bulkscan(Y[:, :6], G, K, output_effects=True)
    assert np.max(np.abs(np.asarray(re2.beta_mat) - np.asarray(rf2.beta_mat))) < 1e-9
    assert np.max(np.abs(np.asarray(re2.beta_se_mat) - np.asarray(rf2.beta_se_mat))) < 1e-9


def test_streamed_perms_checkpoint_resume(cohort, tmp_path):
    """Streamed permutation sweeps persist the running-max accumulator +
    marker-block cursor; a rerun resumes from the last completed block and
    matches an uninterrupted run exactly (full-rank and rank-k)."""
    G, K, Y = cohort[0], cohort[1], cohort[2]
    ref = bl.bulkscan_perms_streamed(
        Y[:, :5], G, K, nperms=19, rndseed=6, marker_block=16
    )
    ck = tmp_path / "fr"
    a = bl.bulkscan_perms_streamed(
        Y[:, :5], G, K, nperms=19, rndseed=6, marker_block=16,
        checkpoint=str(ck),
    )
    assert np.max(np.abs(np.asarray(a.maxlods) - np.asarray(ref.maxlods))) < 1e-12
    assert (ck / "acc_state.npz").is_file()
    # simulate preemption after 2 of 4 blocks: rewind the cursor and the
    # accumulator to a partial state (only blocks 0-1 folded in)
    partial = bl.bulkscan_perms_streamed(
        Y[:, :5], G[:, :32], K, nperms=19, rndseed=6, marker_block=16
    )
    np.savez(ck / "acc_state.npz",
             maxima=np.asarray(partial.maxlods), blocks_done=2)
    b = bl.bulkscan_perms_streamed(
        Y[:, :5], G, K, nperms=19, rndseed=6, marker_block=16,
        checkpoint=str(ck),
    )
    assert np.max(np.abs(np.asarray(b.maxlods) - np.asarray(ref.maxlods))) < 1e-12
    # rank-k path shares the mechanism
    lr = kinship_lowrank_exact(K, 15, dtype=jnp.float64)
    ref_lr = bl.bulkscan_perms_streamed(
        Y[:, :5], G, lr, nperms=19, rndseed=6, marker_block=16
    )
    ck2 = tmp_path / "lr"
    c = bl.bulkscan_perms_streamed(
        Y[:, :5], G, lr, nperms=19, rndseed=6, marker_block=16,
        checkpoint=str(ck2),
    )
    d = bl.bulkscan_perms_streamed(
        Y[:, :5], G, lr, nperms=19, rndseed=6, marker_block=16,
        checkpoint=str(ck2),
    )
    for r in (c, d):
        assert np.max(np.abs(np.asarray(r.maxlods) - np.asarray(ref_lr.maxlods))) < 1e-12


def test_streamed_perms_on_mesh_matches_single_device(cohort, vmesh, tmp_path):
    """Streamed x sharded x permutations:
    bulkscan_perms_streamed(mesh=...) runs the sharded chunk cores per host
    marker block — the large-p-beyond-HBM multi-chip FWER composition. Must
    equal the single-device streamed sweep at 1e-9 (full-rank AND rank-k),
    with checkpoint/resume preserved on the mesh."""
    G, K, Y = cohort[0], cohort[1], cohort[2]
    Ys = Y[:, :5]  # odd trait count exercises the traits-axis padding
    ref = bl.bulkscan_perms_streamed(
        Ys, G, K, nperms=19, rndseed=6, marker_block=16
    )
    res = bl.bulkscan_perms_streamed(
        Ys, G, K, nperms=19, rndseed=6, marker_block=16, mesh=vmesh
    )
    assert res.maxlods.shape == ref.maxlods.shape
    assert np.max(np.abs(np.asarray(res.maxlods) - np.asarray(ref.maxlods))) < 1e-9
    assert np.max(np.abs(
        np.asarray(res.log10_adj_pvals) - np.asarray(ref.log10_adj_pvals)
    )) < 1e-9
    # rank-k Woodbury whitening on the mesh, streamed
    lr = kinship_lowrank_exact(K, 20, dtype=jnp.float64)
    ref_lr = bl.bulkscan_perms_streamed(
        Ys, G, lr, nperms=19, rndseed=6, marker_block=16
    )
    res_lr = bl.bulkscan_perms_streamed(
        Ys, G, lr, nperms=19, rndseed=6, marker_block=16, mesh=vmesh
    )
    assert np.max(np.abs(
        np.asarray(res_lr.maxlods) - np.asarray(ref_lr.maxlods)
    )) < 1e-9
    # checkpointing composes: persist on the mesh, rewind the cursor to a
    # partial state, resume on the mesh; cadence honored
    ck = tmp_path / "mesh_ck"
    a = bl.bulkscan_perms_streamed(
        Ys, G, K, nperms=19, rndseed=6, marker_block=16, mesh=vmesh,
        checkpoint=str(ck), checkpoint_every=2,
    )
    assert np.max(np.abs(np.asarray(a.maxlods) - np.asarray(ref.maxlods))) < 1e-9
    st = np.load(ck / "acc_state.npz")
    np.savez(ck / "acc_state.npz", maxima=st["maxima"], blocks_done=2)
    b = bl.bulkscan_perms_streamed(
        Ys, G, K, nperms=19, rndseed=6, marker_block=16, mesh=vmesh,
        checkpoint=str(ck), checkpoint_every=2,
    )
    assert np.max(np.abs(np.asarray(b.maxlods) - np.asarray(ref.maxlods))) < 1e-9


def test_rotate_block_pins_highest_precision():
    """The streamed engines rotate marker blocks through _rotate_block;
    on a GPU a default-precision f32 dot is single-pass TF32 (~1e-3
    relative), the bug class already fixed for Y0/C0. Pin the compiled dot
    to HIGHEST so it cannot silently regress."""
    from bulklmm_tpu.models.streaming import _rotate_block

    Ut = jnp.zeros((8, 8), jnp.float32)
    Xb = jnp.zeros((8, 4), jnp.float32)
    C = jnp.ones((8, 1), jnp.float32)
    txt = _rotate_block.lower(Ut, Xb, C).as_text()
    assert "precision = [HIGHEST, HIGHEST]" in txt
