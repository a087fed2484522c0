"""Per-marker GLS effect sizes (scan(output_effects=True)).

An addition — the reference outputs LODs only (src/scan.jl:94-109); the
oracle here is the direct per-marker GLS solve: beta = (X'WX)^-1 X'Wy with
W = (delta K + I)^-1 at the fitted h2, SE via the unbiased per-marker
residual variance (GEMMA-style Wald convention).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import bulklmm_tpu as bl


def _oracle_effects(y, G, C, K, h2s):
    """Direct GLS per marker; h2s scalar (shared) or (p,) per-marker."""
    n, p = G.shape
    c = C.shape[1]
    y = y.reshape(-1, 1)
    h2s = np.broadcast_to(np.asarray(h2s, dtype=np.float64), (p,))
    betas, ses = np.empty(p), np.empty(p)
    for j in range(p):
        delta = h2s[j] / (1.0 - h2s[j])
        W = np.linalg.inv(delta * K + np.eye(n))
        X = np.concatenate([C, G[:, j:j + 1]], axis=1)
        XtWX = X.T @ W @ X
        bhat = np.linalg.solve(XtWX, X.T @ W @ y)
        r = y - X @ bhat
        rss_w = float((r.T @ W @ r)[0, 0])
        betas[j] = bhat[-1, 0]
        ses[j] = np.sqrt(rss_w / (n - c - 1) * np.linalg.inv(XtWX)[-1, -1])
    return betas, ses


@pytest.fixture(scope="module")
def effects_data(bxd_like):
    G = bxd_like["G"][:, :24]  # keep the O(p n^3) oracle cheap
    return bxd_like["Y"][:, 0], G, bxd_like["K"], bxd_like["n"]


def test_effects_null_match_gls_oracle(effects_data):
    y, G, K, n = effects_data
    res = bl.scan(y, G, K, output_effects=True)
    C = np.ones((n, 1))
    eb, es = _oracle_effects(y, G, C, K, float(res.h2_null))
    assert np.max(np.abs(np.asarray(res.beta) - eb)) < 1e-8
    assert np.max(np.abs(np.asarray(res.beta_se) - es)) < 1e-8


def test_effects_alt_per_marker_h2(effects_data):
    y, G, K, n = effects_data
    res = bl.scan(y, G, K, assumption="alt", output_effects=True)
    C = np.ones((n, 1))
    eb, es = _oracle_effects(y, G, C, K, np.asarray(res.h2_each_marker))
    assert np.max(np.abs(np.asarray(res.beta) - eb)) < 1e-7
    assert np.max(np.abs(np.asarray(res.beta_se) - es)) < 1e-7


def test_effects_with_covariates_and_perms(effects_data):
    y, G, K, n = effects_data
    rng = np.random.default_rng(4)
    C = rng.normal(size=(n, 2))
    res = bl.scan(y, G, K, C, output_effects=True, permutation_test=True,
                  nperms=16)
    Cfull = np.concatenate([np.ones((n, 1)), C], axis=1)
    eb, es = _oracle_effects(y, G, Cfull, K, float(res.h2_null))
    assert np.max(np.abs(np.asarray(res.beta) - eb)) < 1e-8
    assert np.max(np.abs(np.asarray(res.beta_se) - es)) < 1e-8
    assert res.L_perms is not None  # perms still delivered alongside


def test_effects_lowrank_full_rank_k_matches(effects_data):
    y, G, K, n = effects_data
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact

    full = bl.scan(y, G, K, output_effects=True)
    lr = kinship_lowrank_exact(K, n, dtype=jnp.float64)
    low = bl.scan(y, G, lr, output_effects=True)
    assert np.max(np.abs(np.asarray(full.beta) - np.asarray(low.beta))) < 1e-6
    assert np.max(np.abs(np.asarray(full.beta_se)
                         - np.asarray(low.beta_se))) < 1e-6
    alt_full = bl.scan(y, G, K, assumption="alt", output_effects=True)
    alt_low = bl.scan(y, G, lr, assumption="alt", output_effects=True)
    assert np.max(np.abs(np.asarray(alt_full.beta)
                         - np.asarray(alt_low.beta))) < 1e-5


def test_effects_wald_consistent_with_lod(bxd_like):
    """Under the shared null h2, the Wald |t| = |beta|/SE and the LOD are
    both strictly monotone in the same partial correlation |r|, so their
    marker rankings must coincide — and the planted +0.8 effect on marker
    17 must carry a positive beta."""
    y, G, K = bxd_like["Y"][:, 0], bxd_like["G"], bxd_like["K"]
    res = bl.scan(y, G, K, output_effects=True)
    t = np.abs(np.asarray(res.beta) / np.asarray(res.beta_se))
    lod = np.asarray(res.lod)
    assert np.array_equal(np.argsort(t), np.argsort(lod))
    assert float(res.beta[17]) > 0


def test_bulkscan_effects_match_gls_oracle(bxd_like):
    """bulkscan(output_effects=True): each (marker, trait) beta/SE equals
    the direct GLS solve at that trait's fitted null h2."""
    G = bxd_like["G"][:, :16]
    Y = bxd_like["Y"][:, :3]
    K, n = bxd_like["K"], bxd_like["n"]
    res = bl.bulkscan(Y, G, K, output_effects=True)
    C = np.ones((n, 1))
    h2s = np.asarray(res.h2_null_list)
    for j in range(Y.shape[1]):
        eb, es = _oracle_effects(Y[:, j], G, C, K, float(h2s[j]))
        assert np.max(np.abs(np.asarray(res.beta_mat[:, j]) - eb)) < 1e-8, j
        assert np.max(np.abs(np.asarray(res.beta_se_mat[:, j]) - es)) < 1e-8, j


def test_bulkscan_effects_lowrank_and_guards(bxd_like):
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact

    G = bxd_like["G"][:, :16]
    Y = bxd_like["Y"][:, :3]
    K, n = bxd_like["K"], bxd_like["n"]
    full = bl.bulkscan(Y, G, K, method="null-exact", output_effects=True)
    lr = kinship_lowrank_exact(K, n, dtype=jnp.float64)
    low = bl.bulkscan(Y, G, lr, method="null-exact", output_effects=True)
    assert np.max(np.abs(np.asarray(full.beta_mat)
                         - np.asarray(low.beta_mat))) < 1e-6
    assert np.max(np.abs(np.asarray(full.beta_se_mat)
                         - np.asarray(low.beta_se_mat))) < 1e-6
    with pytest.raises(ValueError, match="null methods"):
        bl.bulkscan(Y, G, K, method="alt-grid", output_effects=True)


def test_effects_sharded_and_streamed_match_inmemory(bxd_like):
    """The sharded and streamed engines deliver the identical effects
    matrices as the in-memory bulkscan (same kernels, different placement)."""
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact
    from bulklmm_tpu.parallel import bulkscan_sharded, make_mesh

    G = bxd_like["G"][:, :20]
    Y = bxd_like["Y"][:, :5]
    K, n = bxd_like["K"], bxd_like["n"]
    ref = bl.bulkscan(Y, G, K, output_effects=True)
    sh = bulkscan_sharded(Y, G, K, mesh=make_mesh(8), output_effects=True)
    assert np.max(np.abs(np.asarray(sh.beta_mat)
                         - np.asarray(ref.beta_mat))) < 1e-10
    assert np.max(np.abs(np.asarray(sh.beta_se_mat)
                         - np.asarray(ref.beta_se_mat))) < 1e-10
    st = bl.bulkscan_streamed(Y, G, K, output_effects=True, marker_block=8)
    assert np.max(np.abs(st.beta_mat - np.asarray(ref.beta_mat))) < 1e-10
    assert np.max(np.abs(st.beta_se_mat
                         - np.asarray(ref.beta_se_mat))) < 1e-10
    # rank-k streamed route
    lr = kinship_lowrank_exact(K, n, dtype=jnp.float64)
    ref_lr = bl.bulkscan(Y, G, lr, output_effects=True)
    st_lr = bl.bulkscan_streamed(Y, G, lr, output_effects=True,
                                 marker_block=8)
    assert np.max(np.abs(st_lr.beta_mat
                         - np.asarray(ref_lr.beta_mat))) < 1e-10
    # sharded rank-k
    sh_lr = bulkscan_sharded(Y, G, lr, mesh=make_mesh(8),
                             output_effects=True)
    assert np.max(np.abs(np.asarray(sh_lr.beta_mat)
                         - np.asarray(ref_lr.beta_mat))) < 1e-10
    # guards
    with pytest.raises(ValueError, match="null methods"):
        bl.bulkscan_streamed(Y, G, K, method="alt-grid", output_effects=True)
    with pytest.raises(ValueError, match="null methods"):
        bulkscan_sharded(Y, G, K, method="alt-grid", output_effects=True)


def test_effects_trait_chunked_matches_unchunked(bxd_like):
    """output_effects rides the same chunked single-pass pipeline as the
    LODs — trait_chunk must not change (or drop) the effects."""
    G = bxd_like["G"][:, :20]
    Y = bxd_like["Y"][:, :7]
    K = bxd_like["K"]
    for method in ("null-grid", "null-exact"):
        ref = bl.bulkscan(Y, G, K, method=method, output_effects=True)
        ch = bl.bulkscan(Y, G, K, method=method, output_effects=True,
                         trait_chunk=3)  # 7 traits -> ragged chunking
        assert np.max(np.abs(np.asarray(ch.beta_mat)
                             - np.asarray(ref.beta_mat))) < 1e-12, method
        assert np.max(np.abs(np.asarray(ch.beta_se_mat)
                             - np.asarray(ref.beta_se_mat))) < 1e-12, method
        assert np.max(np.abs(np.asarray(ch.L) - np.asarray(ref.L))) < 1e-12
    # low-rank route with chunking
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact

    lr = kinship_lowrank_exact(K, 30, dtype=jnp.float64)
    ref = bl.bulkscan(Y, G, lr, output_effects=True)
    ch = bl.bulkscan(Y, G, lr, output_effects=True, trait_chunk=4)
    assert np.max(np.abs(np.asarray(ch.beta_mat)
                         - np.asarray(ref.beta_mat))) < 1e-12
