"""Sharded-engine tests on a virtual 8-device mesh: numerical equality with
the unsharded engines, actual multi-device placement, and the permutation
path (multi-host pattern per SURVEY §4 — single-host mesh simulation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bulklmm_tpu import bulkscan, get_thresholds, scan
from bulklmm_tpu.parallel import (
    bulkscan_sharded,
    make_mesh,
    scan_perms_sharded,
)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8, marker_shards=2)


def test_mesh_shape(mesh):
    assert mesh.shape == {"traits": 4, "markers": 2}


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
def test_sharded_matches_unsharded(bxd_like, mesh, method):
    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    r_sh = bulkscan_sharded(Y, G, K, mesh=mesh, method=method)
    r_ref = bulkscan(Y, G, K, method=method)
    assert r_sh.L.shape == r_ref.L.shape == (bxd_like["p"], bxd_like["m"])
    # null-exact runs Brent per trait: SPMD reduction reordering perturbs
    # ell at machine eps and Brent amplifies it into ~1e-7 LOD differences
    tol = 1e-6 if method == "null-exact" else 1e-9
    assert float(jnp.max(jnp.abs(r_sh.L - r_ref.L))) < tol
    if method != "alt-grid":
        assert np.allclose(
            np.asarray(r_sh.h2_null_list), np.asarray(r_ref.h2_null_list)
        )


def test_sharded_output_is_distributed(bxd_like, mesh):
    """The LOD matrix must actually live sharded across the mesh, not be
    gathered to one device."""
    r = bulkscan_sharded(bxd_like["Y"], bxd_like["G"], bxd_like["K"], mesh=mesh)
    assert len(r.L.sharding.device_set) == 8


def test_sharded_uneven_traits(bxd_like, mesh):
    """Trait/marker counts not divisible by the mesh axes are padded and the
    padding sliced off."""
    Y = bxd_like["Y"][:, :13]  # 13 traits on a 4-way traits axis
    G = bxd_like["G"][:, :51]  # 51 markers on a 2-way markers axis
    r_sh = bulkscan_sharded(Y, G, bxd_like["K"], mesh=mesh)
    r_ref = bulkscan(Y, G, bxd_like["K"])
    assert r_sh.L.shape == (51, 13)
    assert float(jnp.max(jnp.abs(r_sh.L - r_ref.L))) < 1e-9


def test_sharded_permutations_and_thresholds(bxd_like, mesh):
    y = bxd_like["Y"][:, 0]
    res = scan_perms_sharded(
        y, bxd_like["G"], bxd_like["K"], mesh=mesh, nperms=199, rndseed=11
    )
    assert res.lod.shape == (bxd_like["p"],)
    assert res.L_perms.shape == (bxd_like["p"], 199)
    thr = get_thresholds(res.L_perms, [0.10, 0.05])
    assert thr.thrs[0] <= thr.thrs[1]
    # unsharded engine with the same seed and perm count must agree exactly
    ref = scan(
        y, bxd_like["G"], bxd_like["K"],
        permutation_test=True, nperms=199, rndseed=11, prior_variance=1.0,
    )
    assert float(jnp.max(jnp.abs(res.L_perms - ref.L_perms))) < 1e-9


def test_calc_kinship_sharded(bxd_like, mesh):
    """shard_map kinship over the markers axis == single-device kinship."""
    import numpy as np
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bulklmm_tpu.ops.kinship import calc_kinship, calc_kinship_sharded

    G = jnp.asarray(bxd_like["G"][:, :112])  # 112 divides the 8-way flat axis
    flat = jax.sharding.Mesh(
        np.asarray(mesh.devices).reshape(-1), ("markers",)
    )
    K_sh = shard_map(
        lambda g: calc_kinship_sharded(g, "markers"),
        mesh=flat,
        in_specs=P(None, "markers"),
        out_specs=P(None, None),
    )(G)
    K_ref = calc_kinship(G)
    assert float(jnp.max(jnp.abs(K_sh - K_ref))) < 1e-10


def test_local_trait_slice_single_process():
    from bulklmm_tpu.parallel import init_distributed, local_trait_slice

    assert init_distributed() == 0
    sl = local_trait_slice(100)
    assert (sl.start, sl.stop) == (0, 100)


def test_sharded_hot_path_has_no_collectives(bxd_like, mesh):
    """Trait/marker sharding is embarrassingly parallel: the compiled
    null-grid program must contain NO cross-device collectives — the static
    guarantee behind linear multi-chip scaling (replicated n-sized factors,
    sharded (p, m) outputs)."""
    from bulklmm_tpu.models.bulkscan import _bulkscan_null_grid_core
    from bulklmm_tpu.parallel.sharding import shard_rotated
    from bulklmm_tpu.ops.rotation import transform_rotation
    from bulklmm_tpu.utils.config import DEFAULT_PRECISION

    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    n = Y.shape[0]
    rot = transform_rotation(jnp.asarray(Y), jnp.asarray(G), K, add_intercept=True)
    y0s, X0ms, C0s, lams, m, p = shard_rotated(rot.y0, rot.X0, rot.lam, 1, mesh)
    h2_grid = jnp.arange(0.0, 0.91, 0.1, dtype=y0s.dtype)
    lowered = _bulkscan_null_grid_core.lower(
        y0s, X0ms, C0s, lams, h2_grid,
        prior=(1.0, 0.0), reml=False, method="qr",
        precision=DEFAULT_PRECISION,
    )
    hlo = lowered.compile().as_text()
    for coll in ("all-reduce", "all-gather", "all-to-all", "collective-permute",
                 "reduce-scatter"):
        assert coll not in hlo, f"unexpected collective {coll} in sharded scan"


def test_kinship_marker_chunking(bxd_like):
    from bulklmm_tpu.ops.kinship import calc_kinship

    G = bxd_like["G"]
    K_full = calc_kinship(G)
    K_chunk = calc_kinship(G, marker_chunk=17)  # non-divisible chunk
    assert float(jnp.max(jnp.abs(K_full - K_chunk))) < 1e-12


def test_sharded_weights_and_pvals(bxd_like, mesh):
    rng2 = np.random.default_rng(9)
    Y, G, K = bxd_like["Y"][:, :6], bxd_like["G"], bxd_like["K"]
    w = rng2.uniform(0.5, 2.0, bxd_like["n"])
    a = bulkscan_sharded(Y, G, K, mesh=mesh, weights=w, output_pvals=True)
    b = bulkscan(Y, G, K, weights=w, output_pvals=True)
    assert float(jnp.max(jnp.abs(a.L - b.L))) < 1e-9
    assert np.allclose(np.asarray(a.log10Pvals_mat), np.asarray(b.log10Pvals_mat))


def test_sharded_with_covariates(bxd_like, mesh):
    rng3 = np.random.default_rng(21)
    Y, G, K = bxd_like["Y"][:, :8], bxd_like["G"], bxd_like["K"]
    covar = rng3.normal(size=(bxd_like["n"], 2))
    a = bulkscan_sharded(Y, G, K, covar, mesh=mesh)
    b = bulkscan(Y, G, K, covar)
    assert float(jnp.max(jnp.abs(a.L - b.L))) < 1e-9


def test_lowrank_perms_sharded_matches_single_device(bxd_like, mesh):
    """Rank-k (Woodbury) permutation engine on the mesh: the beyond-the-
    eigh-wall cohort's multi-chip path. Must equal the
    single-device rank-k bulkscan_perms exactly — the chunk core is the
    same Woodbury whitening, tiled traits x perms over the mesh."""
    from bulklmm_tpu import bulkscan_perms
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact
    from bulklmm_tpu.parallel import bulkscan_perms_sharded

    Y, G, K = bxd_like["Y"][:, :10], bxd_like["G"], bxd_like["K"]
    lr = kinship_lowrank_exact(K, 20, dtype=jnp.float64)
    a = bulkscan_perms_sharded(Y, G, lr, mesh=mesh, nperms=99, rndseed=5)
    b = bulkscan_perms(Y, G, lr, nperms=99, rndseed=5)
    assert a.maxlods.shape == b.maxlods.shape == (10, 100)
    assert float(jnp.max(jnp.abs(a.maxlods - b.maxlods))) < 1e-9
    assert float(jnp.max(jnp.abs(a.h2_null_list - b.h2_null_list))) < 1e-12
    # odd trait count + sub-shard chunking exercise the padding paths
    c = bulkscan_perms_sharded(
        Y[:, :7], G, lr, mesh=mesh, nperms=99, rndseed=5, trait_chunk=3,
        perm_chunk=32,
    )
    d = bulkscan_perms(Y[:, :7], G, lr, nperms=99, rndseed=5)
    assert float(jnp.max(jnp.abs(c.maxlods - d.maxlods))) < 1e-9


def test_lowrank_perms_sharded_rejects_pallas(bxd_like, mesh):
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact
    from bulklmm_tpu.parallel import bulkscan_perms_sharded

    lr = kinship_lowrank_exact(bxd_like["K"], 10)
    with pytest.raises(ValueError, match="pallas"):
        bulkscan_perms_sharded(
            bxd_like["Y"][:, :4], bxd_like["G"], lr, mesh=mesh,
            nperms=9, engine="pallas",
        )


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
def test_sharded_trait_chunk_matches_unchunked(bxd_like, mesh, method):
    """trait_chunk through the sharded engine: global
    trait blocks bound per-device memory; numerics must be unchanged,
    including an uneven remainder chunk and the effects outputs."""
    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    a = bulkscan_sharded(Y, G, K, mesh=mesh, method=method, trait_chunk=7)
    b = bulkscan_sharded(Y, G, K, mesh=mesh, method=method)
    assert float(jnp.max(jnp.abs(a.L - b.L))) < 1e-12
    if method == "alt-grid":
        assert float(jnp.max(jnp.abs(a.h2_panel - b.h2_panel))) < 1e-12
    else:
        assert float(jnp.max(jnp.abs(a.h2_null_list - b.h2_null_list))) < 1e-12
    if method == "null-grid":
        c = bulkscan_sharded(
            Y, G, K, mesh=mesh, method=method, trait_chunk=8,
            output_effects=True,
        )
        d = bulkscan(Y, G, K, method=method, output_effects=True)
        assert float(jnp.max(jnp.abs(c.beta_mat - d.beta_mat))) < 1e-9
        assert float(jnp.max(jnp.abs(c.beta_se_mat - d.beta_se_mat))) < 1e-9


def test_sharded_lowrank_trait_chunk(bxd_like, mesh):
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact

    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    lr = kinship_lowrank_exact(K, 20, dtype=jnp.float64)
    a = bulkscan_sharded(Y, G, lr, mesh=mesh, trait_chunk=5)
    b = bulkscan_sharded(Y, G, lr, mesh=mesh)
    assert float(jnp.max(jnp.abs(a.L - b.L))) < 1e-12
    assert float(jnp.max(jnp.abs(a.h2_null_list - b.h2_null_list))) < 1e-12


def test_weak_scaling_harness_smoke(tmp_path):
    """benchmarks/scaling.py degrades to a correctness + placement report
    on virtual devices and writes the JSON artifact."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    out = tmp_path / "scaling.json"
    r = subprocess.run(
        [sys.executable, str(repo / "benchmarks/scaling.py"),
         "--n", "32", "--markers", "64", "--base-traits", "24",
         "--shards", "1", "4", "8", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    rows = json.loads(out.read_text())
    assert [row["shards"] for row in rows] == [1, 4, 8]
    assert all(row["virtual"] and row["ok"] for row in rows)
    assert rows[-1]["devices_used"] == 8


def test_large_virtual_meshes_16_and_32(tmp_path):
    """16- and 32-device virtual meshes with marker_shards=4 and
    non-divisible trait/marker counts on both axes:
    sharded == unsharded. Runs in a subprocess — the suite's interpreter
    is pinned to 8 virtual devices at jax init."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    script = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import bulklmm_tpu as bl
from bulklmm_tpu.parallel import bulkscan_perms_sharded, bulkscan_sharded, make_mesh

assert jax.device_count() == 32, jax.device_count()
rng = np.random.default_rng(3)
n, p, m = 45, 53, 37  # prime-ish: never divisible by any mesh axis
G = rng.uniform(0, 1, (n, p))
K = np.asarray(bl.calc_kinship(G))
Y = rng.normal(size=(n, m))
ref = {meth: np.asarray(bl.bulkscan(Y, G, K, method=meth).L)
       for meth in ("null-grid", "null-exact", "alt-grid")}
refp = np.asarray(bl.bulkscan_perms(Y, G, K, nperms=13, rndseed=9).maxlods)
for ndev, mshards in ((16, 4), (32, 4), (32, 8)):
    mesh = make_mesh(ndev, marker_shards=mshards)
    assert mesh.shape == {"traits": ndev // mshards, "markers": mshards}
    for meth in ("null-grid", "null-exact", "alt-grid"):
        L = np.asarray(bl.parallel.bulkscan_sharded(
            Y, G, K, mesh=mesh, method=meth).L)
        d = float(np.max(np.abs(L - ref[meth])))
        assert d < 1e-9, (ndev, mshards, meth, d)
    mx = np.asarray(bulkscan_perms_sharded(
        Y, G, K, mesh=mesh, nperms=13, rndseed=9).maxlods)
    d = float(np.max(np.abs(mx - refp)))
    assert d < 1e-9, (ndev, mshards, "perms", d)
print("LARGE MESH PASS")
"""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=32"
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=900,
                       cwd=repo)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    assert "LARGE MESH PASS" in r.stdout
