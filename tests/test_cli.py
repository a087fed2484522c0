"""CLI end-to-end: kinship / scan / bulkscan subprocesses on synthetic CSVs
(the user-facing command surface; runs on the CPU, JAX_PLATFORMS=cpu)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest


@pytest.fixture(scope="module")
def csv_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    n, p, m = 30, 40, 6
    G = rng.uniform(0, 1, (n, 2 * p))
    hdr = "id," + ",".join(f"m{i}_{a}" for i in range(p) for a in "AB")
    with open(d / "geno.csv", "w") as f:
        f.write(hdr + "\n")
        for i, row in enumerate(G):
            f.write(f"s{i}," + ",".join(map(str, row)) + "\n")
    Y = rng.normal(size=(n, m))
    with open(d / "pheno.csv", "w") as f:
        f.write("id," + ",".join(f"t{i}" for i in range(m)) + ",sex\n")
        for i, row in enumerate(Y):
            f.write(f"s{i}," + ",".join(map(str, row)) + ",1\n")
    return d


def _run(args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "bulklmm_tpu"] + args,
        capture_output=True, text=True, cwd=cwd, env=env, timeout=300,
    )


def test_cli_kinship(csv_data):
    r = _run(["kinship", "--geno", "geno.csv", "--exclude-complements",
              "-o", "K.csv"], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    K = np.loadtxt(csv_data / "K.csv", delimiter=",")
    assert K.shape == (30, 30) and np.allclose(np.diag(K), 1.0)


def test_cli_scan_with_perms(csv_data):
    r = _run(["scan", "--geno", "geno.csv", "--exclude-complements",
              "--pheno", "pheno.csv", "--trait", "0", "--nperms", "50",
              "-o", "scan.csv"], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    meta = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(meta) >= {"trait", "h2_null", "sigma2_e", "thresholds"}
    lods = np.loadtxt(csv_data / "scan.csv", delimiter=",")
    assert lods.shape == (40,) and np.isfinite(lods).all()


def test_cli_bulkscan(csv_data):
    r = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
              "--pheno", "pheno.csv", "--precision", "fast32",
              "-o", "lods.npz"], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    z = np.load(csv_data / "lods.npz")
    assert z["L"].shape == (40, 6) and np.isfinite(z["L"]).all()
    assert z["h2_null_list"].shape == (6,)
    # the bf16x3 screening tier is CLI-selectable and screening-close
    r2 = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--precision", "throughput",
               "-o", "lods_tp.npz"], csv_data)
    assert r2.returncode == 0, r2.stderr[-500:]
    Ltp = np.load(csv_data / "lods_tp.npz")["L"]
    assert np.isfinite(Ltp).all()
    assert np.max(np.abs(Ltp - z["L"])) < 2e-2


def test_cli_scan_alt_assumption_and_precision(csv_data):
    """--assumption alt runs the per-marker VC path; --precision exact64
    enables x64 in the subprocess (both were previously undriven flags)."""
    r = _run(["scan", "--geno", "geno.csv", "--exclude-complements",
              "--pheno", "pheno.csv", "--trait", "1",
              "--assumption", "alt", "--precision", "exact64",
              "-o", "alt.csv"], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    meta = json.loads(r.stdout.strip().splitlines()[-1])
    assert 0.0 <= meta["h2_null"] <= 1.0
    lods = np.loadtxt(csv_data / "alt.csv", delimiter=",")
    assert lods.shape == (40,) and np.isfinite(lods).all()


def test_cli_bulkscan_trait_chunk_and_alt_grid(csv_data):
    """--trait-chunk (streaming path) must reproduce the unchunked result;
    alt-grid method must emit h2_panel."""
    r1 = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--precision", "fast32",
               "--trait-chunk", "4", "-o", "chunked.npz"], csv_data)
    assert r1.returncode == 0, r1.stderr[-500:]
    full = np.load(csv_data / "lods.npz")  # from test_cli_bulkscan
    chunked = np.load(csv_data / "chunked.npz")
    assert np.allclose(chunked["L"], full["L"], atol=1e-12)

    r2 = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--precision", "fast32",
               "--method", "alt-grid", "-o", "alt.npz"], csv_data)
    assert r2.returncode == 0, r2.stderr[-500:]
    z = np.load(csv_data / "alt.npz")
    assert z["L"].shape == (40, 6) and np.isfinite(z["L"]).all()
    assert z["h2_panel"].shape == (40, 6)


def test_cli_bulkscan_lowrank(csv_data):
    """--lowrank-k runs the rank-k engine end to end; a near-full rank must
    track the full-rank result closely."""
    r = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
              "--pheno", "pheno.csv", "--precision", "fast32",
              "--lowrank-k", "20", "-o", "lr.npz"], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    full = np.load(csv_data / "lods.npz")  # from test_cli_bulkscan
    lr = np.load(csv_data / "lr.npz")
    assert lr["L"].shape == full["L"].shape and np.isfinite(lr["L"]).all()
    # k=20 of n=30 strains: spectrum mostly covered (f32 engine tolerance)
    assert np.max(np.abs(lr["L"] - full["L"])) < 0.3
    # the rank-k engine now serves every method, not just null-grid
    r2 = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--precision", "fast32",
               "--method", "alt-grid", "--lowrank-k", "20",
               "-o", "lr_alt.npz"], csv_data)
    assert r2.returncode == 0, r2.stderr[-500:]
    z = np.load(csv_data / "lr_alt.npz")
    assert z["L"].shape == full["L"].shape and np.isfinite(z["L"]).all()
    assert "h2_panel" in z


def test_cli_kinship_precision_flag(csv_data):
    """kinship --precision exact64 produces an f64 kinship identical (to
    1e-12) to the fast32 one on this well-conditioned input."""
    r = _run(["kinship", "--geno", "geno.csv", "--exclude-complements",
              "--precision", "exact64", "-o", "K64.csv"], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    K64 = np.loadtxt(csv_data / "K64.csv", delimiter=",")
    K32 = np.loadtxt(csv_data / "K.csv", delimiter=",")  # from test_cli_kinship
    assert np.allclose(K64, K32, atol=1e-6)
    assert np.allclose(np.diag(K64), 1.0)


def test_cli_scan_effects(csv_data):
    r = _run(["scan", "--geno", "geno.csv", "--exclude-complements",
              "--pheno", "pheno.csv", "--trait", "1", "--effects",
              "-o", "eff.npz"], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    out = np.load(csv_data / "eff.npz")
    assert out["beta"].shape == out["lod"].shape == out["beta_se"].shape
    assert np.all(out["beta_se"] > 0)
    # Wald and LOD rank markers identically (same partial correlation)
    t = np.abs(out["beta"] / out["beta_se"])
    assert np.argmax(t) == np.argmax(out["lod"])


def test_cli_bulkscan_effects(csv_data):
    r = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
              "--pheno", "pheno.csv", "--effects", "-o", "beff.npz"],
             csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    out = np.load(csv_data / "beff.npz")
    assert out["beta"].shape == out["L"].shape == out["beta_se"].shape


def test_cli_loco(csv_data):
    # marker map covering the 40 post-exclusion markers, 2 chromosomes
    with open(csv_data / "gmap.csv", "w") as f:
        f.write("Locus,Chr,cM,Mb\n")
        for i in range(40):
            f.write(f"m{i},{1 if i < 22 else 2},{i * 1.0},{i * 0.5}\n")
    r = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
              "--pheno", "pheno.csv", "--loco", "--gmap", "gmap.csv",
              "-o", "loco.npz"], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    out = np.load(csv_data / "loco.npz")
    assert out["L"].shape == (40, 6)
    r2 = _run(["scan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--loco", "--gmap", "gmap.csv",
               "--trait", "0", "-o", "loco_scan.npz"], csv_data)
    assert r2.returncode == 0, r2.stderr[-500:]
    meta = json.loads(r2.stdout.strip().splitlines()[-1])
    assert "h2_null" in meta
    # --loco without --gmap fails with a clear message
    r3 = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--loco", "-o", "x.npz"], csv_data)
    assert r3.returncode != 0 and "--gmap" in (r3.stderr + r3.stdout)


def test_cli_bulkscan_with_perm_thresholds(csv_data):
    r = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
              "--pheno", "pheno.csv", "--nperms", "32", "--seed", "4",
              "-o", "bulk_perm.npz"], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    z = np.load(csv_data / "bulk_perm.npz")
    assert z["perm_maxlods"].shape == (6, 33)
    assert z["thresholds"].shape == (3, 6)
    assert z["log10_adj_pvals"].shape == (6,)
    # observed column consistent with the scan's own LOD matrix
    assert np.allclose(z["perm_maxlods"][:, 0], z["L"].max(axis=0), atol=1e-4)
    # LOCO + perms: stitched per-chromosome maxima (bulkscan_perms_loco)
    with open(csv_data / "gmap.csv", "w") as f:
        f.write("Locus,Chr,cM,Mb\n")
        for i in range(40):
            f.write(f"m{i},{1 if i < 22 else 2},{i * 1.0},{i * 0.5}\n")
    r2 = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--nperms", "8", "--loco",
               "--gmap", "gmap.csv", "-o", "bulk_perm_loco.npz"], csv_data)
    assert r2.returncode == 0, r2.stderr[-500:]
    z2 = np.load(csv_data / "bulk_perm_loco.npz")
    assert z2["perm_maxlods"].shape == (6, 9)
    assert z2["thresholds"].shape == (3, 6)
    # lowrank + perms: rank-k Woodbury whitening engine
    r3 = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--nperms", "8", "--lowrank-k", "8",
               "-o", "bulk_perm_lr.npz"], csv_data)
    assert r3.returncode == 0, r3.stderr[-500:]
    z3 = np.load(csv_data / "bulk_perm_lr.npz")
    assert z3["perm_maxlods"].shape == (6, 9)
    assert np.allclose(z3["perm_maxlods"][:, 0], z3["L"].max(axis=0), atol=1e-4)
    # loco + lowrank + perms: rank-k leave-out kinships, stitched maxima
    r4 = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--nperms", "8", "--loco",
               "--lowrank-k", "8", "--gmap", "gmap.csv",
               "-o", "bulk_perm_loco_lr.npz"], csv_data)
    assert r4.returncode == 0, r4.stderr[-500:]
    z4 = np.load(csv_data / "bulk_perm_loco_lr.npz")
    assert z4["perm_maxlods"].shape == (6, 9)
    assert np.isfinite(z4["perm_maxlods"]).all()


def test_cli_scan_and_kinship_lowrank(csv_data):
    # rank-k kinship factors (no n x n matrix): U/lam npz
    r = _run(["kinship", "--geno", "geno.csv", "--exclude-complements",
              "--lowrank-k", "8", "-o", "K_lr.npz"], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    z = np.load(csv_data / "K_lr.npz")
    assert z["U"].shape == (30, 8) and z["lam"].shape == (8,)
    # CSV output for factors is rejected with a clear message
    r2 = _run(["kinship", "--geno", "geno.csv", "--exclude-complements",
               "--lowrank-k", "8", "-o", "K_lr.csv"], csv_data)
    assert r2.returncode != 0 and ".npz" in (r2.stderr + r2.stdout)
    # single-trait scan on the rank-k engine, with permutations
    r3 = _run(["scan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--trait", "1", "--lowrank-k", "8",
               "--nperms", "24", "-o", "scan_lr.npz"], csv_data)
    assert r3.returncode == 0, r3.stderr[-500:]
    meta = json.loads(r3.stdout.strip().splitlines()[-1])
    assert "thresholds" in meta and np.isfinite(meta["h2_null"])
    out = np.load(csv_data / "scan_lr.npz")
    assert out["lod"].shape == (40,) and np.isfinite(out["lod"]).all()


def test_cli_kinship_reuse_and_output_guard(csv_data):
    # self-sufficient: generate this test's own kinship artifacts (no
    # dependence on other tests' outputs / execution order)
    r0 = _run(["kinship", "--geno", "geno.csv", "--exclude-complements",
               "-o", "K_reuse.csv"], csv_data)
    assert r0.returncode == 0, r0.stderr[-500:]
    r0b = _run(["kinship", "--geno", "geno.csv", "--exclude-complements",
                "--lowrank-k", "8", "-o", "K_reuse_lr.npz"], csv_data)
    assert r0b.returncode == 0, r0b.stderr[-500:]
    rf = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--precision", "fast32",
               "-o", "full_reuse.npz"], csv_data)
    assert rf.returncode == 0, rf.stderr[-500:]
    # bulkscan refuses a non-.npz output with a clear message
    r = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
              "--pheno", "pheno.csv", "-o", "lods_bad.csv"], csv_data)
    assert r.returncode != 0 and ".npz" in (r.stderr + r.stdout)
    # precomputed dense kinship (kinship subcommand CSV) feeds bulkscan
    r2 = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--precision", "fast32",
               "--kinship", "K_reuse.csv", "-o", "reuse.npz"], csv_data)
    assert r2.returncode == 0, r2.stderr[-500:]
    full = np.load(csv_data / "full_reuse.npz")
    reuse = np.load(csv_data / "reuse.npz")
    assert np.allclose(reuse["L"], full["L"], atol=1e-5)
    # rank-k factor file (kinship --lowrank-k) feeds scan
    r3 = _run(["scan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--trait", "0",
               "--kinship", "K_reuse_lr.npz", "-o", "scan_klr.npz"], csv_data)
    assert r3.returncode == 0, r3.stderr[-500:]
    z = np.load(csv_data / "scan_klr.npz")
    assert np.isfinite(z["lod"]).all()
    # silent-conflict guards: --loco + --kinship is rejected
    r4 = _run(["scan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--trait", "0", "--loco",
               "--gmap", "gmap.csv", "--kinship", "K_reuse.csv",
               "-o", "x.npz"], csv_data)
    assert r4.returncode != 0 and "--kinship" in (r4.stderr + r4.stdout)


def test_cli_bulkscan_sharded_and_streamed(csv_data):
    """--sharded runs on a mesh over the subprocess's virtual devices;
    --stream-markers streams host blocks; both must match the plain engine
   ."""
    base = ["bulkscan", "--geno", "geno.csv", "--exclude-complements",
            "--pheno", "pheno.csv", "--precision", "fast32"]
    r0 = _run(base + ["-o", "plain.npz"], csv_data)
    assert r0.returncode == 0, r0.stderr[-500:]
    r1 = _run(base + ["--sharded", "--marker-shards", "2", "-o", "shard.npz"],
              csv_data)
    assert r1.returncode == 0, r1.stderr[-500:]
    r2 = _run(base + ["--stream-markers", "16", "-o", "stream.npz"], csv_data)
    assert r2.returncode == 0, r2.stderr[-500:]
    r3 = _run(base + ["--sharded", "--stream-markers", "16",
                      "-o", "both.npz"], csv_data)
    assert r3.returncode == 0, r3.stderr[-500:]
    L0 = np.load(csv_data / "plain.npz")["L"]
    for f in ("shard.npz", "stream.npz", "both.npz"):
        L = np.load(csv_data / f)["L"]
        assert L.shape == L0.shape
        assert np.max(np.abs(L - L0)) < 1e-4, f  # fast32


def test_cli_bulkscan_sharded_perms(csv_data):
    r = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
              "--pheno", "pheno.csv", "--precision", "fast32",
              "--sharded", "--nperms", "24", "-o", "sp.npz"], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    z = np.load(csv_data / "sp.npz")
    assert z["perm_maxlods"].shape == (6, 25)
    assert z["thresholds"].shape == (3, 6)


def test_cli_bulkscan_streamed_sharded_perms(csv_data):
    """--nperms composes with --stream-markers AND --sharded: per-block
    sharded chunk cores, mesh running-max tiles; maxima must match the
    in-memory sharded sweep."""
    base = ["bulkscan", "--geno", "geno.csv", "--exclude-complements",
            "--pheno", "pheno.csv", "--precision", "fast32",
            "--nperms", "24", "--seed", "3"]
    r0 = _run(base + ["-o", "pp.npz"], csv_data)
    assert r0.returncode == 0, r0.stderr[-500:]
    r = _run(base + ["--stream-markers", "16", "--sharded",
                     "--marker-shards", "2", "-o", "ssp.npz"], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    a = np.load(csv_data / "pp.npz")["perm_maxlods"]
    b = np.load(csv_data / "ssp.npz")["perm_maxlods"]
    assert b.shape == a.shape == (6, 25)
    assert np.max(np.abs(a - b)) < 1e-4  # fast32
    # streamed-only perms with --resume + --checkpoint-every now supported
    r2 = _run(base + ["--stream-markers", "16", "--resume", "ckdir",
                      "--checkpoint-every", "2", "-o", "rp.npz"], csv_data)
    assert r2.returncode == 0, r2.stderr[-500:]
    c = np.load(csv_data / "rp.npz")["perm_maxlods"]
    assert np.max(np.abs(a - c)) < 1e-4


def test_cli_checkpoint_every_requires_streaming(csv_data):
    """--checkpoint-every without --stream-markers would be silently
    ignored by the in-memory engines; fail fast BEFORE any compute
    (code-review r4)."""
    r = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
              "--pheno", "pheno.csv", "--nperms", "8", "--resume", "ckd",
              "--checkpoint-every", "4", "-o", "x.npz"], csv_data)
    assert r.returncode != 0
    assert "stream-markers" in (r.stderr + r.stdout)


def test_cli_podscan_single_process_and_merge(csv_data, tmp_path):
    """podscan without --coordinator is a one-process pod; merge-shards
    assembles its shard file into the final .npz."""
    shards = tmp_path / "shards"
    r = _run(["podscan", "--geno", str(csv_data / "geno.csv"),
              "--exclude-complements", "--pheno", str(csv_data / "pheno.csv"),
              "--precision", "fast32", "--save-shards", str(shards),
              "-o", str(tmp_path / "pod.npz")], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    meta = json.loads(r.stdout.strip().splitlines()[-1])
    assert meta["pid"] == 0 and meta["traits"] == [0, 6]
    rm = _run(["merge-shards", "--shards-dir", str(shards),
               "-o", str(tmp_path / "merged.npz")], csv_data)
    assert rm.returncode == 0, rm.stderr[-500:]
    L = np.load(tmp_path / "merged.npz")["L"]
    r0 = _run(["bulkscan", "--geno", "geno.csv", "--exclude-complements",
               "--pheno", "pheno.csv", "--precision", "fast32",
               "-o", "ref.npz"], csv_data)
    assert r0.returncode == 0
    L0 = np.load(csv_data / "ref.npz")["L"]
    assert np.max(np.abs(L - L0)) < 1e-4


def test_cli_podscan_two_processes(csv_data, tmp_path):
    """A real 2-process pod launch through the CLI: shared coordinator,
    per-process shards, offline merge (incl. the perms path)."""
    import socket

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    shards = tmp_path / "shards"
    coord = f"127.0.0.1:{free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "bulklmm_tpu", "podscan",
             "--geno", str(csv_data / "geno.csv"), "--exclude-complements",
             "--pheno", str(csv_data / "pheno.csv"), "--precision", "fast32",
             "--coordinator", coord, "--nproc", "2", "--pid", str(i),
             "--nperms", "16", "--seed", "3",
             "--save-shards", str(shards), "-o", str(tmp_path / "pod.npz")],
            env=env, cwd=csv_data,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pod process {i} failed:\n{out[-2000:]}"
    assert len(list(shards.glob("perm_shard_*.npz"))) == 2
    rm = _run(["merge-shards", "--perms", "--shards-dir", str(shards),
               "-o", str(tmp_path / "perms.npz")], csv_data)
    assert rm.returncode == 0, rm.stderr[-500:]
    z = np.load(tmp_path / "perms.npz")
    assert z["perm_maxlods"].shape == (6, 17)
    assert z["thresholds"].shape == (3, 6)


def test_cli_bulkscan_perms_resume(csv_data, tmp_path):
    """--resume DIR: a second identical invocation resumes from the chunk
    files and produces identical thresholds."""
    ck = tmp_path / "ck"
    args = ["bulkscan", "--geno", "geno.csv", "--exclude-complements",
            "--pheno", "pheno.csv", "--precision", "fast32",
            "--nperms", "20", "--trait-chunk", "2",
            "--resume", str(ck)]
    r1 = _run(args + ["-o", "a.npz"], csv_data)
    assert r1.returncode == 0, r1.stderr[-500:]
    assert len(list(ck.glob("maxlods_*.npy"))) == 3
    r2 = _run(args + ["-o", "b.npz"], csv_data)
    assert r2.returncode == 0, r2.stderr[-500:]
    a = np.load(csv_data / "a.npz")
    b = np.load(csv_data / "b.npz")
    np.testing.assert_array_equal(a["perm_maxlods"], b["perm_maxlods"])


def test_cli_loco_sharded(csv_data):
    """--loco --sharded runs per-chromosome scans on the mesh and matches
    the single-device LOCO output."""
    with open(csv_data / "gmap2.csv", "w") as f:
        f.write("Locus,Chr,cM,Mb\n")
        for i in range(40):
            f.write(f"m{i},{1 if i < 22 else 2},{i * 1.0},{i * 0.5}\n")
    base = ["bulkscan", "--geno", "geno.csv", "--exclude-complements",
            "--pheno", "pheno.csv", "--loco", "--gmap", "gmap2.csv",
            "--precision", "fast32"]
    r1 = _run(base + ["--sharded", "--nperms", "12",
                      "-o", "loco_sh.npz"], csv_data)
    assert r1.returncode == 0, r1.stderr[-500:]
    r2 = _run(base + ["--nperms", "12", "-o", "loco_sd.npz"], csv_data)
    assert r2.returncode == 0, r2.stderr[-500:]
    a = np.load(csv_data / "loco_sh.npz")
    b = np.load(csv_data / "loco_sd.npz")
    assert np.max(np.abs(a["L"] - b["L"])) < 1e-4
    np.testing.assert_allclose(
        a["perm_maxlods"], b["perm_maxlods"], atol=1e-4
    )
    # --loco with --stream-markers stays refused with a clear message
    r3 = _run(base + ["--stream-markers", "16", "-o", "x.npz"], csv_data)
    assert r3.returncode != 0 and "stream" in (r3.stderr + r3.stdout)


def test_cli_podscan_lowrank_and_loco_guard(csv_data, tmp_path):
    shards = tmp_path / "s"
    r = _run(["podscan", "--geno", str(csv_data / "geno.csv"),
              "--exclude-complements", "--pheno", str(csv_data / "pheno.csv"),
              "--precision", "fast32", "--lowrank-k", "8",
              "--save-shards", str(shards),
              "-o", str(tmp_path / "o.npz")], csv_data)
    assert r.returncode == 0, r.stderr[-500:]
    # rank-k pod shard must agree with the rank-k bulkscan
    rm = _run(["merge-shards", "--shards-dir", str(shards),
               "-o", str(tmp_path / "m.npz")], csv_data)
    assert rm.returncode == 0, rm.stderr[-500:]
    L = np.load(tmp_path / "m.npz")["L"]
    assert L.shape == (40, 6) and np.isfinite(L).all()
    r2 = _run(["podscan", "--geno", str(csv_data / "geno.csv"),
               "--exclude-complements", "--pheno", str(csv_data / "pheno.csv"),
               "--loco", "-o", str(tmp_path / "o2.npz")], csv_data)
    assert r2.returncode != 0 and "podscan" in (r2.stderr + r2.stdout)


def test_cli_checkpoint_every_requires_perms_and_resume(csv_data):
    """--checkpoint-every with --stream-markers but nperms == 0, or without
    --resume, was silently ignored; both now fail fast (ADVICE r4)."""
    base = ["bulkscan", "--geno", "geno.csv", "--exclude-complements",
            "--pheno", "pheno.csv", "--stream-markers", "16",
            "--checkpoint-every", "2", "-o", "x.npz"]
    r = _run(base, csv_data)  # no --nperms
    assert r.returncode != 0
    assert "nperms" in (r.stderr + r.stdout)
    r = _run(base + ["--nperms", "8"], csv_data)  # no --resume
    assert r.returncode != 0
    assert "resume" in (r.stderr + r.stdout)
