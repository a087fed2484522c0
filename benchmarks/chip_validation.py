"""Cross-backend validation sweep: every public scan path on a GPU vs the
same library on CPU float64 (which the test suite ties to the
independent scipy oracle).

Run on a GPU host:   python benchmarks/chip_validation.py
It spawns a CPU-f64 subprocess for the goldens, then the on-card
subprocesses (CLI runs, a checkpointed sweep killed mid-way) BEFORE this
process opens the card — a JAX process reserves most of the card's memory,
so a second one started later would fail — and then runs the GPU side in
BALANCED precision in-process, printing one PASS/FAIL line per path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# The cross-backend bar is 2e-5 per path (the host null fit, ops/hostfit.py,
# makes h2 backend-deterministic). The sweep covers every public engine —
# rank-k (k = n exactness AND matched-k truncation vs a matched-k CPU-f64
# golden, incl. Woodbury perm whitening), streamed (+ perms), LOCO
# (single + bulk), output_effects beta/SE, thresholds + adjusted p-values.
TOL = {
    "scan_null": 2e-5,
    "scan_reml": 2e-5,
    "scan_covar": 2e-5,
    "scan_weights": 2e-5,
    "scan_alt": 2e-5,
    "perms": 2e-5,
    "bulk_null_grid": 2e-5,
    "bulk_null_exact": 2e-5,
    "bulk_alt_grid": 2e-5,
    "bulk_perms": 2e-5,
    "lowrank_k_eq_n": 2e-5,
    "lowrank_trunc": 2e-5,
    "lowrank_scan": 2e-5,
    "lowrank_scan_perms": 2e-5,
    "lowrank_bulk_perms": 2e-5,
    "streamed": 2e-5,
    "streamed_perms": 2e-5,
    "loco_scan": 2e-5,
    "loco_bulk": 2e-5,
    "effects_beta": 2e-5,
    "effects_beta_se": 2e-5,
    "scan_effects_beta": 2e-5,
    "thresholds_bulk": 2e-5,
    "adj_pvals": 2e-5,
    # the rest of the public surface
    "scan_svd": 2e-5,
    # same device kernels as bulk_null_grid (9.7e-6 there); the svd
    # scheme's DESCENDING singular-value basis reorders the f32 GEMM
    # summations — a rounding-order artifact, not an algorithmic
    # difference (the host-f64 factors are identical bits on both sides)
    "bulk_svd": 3e-5,
    "compat_sqrt_weights": 2e-5,
    # log-LIKELIHOOD values (not LODs): O(n)-scale sums whose BALANCED
    # error budget is the same relative one — 2e-5 LOD x ln10 x the
    # ~|ll| magnitude; 1e-3 absolute is the equivalent bar here
    "profile_ll_null": 1e-3,
    "profile_ll_alt": 1e-3,
    "getll": 1e-3,
    "bulk_perms_loco": 2e-5,
    "missing_mask": 2e-5,
    "missing_drop": 2e-5,
    # FDR q-values are monotone transforms of p-values near 1e-2..1:
    # a 2e-5 LOD error maps to ~1e-4-scale q shifts through the chi2 cdf
    "lod_fdr_q": 5e-4,
    "bh_adjust": 5e-4,
    "streamed_memmap": 2e-5,
    "resume_on_chip": 1e-9,   # card vs card: resumed == uninterrupted
    "cli_kinship": 2e-5,
    "cli_scan": 2e-5,
    "cli_bulkscan": 2e-5,
    "cli_bulkscan_perms": 2e-5,
}

CHILD = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, sys.argv[3])
import bulklmm_tpu as bl

data = np.load(sys.argv[1])
Y, G, K, w, covar = data["Y"], data["G"], data["K"], data["w"], data["covar"]
chrom = data["chrom"]
y = Y[:, 0]
out = {}
out["scan_null"] = np.asarray(bl.scan(y, G, K).lod)
out["scan_reml"] = np.asarray(bl.scan(y, G, K, reml=True).lod)
out["scan_covar"] = np.asarray(bl.scan(y, G, K, covar=covar).lod)
out["scan_weights"] = np.asarray(bl.scan(y, G, K, weights=w).lod)
out["scan_alt"] = np.asarray(bl.scan(y, G, K, assumption="alt").lod)
out["perms"] = np.asarray(
    bl.scan(y, G, K, permutation_test=True, nperms=100, rndseed=7).L_perms
)
out["bulk_null_grid"] = np.asarray(bl.bulkscan(Y, G, K).L)
out["bulk_null_exact"] = np.asarray(bl.bulkscan(Y, G, K, method="null-exact").L)
out["bulk_alt_grid"] = np.asarray(bl.bulkscan(Y, G, K, method="alt-grid").L)
bp = bl.bulkscan_perms(Y, G, K, nperms=100, rndseed=7)
out["bulk_perms"] = np.asarray(bp.maxlods)

# rank-k: matched-k truncation golden (SAME deterministic eigenpairs as the
# GPU side — both built from the shared U/lam in the npz)
import jax.numpy as jnp
lr = bl.LowRankKinship(U=jnp.asarray(data["lrU"]), lam=jnp.asarray(data["lrlam"]))
out["lowrank_trunc"] = np.asarray(bl.bulkscan(Y, G, lr).L)
out["lowrank_scan"] = np.asarray(bl.scan(y, G, lr).lod)
out["lowrank_scan_perms"] = np.asarray(
    bl.scan(y, G, lr, permutation_test=True, nperms=100, rndseed=7).L_perms
)
out["lowrank_bulk_perms"] = np.asarray(
    bl.bulkscan_perms(Y, G, lr, nperms=100, rndseed=7).maxlods
)

# LOCO (per-chromosome leave-out kinships from the same G)
out["loco_scan"] = np.asarray(bl.scan_loco(y, G, chrom).lod)
out["loco_bulk"] = np.asarray(bl.bulkscan_loco(Y, G, chrom).L)

# GLS marker effects + Wald SEs
eb = bl.bulkscan(Y, G, K, output_effects=True)
out["effects_beta"] = np.asarray(eb.beta_mat)
out["effects_beta_se"] = np.asarray(eb.beta_se_mat)
out["scan_effects_beta"] = np.asarray(bl.scan(y, G, K, output_effects=True).beta)

# analysis layer on the perm maxima
thr = bl.get_thresholds_bulk(bp.perm_maxima, [0.10, 0.05, 0.01])
out["thresholds_bulk"] = np.asarray(thr.thrs)
out["adj_pvals"] = np.asarray(bp.log10_adj_pvals)

# round-5 surface extension
out["scan_svd"] = np.asarray(bl.scan(y, G, K, decomp_scheme="svd").lod)
out["bulk_svd"] = np.asarray(bl.bulkscan(Y, G, K, decomp_scheme="svd").L)
out["compat_sqrt_weights"] = np.asarray(
    bl.scan(y, G, K, weights=w, assumption="alt",
            compat_sqrt_weights=True).lod
)
ones = np.ones((Y.shape[0], 1))
prof = bl.profile_LL(y, G, ones, K, np.arange(0.05, 0.95, 0.05), 10)
out["profile_ll_null"] = np.asarray(prof.ll_list_null)
out["profile_ll_alt"] = np.asarray(prof.ll_list_alt)
from bulklmm_tpu.ops.rotation import kinship_eigen
Ut, lam = kinship_eigen(K)
y0 = Ut @ y
X0 = Ut @ np.column_stack([ones, G])
out["getll"] = np.asarray(bl.getLL(y0, X0, lam, 1, 10, 0.5))
out["bulk_perms_loco"] = np.asarray(
    bl.bulkscan_perms_loco(Y, G, chrom, nperms=50, rndseed=7).maxlods
)
out["missing_mask"] = np.asarray(bl.bulkscan(data["Ym"], G, K, missing="mask").L)
out["missing_drop"] = np.asarray(bl.bulkscan(data["Ym"], G, K, missing="drop").L)
out["lod_fdr_q"] = bl.lod_fdr(out["bulk_null_grid"])[0]
out["bh_adjust"] = bl.bh_adjust(bl.lod2p(out["bulk_null_grid"], 1))
np.savez(sys.argv[2], **out)
print("cpu goldens done")
"""


_RESUME_KW = dict(nperms=1000, rndseed=7, trait_chunk=2)


def _kill_mid_sweep(tmp, m):
    """Kill-and-resume, first half: a subprocess on the card runs a
    checkpointed BALANCED sweep and is SIGKILLed after its first chunk
    publishes, leaving a torn checkpoint in ``tmp / "ck"``. Runs before
    this process opens the card. Returns whether the kill landed
    mid-sweep."""
    import signal
    import time as _t

    script = (
        "import numpy as np, jax\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "import sys\n"
        f"sys.path.insert(0, r'{Path(__file__).resolve().parent.parent}')\n"
        "import bulklmm_tpu as bl\n"
        "from bulklmm_tpu.utils.config import BALANCED\n"
        f"z = np.load(r'{tmp / 'data.npz'}')\n"
        "bl.bulkscan_perms(z['Y'], z['G'], z['K'], precision=BALANCED,\n"
        f"                  checkpoint=r'{tmp / 'ck'}', **{_RESUME_KW!r})\n"
    )
    ck = tmp / "ck"
    for attempt in range(3):
        if ck.exists():
            for f in ck.iterdir():
                f.unlink()
            ck.rmdir()
        proc = subprocess.Popen(
            [sys.executable, "-c", script], env=dict(os.environ),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        deadline = _t.time() + 300
        try:
            while _t.time() < deadline:
                if len(list(ck.glob("maxlods_*.npy"))) >= 1:
                    break
                if proc.poll() is not None:
                    break
                _t.sleep(0.005)
            if proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
        finally:
            proc.wait(timeout=120)
        n_chunks = len(list(ck.glob("maxlods_*.npy")))
        if 1 <= n_chunks < -(-m // _RESUME_KW["trait_chunk"]):
            return True
    return False


def _resume_diff(tmp, Y, G, K):
    """Kill-and-resume, second half (in-process, on the card): resume from
    the torn checkpoint; the result must equal this process's own
    uninterrupted same-config run. Returns the max |diff| as a 0-d array
    (compared against the 'SELF' key)."""
    import bulklmm_tpu as bl
    from bulklmm_tpu.utils.config import BALANCED

    ref = bl.bulkscan_perms(Y, G, K, precision=BALANCED, **_RESUME_KW)
    res = bl.bulkscan_perms(Y, G, K, precision=BALANCED,
                            checkpoint=str(tmp / "ck"), **_RESUME_KW)
    return np.float64(np.max(np.abs(
        np.asarray(res.maxlods) - np.asarray(ref.maxlods)
    )))


def _cli_runs(tmp, K):
    """End-to-end CLI subprocesses on the card (default BALANCED), one per
    major subcommand, compared against the CPU-f64 goldens. Runs before
    this process opens the card."""
    repo = Path(__file__).resolve().parent.parent
    data = np.load(tmp / "data.npz")
    np.savez(tmp / "g.npz", geno=data["G"])
    np.savez(tmp / "y.npz", pheno=data["Y"])
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")

    def run(args):
        r = subprocess.run(
            [sys.executable, "-m", "bulklmm_tpu"] + args, env=env,
            capture_output=True, text=True, timeout=1200, cwd=tmp,
        )
        if r.returncode != 0:
            raise SystemExit(
                f"CLI on the card failed: {args}\n{r.stderr[-1500:]}"
            )

    run(["kinship", "--geno", "g.npz", "-o", "Kcli.npz"])
    Kcli = np.load(tmp / "Kcli.npz")["kinship"]
    out = {"cli_kinship": (np.abs(Kcli - np.asarray(K)), "ZERO")}

    run(["scan", "--geno", "g.npz", "--pheno", "y.npz", "--trait", "0",
         "-o", "scan_cli.npz"])
    out["cli_scan"] = (np.load(tmp / "scan_cli.npz")["lod"], "scan_null")

    run(["bulkscan", "--geno", "g.npz", "--pheno", "y.npz",
         "--nperms", "100", "--seed", "7", "-o", "bulk_cli.npz"])
    z = np.load(tmp / "bulk_cli.npz")
    out["cli_bulkscan"] = (z["L"], "bulk_null_grid")
    out["cli_bulkscan_perms"] = (z["perm_maxlods"], "bulk_perms")
    return out


def main():
    from bench import probe_gpus

    platform, count = probe_gpus()
    if platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {count} {platform} device(s)")

    rng = np.random.default_rng(17)
    n, p, m = 79, 512, 64
    G = rng.uniform(0, 1, (n, p)).astype(np.float32)
    X = G.astype(np.float64) - 0.5
    K = 2 * X @ X.T / p + 0.5
    np.fill_diagonal(K, 1.0)
    Lc = np.linalg.cholesky(K + 1e-9 * np.eye(n))
    h2s = rng.uniform(0.1, 0.9, m)
    Y = (
        np.sqrt(h2s) * (Lc @ rng.normal(size=(n, m)))
        + np.sqrt(1 - h2s) * rng.normal(size=(n, m))
    ).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n)
    covar = rng.normal(size=(n, 2))
    chrom = np.repeat(np.arange(1, 9), p // 8)

    # deterministic matched-k eigenpairs shared by BOTH sides (host f64
    # eigh; k = 32 truncation — the fixed-k config,
    # validated against a matched-k golden, not against full rank)
    evals, evecs = np.linalg.eigh(K)
    order = np.argsort(evals)[::-1][:32]
    lrU = evecs[:, order]
    lrlam = np.maximum(evals[order], 0.0)

    # missing-phenotype fixture: two traits share a pattern, one has its
    # own (exercises grouping + stitching on both sides)
    Ym = Y.astype(np.float64).copy()
    Ym[2:7, 0] = np.nan
    Ym[2:7, 1] = np.nan
    Ym[11:14, 3] = np.nan

    tmp = Path(tempfile.mkdtemp())
    np.savez(tmp / "data.npz", Y=Y, G=G, K=K, w=w, covar=covar, chrom=chrom,
             lrU=lrU, lrlam=lrlam, Ym=Ym)

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", CHILD, str(tmp / "data.npz"), str(tmp / "gold.npz"),
         str(Path(__file__).resolve().parent.parent)],
        env=env, capture_output=True, text=True, timeout=1200,
    )
    if r.returncode != 0:
        print(r.stderr[-2000:])
        raise SystemExit("CPU golden generation failed")
    gold = np.load(tmp / "gold.npz")

    # on-card subprocesses first, while this process holds no card
    cli = _cli_runs(tmp, K)
    killed = _kill_mid_sweep(tmp, m)

    import jax
    import jax.numpy as jnp

    from bench import card_line
    from bulklmm_tpu.utils.cache import use_compile_cache

    use_compile_cache()
    jax.config.update("jax_enable_x64", True)
    import bulklmm_tpu as bl
    from bulklmm_tpu.utils.config import BALANCED

    print(f"# card: {card_line()}", flush=True)
    print(json.dumps({"path": "resume_on_chip.kill_landed_mid_sweep",
                      "value": killed}))
    y = Y[:, 0]
    results = {}
    results["scan_null"] = np.asarray(bl.scan(y, G, K, precision=BALANCED).lod)
    results["scan_reml"] = np.asarray(bl.scan(y, G, K, reml=True, precision=BALANCED).lod)
    results["scan_covar"] = np.asarray(bl.scan(y, G, K, covar=covar, precision=BALANCED).lod)
    results["scan_weights"] = np.asarray(bl.scan(y, G, K, weights=w, precision=BALANCED).lod)
    results["scan_alt"] = np.asarray(bl.scan(y, G, K, assumption="alt", precision=BALANCED).lod)
    results["perms"] = np.asarray(
        bl.scan(y, G, K, permutation_test=True, nperms=100, rndseed=7,
                precision=BALANCED).L_perms
    )
    results["bulk_null_grid"] = np.asarray(bl.bulkscan(Y, G, K, precision=BALANCED).L)
    results["bulk_null_exact"] = np.asarray(
        bl.bulkscan(Y, G, K, method="null-exact", precision=BALANCED).L
    )
    results["bulk_alt_grid"] = np.asarray(
        bl.bulkscan(Y, G, K, method="alt-grid", precision=BALANCED).L
    )
    bp = bl.bulkscan_perms(
        Y, G, K, nperms=100, rndseed=7, precision=BALANCED
    )  # auto -> fused Pallas kernel on a GPU
    results["bulk_perms"] = np.asarray(bp.maxlods)

    # rank-k engine: k = n is EXACT (full spectrum) so it must match the
    # full-rank golden; k = 32 matches the matched-k CPU-f64 golden
    lr_full = bl.kinship_lowrank_exact(K, n)
    results["lowrank_k_eq_n"] = (
        np.asarray(bl.bulkscan(Y, G, lr_full, precision=BALANCED).L),
        "bulk_null_grid",
    )
    lr = bl.LowRankKinship(U=jnp.asarray(lrU), lam=jnp.asarray(lrlam))
    results["lowrank_trunc"] = np.asarray(bl.bulkscan(Y, G, lr, precision=BALANCED).L)
    results["lowrank_scan"] = np.asarray(bl.scan(y, G, lr, precision=BALANCED).lod)
    results["lowrank_scan_perms"] = np.asarray(
        bl.scan(y, G, lr, permutation_test=True, nperms=100, rndseed=7,
                precision=BALANCED).L_perms
    )
    results["lowrank_bulk_perms"] = np.asarray(
        bl.bulkscan_perms(Y, G, lr, nperms=100, rndseed=7,
                          precision=BALANCED).maxlods
    )

    # streamed engines (double-buffered block pipeline; marker_block < p
    # forces real multi-block streaming), vs the in-HBM goldens
    results["streamed"] = (
        np.asarray(bl.bulkscan_streamed(Y, G, K, marker_block=100,
                                        precision=BALANCED).L),
        "bulk_null_grid",
    )
    results["streamed_perms"] = (
        np.asarray(bl.bulkscan_perms_streamed(
            Y, G, K, nperms=100, rndseed=7, marker_block=100,
            precision=BALANCED).maxlods),
        "bulk_perms",
    )

    # LOCO
    results["loco_scan"] = np.asarray(
        bl.scan_loco(y, G, chrom, precision=BALANCED).lod
    )
    results["loco_bulk"] = np.asarray(
        bl.bulkscan_loco(Y, G, chrom, precision=BALANCED).L
    )

    # GLS effects + Wald SEs
    eb = bl.bulkscan(Y, G, K, output_effects=True, precision=BALANCED)
    results["effects_beta"] = np.asarray(eb.beta_mat)
    results["effects_beta_se"] = np.asarray(eb.beta_se_mat)
    results["scan_effects_beta"] = np.asarray(
        bl.scan(y, G, K, output_effects=True, precision=BALANCED).beta
    )

    # analysis layer (type-7 quantile thresholds + genome-wide adjusted
    # p-values) on the GPU perm maxima
    thr = bl.get_thresholds_bulk(bp.perm_maxima, [0.10, 0.05, 0.01])
    results["thresholds_bulk"] = np.asarray(thr.thrs)
    results["adj_pvals"] = np.asarray(bp.log10_adj_pvals)

    results["scan_svd"] = np.asarray(
        bl.scan(y, G, K, decomp_scheme="svd", precision=BALANCED).lod
    )
    results["bulk_svd"] = np.asarray(
        bl.bulkscan(Y, G, K, decomp_scheme="svd", precision=BALANCED).L
    )
    results["compat_sqrt_weights"] = np.asarray(
        bl.scan(y, G, K, weights=w, assumption="alt",
                compat_sqrt_weights=True, precision=BALANCED).lod
    )
    ones = np.ones((n, 1))
    prof = bl.profile_LL(y, G, ones, K, np.arange(0.05, 0.95, 0.05), 10)
    results["profile_ll_null"] = np.asarray(prof.ll_list_null)
    results["profile_ll_alt"] = np.asarray(prof.ll_list_alt)
    from bulklmm_tpu.ops.rotation import kinship_eigen

    Ut_h, lam_h = kinship_eigen(K)
    results["getll"] = np.asarray(bl.getLL(
        jnp.asarray(Ut_h @ y), jnp.asarray(Ut_h @ np.column_stack([ones, G])),
        jnp.asarray(lam_h), 1, 10, 0.5,
    ))
    results["bulk_perms_loco"] = np.asarray(
        bl.bulkscan_perms_loco(Y, G, chrom, nperms=50, rndseed=7,
                               precision=BALANCED).maxlods
    )
    results["missing_mask"] = np.asarray(
        bl.bulkscan(Ym, G, K, missing="mask", precision=BALANCED).L
    )
    results["missing_drop"] = np.asarray(
        bl.bulkscan(Ym, G, K, missing="drop", precision=BALANCED).L
    )
    # FDR on DEVICE outputs: q-values computed from the GPU LOD matrix
    results["lod_fdr_q"] = bl.lod_fdr(results["bulk_null_grid"])[0]
    results["bh_adjust"] = bl.bh_adjust(
        bl.lod2p(results["bulk_null_grid"], 1)
    )

    # memmap-in / memmap-out streamed run (the production large-p flow)
    Gmm = np.memmap(tmp / "G.dat", dtype=np.float32, mode="w+", shape=G.shape)
    Gmm[:] = G
    Gmm.flush()
    Gro = np.memmap(tmp / "G.dat", dtype=np.float32, mode="r", shape=G.shape)
    Lmm = np.memmap(tmp / "L.dat", dtype=np.float64, mode="w+",
                    shape=(p, m))
    st = bl.bulkscan_streamed(Y, Gro, K, marker_block=100, out=Lmm,
                              precision=BALANCED)
    assert st.L is Lmm
    results["streamed_memmap"] = (np.asarray(Lmm), "bulk_null_grid")

    results["resume_on_chip"] = (_resume_diff(tmp, Y, G, K), "SELF")
    results.update(cli)

    ok = True
    for name, got in results.items():
        # a (array, golden_key) pair reuses another path's golden (e.g.
        # k = n rank-k and the streamed engines vs the in-HBM goldens)
        gold_key = name
        if isinstance(got, tuple):
            got, gold_key = got
        if gold_key == "SELF":      # precomputed card-vs-card diff
            err = float(got)
        elif gold_key == "ZERO":    # precomputed abs diffs
            err = float(np.max(got))
        else:
            err = float(np.max(np.abs(got - gold[gold_key])))
        passed = err <= TOL[name]
        ok &= passed
        line = json.dumps({"path": name, "max_abs_err": err,
                           "tol": TOL[name], "pass": passed})
        print(line)
    print("ALL PASS" if ok else "FAILURES PRESENT")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
