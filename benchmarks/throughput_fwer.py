"""Measure the THROUGHPUT-tier FWER-validity claim on one GPU.

The screening tier's claim is that its LOD error is far below the
Monte-Carlo error of permutation threshold quantiles; this script
MEASURES it on the card:

  for >= 10 seeds: BALANCED and THROUGHPUT thresholds for a BXD-scale
  trait panel at nperms=1000, alpha in {0.25, 0.10, 0.05, 0.01, 0.002};
  report the paired same-seed |Delta threshold| between tiers against the
  across-seed MC spread of the BALANCED thresholds.

The claim holds at a given alpha when the tier disagreement is a small
fraction of the seed-to-seed spread a user already accepts by picking any
one seed. alpha=0.002 (2 exceedances in 1000) probes where it stops
holding. Also emits the PER-ENGINE THROUGHPUT accuracy table (weak item
3): max |Delta LOD| vs the CPU-f64 golden for every major engine at
--precision throughput.

Run: python benchmarks/throughput_fwer.py [--out PATH]
Prints the card and a summary table (``--out`` also writes it as JSON).
The CPU-f64 goldens come from a child process that stays off the card.
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

ALPHAS = [0.25, 0.10, 0.05, 0.01, 0.002]
NSEEDS = 10
NPERMS = 1000

ENGINE_CHILD = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, sys.argv[3])
import bulklmm_tpu as bl
data = np.load(sys.argv[1])
Y, G, K = data["Y"], data["G"], data["K"]
y = Y[:, 0]
out = {}
out["scan_null"] = np.asarray(bl.scan(y, G, K).lod)
out["scan_alt"] = np.asarray(bl.scan(y, G, K, assumption="alt").lod)
out["bulk_null_grid"] = np.asarray(bl.bulkscan(Y, G, K).L)
out["bulk_null_exact"] = np.asarray(bl.bulkscan(Y, G, K, method="null-exact").L)
out["bulk_alt_grid"] = np.asarray(bl.bulkscan(Y, G, K, method="alt-grid").L)
out["bulk_perms"] = np.asarray(bl.bulkscan_perms(Y, G, K, nperms=200, rndseed=3).maxlods)
out["streamed"] = np.asarray(bl.bulkscan_streamed(Y, G, K, marker_block=100).L)
lr = bl.kinship_lowrank_exact(K, 32)
out["lowrank_trunc"] = np.asarray(bl.bulkscan(Y, G, bl.LowRankKinship(
    U=np.asarray(lr.U), lam=np.asarray(lr.lam))).L)
np.savez(sys.argv[2], **out)
print("cpu goldens done")
"""


def synth(n=79, p=7321, m=256, seed=2026):
    rng = np.random.default_rng(seed)
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
    return G, K, Y


def fwer_measurement(G, K, Y):
    import bulklmm_tpu as bl
    from bulklmm_tpu.utils.config import BALANCED, THROUGHPUT

    thrs = {"balanced": [], "throughput": []}
    for seed in range(NSEEDS):
        for tier, prec in (("balanced", BALANCED),
                           ("throughput", THROUGHPUT)):
            bp = bl.bulkscan_perms(
                Y, G, K, nperms=NPERMS, rndseed=seed, precision=prec
            )
            t = bl.get_thresholds_bulk(bp.perm_maxima, ALPHAS)
            thrs[tier].append(np.asarray(t.thrs))  # (len(ALPHAS), m)
        print(f"seed {seed} done", flush=True)
    bal = np.stack(thrs["balanced"])    # (seeds, alphas, m)
    thr = np.stack(thrs["throughput"])
    rows = []
    for ai, alpha in enumerate(ALPHAS):
        delta = np.abs(bal[:, ai] - thr[:, ai])       # paired same-seed
        mc = bal[:, ai].std(axis=0, ddof=1)           # across-seed spread
        rows.append({
            "alpha": alpha,
            "tier_delta_mean": float(delta.mean()),
            "tier_delta_p99": float(np.quantile(delta, 0.99)),
            "tier_delta_max": float(delta.max()),
            "mc_spread_mean": float(mc.mean()),
            "mc_spread_min": float(mc.min()),
            "delta_over_spread_mean": float((delta.mean(axis=0) / mc).mean()),
            "delta_over_spread_max": float((delta.mean(axis=0) / mc).max()),
        })
    return rows


def engine_accuracy_table(G, K, Y):
    """Per-engine THROUGHPUT max |dLOD| vs CPU-f64 goldens (smaller p for
    the expensive exact paths)."""
    import bulklmm_tpu as bl
    from bulklmm_tpu.utils.config import THROUGHPUT

    n, m = 79, 64
    p = 512
    Gs, Ks, Ys = synth(n=n, p=p, m=m, seed=5)
    tmp = Path(tempfile.mkdtemp())
    np.savez(tmp / "d.npz", Y=Ys, G=Gs, K=Ks)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", ENGINE_CHILD, str(tmp / "d.npz"),
         str(tmp / "gold.npz"),
         str(Path(__file__).resolve().parent.parent)],
        env=env, capture_output=True, text=True, timeout=1200,
    )
    if r.returncode != 0:
        print(r.stderr[-1500:])
        raise SystemExit("golden generation failed")
    gold = np.load(tmp / "gold.npz")

    y = Ys[:, 0]
    lr = bl.kinship_lowrank_exact(Ks, 32)
    lr = bl.LowRankKinship(U=np.asarray(lr.U), lam=np.asarray(lr.lam))
    runs = {
        "scan_null": lambda P: bl.scan(y, Gs, Ks, precision=P).lod,
        "scan_alt": lambda P: bl.scan(y, Gs, Ks, assumption="alt",
                                      precision=P).lod,
        "bulk_null_grid": lambda P: bl.bulkscan(Ys, Gs, Ks, precision=P).L,
        "bulk_null_exact": lambda P: bl.bulkscan(
            Ys, Gs, Ks, method="null-exact", precision=P).L,
        "bulk_alt_grid": lambda P: bl.bulkscan(
            Ys, Gs, Ks, method="alt-grid", precision=P).L,
        "bulk_perms": lambda P: bl.bulkscan_perms(
            Ys, Gs, Ks, nperms=200, rndseed=3, precision=P).maxlods,
        "streamed": lambda P: bl.bulkscan_streamed(
            Ys, Gs, Ks, marker_block=100, precision=P).L,
        "lowrank_trunc": lambda P: bl.bulkscan(Ys, Gs, lr, precision=P).L,
    }
    table = {}
    for name, f in runs.items():
        err = float(np.max(np.abs(np.asarray(f(THROUGHPUT))
                                  - gold[name])))
        table[name] = err
        print(json.dumps({"engine": name, "throughput_max_abs_err": err}),
              flush=True)
    return table


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as one JSON file")
    args = ap.parse_args()
    import jax

    from bench import card_line, require_gpus
    from bulklmm_tpu.utils.cache import use_compile_cache

    use_compile_cache()
    jax.config.update("jax_enable_x64", True)
    require_gpus(1)
    print(f"# card: {card_line()}", flush=True)

    G, K, Y = synth()
    print(f"FWER measurement: m={Y.shape[1]} traits x {G.shape[1]} "
          f"markers, nperms={NPERMS}, {NSEEDS} seeds, "
          f"alphas={ALPHAS}", flush=True)
    rows = fwer_measurement(G, K, Y)
    for r in rows:
        print(json.dumps(r))
    table = engine_accuracy_table(G, K, Y)
    out = {"fwer": rows, "engine_throughput_err": table,
           "config": {"n": G.shape[0], "p": G.shape[1], "m": Y.shape[1],
                      "nperms": NPERMS, "nseeds": NSEEDS,
                      "alphas": ALPHAS}}
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=2) + "\n")


if __name__ == "__main__":
    main()
