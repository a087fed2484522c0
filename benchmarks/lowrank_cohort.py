"""Large-n cohort benchmark: low-rank kinship engine vs the full-rank path.

The full-rank engines pay an O(n^3) HOST eigendecomposition plus an (n, n)
eigenvector upload per cohort — the n-axis wall (SURVEY.md "hard parts").
The low-rank engine (ops/lowrank.py) replaces both with device-side
randomized subspace iteration (GEMMs only) and runs the scan via rank-k
Woodbury corrections on unrotated data.

Run on a GPU host:
    python benchmarks/lowrank_cohort.py --n 20000 --p 50000 --m 2000 --k 2048 \
        --compare-full

Prints one JSON line per phase; --compare-full also reports the max
LOD deviation of the truncated engine vs the exact full-rank scan on the
same cohort (the honest accuracy bound for this spectrum).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--p", type=int, default=50000)
    ap.add_argument("--m", type=int, default=2000)
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--compare-full", action="store_true")
    ap.add_argument("--all-methods", action="store_true",
                    help="also time null-exact, alt-grid, and the rank-k "
                         "permutation scan")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import card_line, require_gpus
    from bulklmm_tpu.utils.cache import use_compile_cache

    use_compile_cache()
    require_gpus(1)
    print(f"# card: {card_line()}", flush=True)
    import bulklmm_tpu as bl

    n, p, m, k = args.n, args.p, args.m, args.k

    # cohort generated on device (no host->device upload in the timings);
    # a few ancestry directions give the kinship a structured spectrum
    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    F = jax.random.normal(k1, (n, 8), dtype=jnp.float32)
    load = jax.nn.sigmoid(
        0.5 * jnp.matmul(F, jax.random.normal(k2, (8, p), dtype=jnp.float32))
    )
    G = (jax.random.uniform(k3, (n, p), dtype=jnp.float32) < load).astype(jnp.float32)
    Y = jax.random.normal(k4, (n, m), dtype=jnp.float32)
    jax.block_until_ready((G, Y))

    def emit(metric, seconds, **extra):
        print(json.dumps({"metric": metric, "value": round(seconds, 4),
                          "unit": "s", **extra}), flush=True)

    # 1. low-rank constructor straight from genotypes (K never materialized).
    # First call includes one-time XLA compiles; the steady-state call is
    # the per-cohort cost.
    t0 = time.perf_counter()
    lr = bl.kinship_lowrank_from_geno(G, k)
    jax.block_until_ready(lr.lam)
    emit("lowrank_construct_first_incl_compile", time.perf_counter() - t0,
         note=f"n={n} p={p} k={k}")
    t0 = time.perf_counter()
    lr = bl.kinship_lowrank_from_geno(G, k)
    jax.block_until_ready(lr.lam)
    emit("lowrank_construct_from_geno", time.perf_counter() - t0,
         note=f"n={n} p={p} k={k}, randomized subspace iteration, device-side")

    # 2. low-rank bulkscan (null-grid)
    def scan_lr():
        r = bl.bulkscan(Y, G, lr, method="null-grid")
        return jax.block_until_ready(r.L)

    t0 = time.perf_counter()
    scan_lr()
    emit("lowrank_bulkscan_compile_first", time.perf_counter() - t0)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        scan_lr()
        ts.append(time.perf_counter() - t0)
    emit("lowrank_bulkscan_null_grid", min(ts), note=f"n={n} p={p} m={m} k={k}")

    if args.all_methods:
        # the other scan methods + permutation testing on the same rank-k
        # kinship (the full low-rank surface)
        for meth in ("null-exact", "alt-grid"):
            def scan_m():
                r = bl.bulkscan(Y, G, lr, method=meth)
                return jax.block_until_ready(r.L)

            t0 = time.perf_counter()
            scan_m()
            emit(f"lowrank_{meth}_compile_first", time.perf_counter() - t0)
            ts = []
            for _ in range(2):
                t0 = time.perf_counter()
                scan_m()
                ts.append(time.perf_counter() - t0)
            emit(f"lowrank_bulkscan_{meth.replace('-', '_')}", min(ts),
                 note=f"n={n} p={p} m={m} k={k}")

        y1 = np.asarray(Y[:, 0], dtype=np.float64)

        def perms():
            r = bl.scan(y1, G, lr, permutation_test=True, nperms=1024,
                        rndseed=0)
            return jax.block_until_ready(r.L_perms)

        t0 = time.perf_counter()
        perms()
        emit("lowrank_perms_compile_first", time.perf_counter() - t0)
        ts = []
        for _ in range(2):
            t0 = time.perf_counter()
            perms()
            ts.append(time.perf_counter() - t0)
        emit("lowrank_scan_perms_1024", min(ts),
             note=f"n={n} p={p} k={k}, rank-k whitening + correlate")

    if args.compare_full:
        # 3. the wall being removed: host float64 eigh + (n, n) upload
        Kh = np.asarray(bl.calc_kinship(G), dtype=np.float64)
        t0 = time.perf_counter()
        decomp = bl.decompose_kinship(Kh)
        jax.block_until_ready((decomp.Ut, decomp.lam))
        emit("full_host_eigh_plus_upload", time.perf_counter() - t0,
             note=f"n={n}, float64 LAPACK eigh + (n,n) device_put")

        def scan_full():
            r = bl.bulkscan(Y, G, decomp, method="null-grid")
            return jax.block_until_ready(r.L)

        t0 = time.perf_counter()
        scan_full()
        emit("full_bulkscan_compile_first", time.perf_counter() - t0)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            scan_full()
            ts.append(time.perf_counter() - t0)
        emit("full_bulkscan_null_grid", min(ts), note="cached decomposition")

        r_lr = bl.bulkscan(Y, G, lr, method="null-grid")
        r_fu = bl.bulkscan(Y, G, decomp, method="null-grid")
        # truncation fidelity, separated: traits whose h2 grid selection
        # agrees (LOD deviation = pure weight-tail error) vs selection flips
        # (borderline grid cells; the LODs there differ by the grid step)
        same = np.asarray(r_lr.h2_null_list == r_fu.h2_null_list)
        dL = np.abs(np.asarray(r_lr.L) - np.asarray(r_fu.L))
        same_max = float(dL[:, same].max()) if same.any() else float("nan")
        print(json.dumps({
            "metric": "lowrank_vs_full_fidelity",
            "h2_grid_agreement": round(float(same.mean()), 4),
            "same_h2_max_absL": round(same_max, 6),
            "overall_p99_absL": round(float(np.quantile(dL, 0.99)), 6),
            "overall_max_absL": round(float(dL.max()), 6),
            "note": f"k={k} of n={n}",
        }), flush=True)


if __name__ == "__main__":
    main()
