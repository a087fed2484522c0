"""Benchmark suite on one GPU: every BASELINE.md config, one JSON line each.

Reference numbers (16-thread Xeon, reference README.md:198-339):
  single-trait scan 79x7,321 .......... 0.059 s
  single-trait + 1,000 permutations ... 0.079 s
  bulkscan null-grid 35,554x7,321 ..... 2.112 s

Each line carries the median warm wall time (``block_until_ready``), the
speedup against the reference where it publishes one, and the achieved
TFLOP/s of the config's analytic FLOP model. The card's name and power
limit print first. Refuses to run without a GPU.

Run: python benchmarks/run_all.py [--quick] [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import card_line, device_info, require_gpus, synth_bxd, wall  # noqa: E402

BASELINES = {
    "scan_single_trait": 0.059,
    "scan_single_trait_reml": 0.059,  # reference publishes the ML timing
    "scan_perms_1000": 0.079,
    "bulkscan_null_grid": 2.112,
    "bulkscan_null_exact": None,  # reference publishes no number
    "bulkscan_alt_grid": None,
    "scan_alt_exact": None,
}


def timeit(fn, *, repeats=3):
    """Median warm wall time over ``repeats`` calls (one warm-up first)."""
    wall(fn)
    return statistics.median(wall(fn) for _ in range(repeats))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="smaller trait count")
    ap.add_argument("--out", help="also write the results as one JSON file")
    args = ap.parse_args()

    import jax

    from bulklmm_tpu.utils.cache import use_compile_cache

    use_compile_cache()
    devs = require_gpus(1)
    import bulklmm_tpu as bl

    print(f"# card: {card_line()}", flush=True)
    n, p = 79, 7321
    m = 4096 if args.quick else 35554
    G, K, Y = synth_bxd(n, p, m)
    Gd, Yd = jax.device_put(G), jax.device_put(Y)
    # single-trait input stays HOST numpy (the CSV-user path): the
    # backend-deterministic null fit runs on the host, so a host trait
    # vector costs zero device round-trips
    yd = Y[:, 0]
    jax.block_until_ready((Gd, Yd))

    results = {}

    # Analytic FLOP models (PERF.md "FLOP models"): dominant GEMM
    # terms only — rotation 2n^2(p+m+c) + the (c+2) correlation GEMMs
    # 2npm(c+2) for the null kernels; the alt-grid and permutation kernels
    # scale the correlation term by the grid width / permutation count.
    c1 = 1  # intercept-only covariate column in every config below
    grid = 10
    nperm1 = 1001

    def rot(mm):
        return 2.0 * n * n * (p + mm + c1)

    def corr(mm, cols=None):
        return 2.0 * n * p * (cols if cols is not None else mm) * (c1 + 2)

    flop_model = {
        "scan_single_trait": rot(1) + corr(1),
        "scan_single_trait_reml": rot(1) + corr(1),
        "scan_perms_1000": rot(1) + corr(1, nperm1),
        "bulkscan_null_grid": rot(m) + corr(m),
        "bulkscan_null_exact": rot(m) + corr(m),
        # alt-grid: full grid sweep per marker
        "bulkscan_alt_grid": rot(m) + grid * corr(m),
        # per-marker Brent: ~iters grid-likelihood passes dominated by the
        # (p-batched) WLS ells — count the final correlation pass only
        # (a LOWER bound)
        "scan_alt_exact": rot(1) + corr(1),
        "bulkscan_perms_1000": rot(m) + 2.0 * n * p * nperm1 * m,
    }

    def record(name, seconds, note=""):
        base = BASELINES.get(name)
        entry = {
            "metric": name,
            "value": seconds,
            "unit": "s",
            "vs_baseline": base / seconds if base else None,
            "device": device_info(devs),
        }
        if name in flop_model:
            entry["achieved_tflops"] = flop_model[name] / seconds / 1e12
        if note:
            entry["note"] = note
        results[name] = entry
        print(json.dumps(entry))

    # 1. single-trait null scan
    def f():
        r = bl.scan(yd, Gd, K)
        return r.lod
    record("scan_single_trait", timeit(f))

    # 1b. single-trait REML scan (BASELINE.json config)
    def f():
        r = bl.scan(yd, Gd, K, reml=True)
        return r.lod
    record("scan_single_trait_reml", timeit(f))

    # 2. single-trait + 1,000 permutations
    def f():
        r = bl.scan(yd, Gd, K, permutation_test=True, nperms=1000, rndseed=0)
        return r.L_perms
    record("scan_perms_1000", timeit(f))

    # 3. bulkscan null-grid (the headline)
    def f():
        r = bl.bulkscan(Yd, Gd, K, method="null-grid")
        return r.L
    record("bulkscan_null_grid", timeit(f), note=f"m={m}")

    # 4. bulkscan null-exact (per-trait Brent)
    def f():
        r = bl.bulkscan(Yd, Gd, K, method="null-exact")
        return r.L
    record("bulkscan_null_exact", timeit(f), note=f"m={m}")

    # 5. bulkscan alt-grid
    def f():
        r = bl.bulkscan(Yd, Gd, K, method="alt-grid")
        return r.L
    record("bulkscan_alt_grid", timeit(f), note=f"m={m}")

    # 6. exact per-marker VC scan (the expensive path the grid approximates)
    def f():
        r = bl.scan(yd, Gd, K, assumption="alt")
        return r.lod
    record("scan_alt_exact", timeit(f))

    # 6b. marginal single-trait cost with a WARM KinshipDecomposition: the
    # one-shot configs pay a fixed per-call floor (host eigendecomposition,
    # host null fit, uploads); a repeated-scan workflow (the reference's
    # own loop pattern) pays only the marginal
    kd = bl.decompose_kinship(K)
    NSEQ = 16

    def f():
        for j in range(NSEQ):
            # wait per scan: sequential marginal
            jax.block_until_ready(bl.scan(Y[:, j % Y.shape[1]], Gd, kd).lod)
    BASELINES["scan_marginal_warm"] = BASELINES["scan_single_trait"]
    record(
        "scan_marginal_warm", timeit(f, repeats=2) / NSEQ,
        note=f"marginal per-scan over {NSEQ} sequential scans, warm "
        "KinshipDecomposition, each waited for",
    )

    # 6c. same, pipelined: dispatch all scans, wait once at the end
    def f():
        return [bl.scan(Y[:, j % Y.shape[1]], Gd, kd).lod for j in range(NSEQ)]
    BASELINES["scan_marginal_pipelined"] = BASELINES["scan_single_trait"]
    record(
        "scan_marginal_pipelined", timeit(f, repeats=2) / NSEQ,
        note=f"marginal per-scan over {NSEQ} dispatched scans, one wait "
        "at the end",
    )

    # 6d. marginal FULL bulkscan (warm decomposition, pipelined dispatch):
    # the repeated-workflow number (e.g. LOCO loops, parameter sweeps,
    # method comparisons on one cohort)
    NB = 6

    def f():
        return [bl.bulkscan(Yd, Gd, kd).L for _ in range(NB)]
    BASELINES["bulkscan_marginal_pipelined"] = BASELINES["bulkscan_null_grid"]
    record(
        "bulkscan_marginal_pipelined", timeit(f, repeats=2) / NB,
        note=f"marginal per full {m}x{p} null-grid bulkscan over {NB} "
        "dispatched scans, warm KinshipDecomposition, one wait at the end",
    )

    # 7. all-trait bulk permutation thresholds (fused Pallas engine)
    def f():
        r = bl.bulkscan_perms(Yd, Gd, K, nperms=1000, rndseed=0)
        return r.maxlods
    dt = timeit(f, repeats=1)
    BASELINES["bulkscan_perms_1000"] = m * BASELINES["scan_perms_1000"]
    record(
        "bulkscan_perms_1000", dt,
        note=f"m={m} traits x 1000 perms, per-trait genome-wide null "
        f"maxima + FWER thresholds; reference equivalent = {m} sequential "
        f"single-trait perm scans ~{m * 0.079:.0f} s (README.md:229-233 "
        "0.079 s/trait)",
    )

    # 7b. same sweep in the THROUGHPUT screening tier (three-pass bf16
    # kernel dots instead of six)
    from bulklmm_tpu.utils.config import THROUGHPUT

    def f():
        r = bl.bulkscan_perms(Yd, Gd, K, nperms=1000, rndseed=0,
                              precision=THROUGHPUT)
        return r.maxlods
    BASELINES["bulkscan_perms_1000_throughput"] = m * BASELINES["scan_perms_1000"]
    record(
        "bulkscan_perms_1000_throughput", timeit(f, repeats=1),
        note="screening tier: three-pass bf16 kernel dots",
    )

    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=2) + "\n")


if __name__ == "__main__":
    main()
