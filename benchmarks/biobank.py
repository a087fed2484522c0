"""Synthetic biobank-scale benchmark: n=5,000 individuals x 100k markers x
20k traits (the BASELINE.md multi-host config).

On one chip this runs trait-chunked (memory-bounded); on a multi-chip mesh it
runs through ``bulklmm_tpu.parallel.bulkscan_sharded`` with trait/marker
sharding. The n x n eigendecomposition is cached to disk between runs
(the checkpoint/resume story for large cohorts).

  python benchmarks/biobank.py              # scaled-down default (fits 1 chip fast)
  python benchmarks/biobank.py --full       # 5000 x 100k x 20k
  python benchmarks/biobank.py --sharded    # use all visible devices
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def synth_cohort(n, p, m, seed=7):
    """Low-rank genotype structure so the kinship has realistic spectrum."""
    rng = np.random.default_rng(seed)
    nfound = max(8, n // 50)  # founder haplotypes
    founders = rng.uniform(0, 1, (nfound, p)).astype(np.float32)
    mix = rng.dirichlet(np.ones(nfound) * 0.2, size=n).astype(np.float32)
    G = np.clip(mix @ founders + 0.05 * rng.normal(size=(n, p)).astype(np.float32), 0, 1)
    Y = rng.normal(size=(n, m)).astype(np.float32)
    return G, Y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--trait-chunk", type=int, default=4096)
    ap.add_argument(
        "--host-blocks", type=int, default=1,
        help="split traits into N sequential bulkscan calls (production "
             "pattern: each block's LOD matrix is consumed/written before "
             "the next; needed when the full (p, m) result exceeds one "
             "chip's HBM)",
    )
    ap.add_argument(
        "--lowrank", type=int, default=0,
        help="run the rank-k kinship engine (ops/lowrank.py) instead of the "
             "rotated full-rank path; 0 = full-rank",
    )
    ap.add_argument(
        "--perms", type=int, default=0,
        help="benchmark bulkscan_perms with N permutations instead of the "
             "scan (rank-k Woodbury whitening when combined with --lowrank)",
    )
    ap.add_argument(
        "--perm-traits", type=int, default=128,
        help="trait count for --perms (per-trait whitening makes the "
             "permutation pass cost ~ m x p x n x nperms GEMM flops)",
    )
    ap.add_argument(
        "--precision", default=None,
        choices=["fast32", "balanced", "mixed", "exact64", "throughput"],
        help="numerics preset (default: the library default; 'throughput' "
             "= the Precision.HIGH screening tier)",
    )
    args = ap.parse_args()

    n, p, m = (5000, 100_000, 20_000) if args.full else (2000, 30_000, 8_000)

    import jax
    import jax.numpy as jnp

    from bench import card_line, require_gpus
    from bulklmm_tpu.utils.cache import use_compile_cache

    use_compile_cache()
    require_gpus(1)
    print(f"# card: {card_line()}", flush=True)
    import bulklmm_tpu as bl
    from bulklmm_tpu.utils.config import (
        BALANCED, DEFAULT_PRECISION, EXACT64, FAST32, MIXED, THROUGHPUT,
    )

    prec = {
        None: DEFAULT_PRECISION, "fast32": FAST32, "balanced": BALANCED,
        "mixed": MIXED, "exact64": EXACT64, "throughput": THROUGHPUT,
    }[args.precision]
    if args.precision in ("balanced", "mixed", "exact64"):
        jax.config.update("jax_enable_x64", True)

    G, Y = synth_cohort(n, p, m)

    from bulklmm_tpu.ops.rotation import KinshipDecomposition, kinship_eigen

    Gd = jax.device_put(jnp.asarray(G))
    Yd = jax.device_put(jnp.asarray(Y))
    jax.block_until_ready((Gd, Yd))

    if args.lowrank:
        t0 = time.perf_counter()
        K = bl.kinship_lowrank_from_geno(Gd, args.lowrank)
        jax.block_until_ready((K.U, K.lam))
        eigh_s = time.perf_counter() - t0  # device-side; no n x n anywhere
    else:
        cache = Path(__file__).parent / f"eigh_cache_n{n}.npz"
        t0 = time.perf_counter()
        if cache.is_file():
            z = np.load(cache)
            Ut_np, lam_np = z["Ut"], z["lam"]
            eigh_s = 0.0
        else:
            Kfull = np.asarray(bl.calc_kinship(G))
            Ut_np, lam_np = kinship_eigen(Kfull)
            np.savez(cache, Ut=Ut_np, lam=lam_np)
            eigh_s = time.perf_counter() - t0
        # decompose once, device-resident — repeated scans skip host eigh +
        # the n x n transfer (the checkpoint/resume story for large cohorts)
        K = KinshipDecomposition(
            Ut=jax.device_put(jnp.asarray(Ut_np, dtype=jnp.float32)),
            lam=jax.device_put(jnp.asarray(lam_np, dtype=jnp.float32)),
        )
        jax.block_until_ready((K.Ut, K.lam))

    if args.perms:
        mp_ = min(args.perm_traits, m)
        Yp = Yd[:, :mp_]

        def run():
            r = bl.bulkscan_perms(Yp, Gd, K, nperms=args.perms, precision=prec)
            return jax.block_until_ready(r.maxlods)

        run()
        t0 = time.perf_counter()
        run()
        dt = time.perf_counter() - t0
        # reference equivalent: sequential single-trait perm scans at the
        # README's 0.079 s/trait for 1,000 permutations (README.md:229-233),
        # scaled to the permutation count actually benchmarked; the
        # reference additionally pays a ~n^3 host eigh it cannot avoid
        print(json.dumps({
            "metric": f"biobank_bulkperms_{n}x{p}x{mp_}x{args.perms}",
            "value": round(dt, 3),
            "unit": "s",
            "vs_baseline": round(mp_ * 0.079 * (args.perms / 1000.0) / dt, 1),
            "note": (
                f"lowrank k={args.lowrank} constructor {eigh_s:.1f}s"
                if args.lowrank else f"eigh setup {eigh_s:.1f}s (cached)"
            ),
        }))
        return

    if args.sharded and len(jax.devices()) > 1:
        from bulklmm_tpu.parallel import bulkscan_sharded, make_mesh

        mesh = make_mesh()

        def run():
            r = bulkscan_sharded(Yd, Gd, K, mesh=mesh, precision=prec)
            return jax.block_until_ready(r.L)
    else:
        mb = -(-m // args.host_blocks)

        def run():
            for b in range(args.host_blocks):
                Yb = Yd[:, b * mb : (b + 1) * mb]
                r = bl.bulkscan(Yb, Gd, K, trait_chunk=args.trait_chunk, precision=prec)
                jax.block_until_ready(r.L)  # finish block before the next

    run()  # compile + absorb async compile latency
    t0 = time.perf_counter()
    run()
    dt = time.perf_counter() - t0

    lod_per_s = p * m / dt
    print(
        json.dumps(
            {
                "metric": f"biobank_bulkscan_{n}x{p}x{m}",
                "value": round(dt, 3),
                "unit": "s",
                "vs_baseline": round(lod_per_s / 1.23e8, 1),  # reference LODs/sec
                "note": f"{lod_per_s:.2e} LOD evals/s; "
                + (
                    f"lowrank k={args.lowrank} device constructor {eigh_s:.1f}s"
                    if args.lowrank
                    else f"kinship+eigh setup {eigh_s:.1f}s (cached)"
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
