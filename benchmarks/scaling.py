"""Weak-scaling harness for the sharded bulkscan engines.

Measures the BASELINE.md multi-host target ("≥80% scaling efficiency to 4
hosts") the moment real multi-chip hardware is attached: the per-shard
problem is held CONSTANT (base_traits traits per shard) while the shard
count grows 1 → 2 → 4 → ..., so ideal scaling is flat wall time and

    efficiency(k) = t(1 shard) / t(k shards).

On virtual devices (the 8-way CPU mesh used for CI/dry runs) wall time is
meaningless — all "devices" share the same cores — so the harness degrades
to a correctness + placement report: sharded results are checked against
the unsharded engine and the number of addressable shards actually used is
recorded, with timings marked ``"virtual": true``.

Run:
  python benchmarks/scaling.py                      # real devices
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python benchmarks/scaling.py --base-traits 64 --markers 256

Prints one JSON line per shard count (``--out`` also writes them to a
file). Reference context: the reference defers distribution entirely
(/root/reference/README.md:66-72 runs one multicore node).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import synth_bxd  # noqa: E402
from benchmarks.run_all import timeit  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=79, help="individuals")
    ap.add_argument("--markers", type=int, default=7321)
    ap.add_argument(
        "--base-traits", type=int, default=8192,
        help="traits PER SHARD (weak scaling holds this constant)",
    )
    ap.add_argument(
        "--shards", type=int, nargs="*", default=None,
        help="shard counts to run (default: 1 2 4 ... up to device count)",
    )
    ap.add_argument("--method", default="null-grid")
    ap.add_argument("--out", help="also write the rows as one JSON file")
    args = ap.parse_args()

    import jax

    from bulklmm_tpu.utils.cache import use_compile_cache

    use_compile_cache()
    from bulklmm_tpu import bulkscan
    from bulklmm_tpu.parallel import bulkscan_sharded, make_mesh

    devs = jax.devices()
    platform = devs[0].platform
    # a forced-host-count CPU backend is virtual: shards share physical cores
    virtual = platform == "cpu"
    ndev = len(devs)
    shard_counts = args.shards or [
        k for k in (1, 2, 4, 8, 16, 32) if k <= ndev
    ]

    rows = []
    t1 = None
    for k in shard_counts:
        m = args.base_traits * k
        G, K, Y = synth_bxd(args.n, args.markers, m)
        mesh = make_mesh(k)

        def run():
            return bulkscan_sharded(Y, G, K, mesh=mesh, method=args.method)

        if virtual:
            # correctness + placement only: check the sharded result against
            # the single-device engine on a trait subset and count the
            # addressable shards the output actually landed on
            res = run()
            sub = min(m, 64)
            ref = bulkscan(Y[:, :sub], G, K, method=args.method)
            err = float(
                np.max(np.abs(np.asarray(res.L[:, :sub]) - np.asarray(ref.L)))
            )
            nshards = len(res.L.sharding.device_set)
            row = {
                "shards": k, "traits": m, "markers": args.markers,
                "virtual": True, "platform": platform,
                "max_err_vs_unsharded": err, "devices_used": nshards,
                "ok": bool(err < 1e-5 and nshards == k),
            }
        else:
            t = timeit(run)
            t1 = t if t1 is None else t1
            row = {
                "shards": k, "traits": m, "markers": args.markers,
                "virtual": False, "platform": platform,
                "device_kind": devs[0].device_kind,
                "wall_s": t,
                "traits_per_s": m / t,
                "efficiency": t1 / t,
            }
        rows.append(row)
        print(json.dumps(row))

    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    if not virtual and len(rows) > 1:
        worst = min(r["efficiency"] for r in rows[1:])
        print(json.dumps({
            "metric": "weak_scaling_efficiency_min", "value": worst,
            "unit": "ratio", "target": 0.80,
        }))
    return rows


if __name__ == "__main__":
    main()
