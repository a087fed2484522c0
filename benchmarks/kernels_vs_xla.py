"""Fused Pallas kernels vs the plain XLA engines, on one GPU.

For each kernel (alt-grid, bulk permutations) this times the public entry
point end to end with ``engine="pallas"`` and ``engine="xla"`` at the
BXD flagship shape (79 strains x 7,321 markers x 35,554 traits, h2 grid
0:0.1:0.9, BALANCED precision, 1,000 permutations) in turns
(xla, pallas, pallas, xla, ...), and reports each side's median warm wall
time (``block_until_ready``) and the max |dLOD| between them.

Run: python benchmarks/kernels_vs_xla.py [--m 35554] [--repeats 3]

Refuses to run without a GPU: a CPU timing says nothing about the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import card_line, require_gpus, synth_bxd, wall  # noqa: E402


def alternate(fns: dict, repeats: int):
    """Warm each, then time them in turns, reversing the order each round;
    returns {name: [seconds, ...]}."""
    for f in fns.values():
        wall(f)
    names = list(fns)
    out = {k: [] for k in names}
    for r in range(repeats):
        for k in (names if r % 2 == 0 else names[::-1]):
            out[k].append(wall(fns[k]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=35554)
    ap.add_argument("--nperms", type=int, default=1000)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import jax

    from bulklmm_tpu.utils.cache import use_compile_cache

    use_compile_cache()
    jax.config.update("jax_enable_x64", True)
    devs = require_gpus(1)
    import numpy as np

    import bulklmm_tpu as bl
    from bulklmm_tpu.utils.config import BALANCED

    print(f"# card: {card_line()}; jax {jax.__version__}; "
          f"{devs[0].device_kind} x{len(devs)}", flush=True)
    G, K, Y = synth_bxd(m=args.m)
    Gd, Yd = jax.device_put(G), jax.device_put(Y)
    rows = []

    def report(name, times, ref=None, got=None, **extra):
        row = {"name": name, "median_s": statistics.median(times),
               "times_s": times, **extra}
        if ref is not None:
            row["max_abs_dlod_vs_xla"] = float(
                np.max(np.abs(np.asarray(got, np.float64)
                              - np.asarray(ref, np.float64))))
        rows.append(row)
        print(json.dumps(row), flush=True)

    # --- alt-grid, end to end through bulkscan
    alt = {
        eng: (lambda eng=eng: bl.bulkscan(
            Yd, Gd, K, method="alt-grid", precision=BALANCED,
            engine=eng).L)
        for eng in ("xla", "pallas")
    }
    ref, got = alt["xla"](), alt["pallas"]()
    t = alternate(alt, args.repeats)
    report("alt_grid_xla", t["xla"])
    report("alt_grid_pallas", t["pallas"], ref, got)
    del ref, got

    # --- bulk permutations, end to end through bulkscan_perms
    perms = {
        eng: (lambda eng=eng: bl.bulkscan_perms(
            Yd, Gd, K, nperms=args.nperms, precision=BALANCED,
            engine=eng).maxlods)
        for eng in ("xla", "pallas")
    }
    ref, got = perms["xla"](), perms["pallas"]()
    t = alternate(perms, args.repeats)
    report("perms_xla", t["xla"])
    report("perms_pallas", t["pallas"], ref, got)


if __name__ == "__main__":
    main()
