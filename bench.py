"""Flagship benchmark: BXD-scale null-grid bulkscan on one GPU.

Reference headline number (BASELINE.md): BulkLMM.jl computes the full
35,554-trait x 7,321-marker BXD LOD matrix (null-grid, h2 grid 0:0.1:0.9) in
2.112 s on a 16-thread Xeon (reference README.md:336-339). This script runs
the same-shape problem on synthetic BXD-scale data, in BALANCED precision
(f64 rotation + likelihood/grid math, f32 GEMMs at HIGHEST and f32 kernel
combines), and prints the card (name, power limit) and one JSON line:

  {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": speedup,
   "device": {"platform": ..., "kind": ..., "count": ...}}

``value`` is the median warm wall time of 5 calls, each ending in
``jax.block_until_ready``; ``vs_baseline`` > 1 means faster than the
reference. Refuses to run without a GPU. The helpers here (synthetic
data, card line, GPU check, wall clock) are shared by chip_smoke.py and
benchmarks/*.py.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

BASELINE_S = 2.112
N, P, M = 79, 7321, 35554


def synth_bxd(n=N, p=P, m=M, seed=2026):
    """Seeded synthetic cohort at the BXD demo shape: uniform genotype
    probabilities, the reference kinship definition, normal traits."""
    rng = np.random.default_rng(seed)
    G = rng.uniform(0.0, 1.0, (n, p)).astype(np.float32)
    X = G - 0.5
    K = (2.0 * X.astype(np.float64) @ X.astype(np.float64).T / p + 0.5)
    np.fill_diagonal(K, 1.0)
    Y = rng.normal(size=(n, m)).astype(np.float32)
    return G, K, Y


def card_line() -> str:
    """``name, power.limit`` of each visible card, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def probe_gpus():
    """(platform, count) of JAX's devices, asked in a child process so that
    the caller holds no card: a JAX process reserves most of each card's
    memory, and subprocesses that need the cards must run first."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; d = jax.devices(); print(d[0].platform, len(d))"],
        capture_output=True, text=True, timeout=300,
    )
    platform, count = (r.stdout.split() + ["none", "0"])[:2]
    return (platform, int(count)) if r.returncode == 0 else ("none", 0)


def require_gpus(count: int = 1):
    """The first ``count`` JAX devices; exits (code 2) unless they are
    GPUs — a CPU timing says nothing about the card."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        print(f"needs {count} GPU(s); JAX found {len(devs)} "
              f"{devs[0].platform} device(s)", file=sys.stderr)
        sys.exit(2)
    return devs[:count]


def wall(fn) -> float:
    """Seconds for one ``fn()`` call, ending when its result is ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t0


def device_info(devs) -> dict:
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main():
    import jax

    from bulklmm_tpu.utils.cache import use_compile_cache

    use_compile_cache()
    jax.config.update("jax_enable_x64", True)  # BALANCED needs f64
    devs = require_gpus(1)
    from bulklmm_tpu import bulkscan
    from bulklmm_tpu.utils.config import BALANCED

    print(f"# card: {card_line()}", flush=True)
    G, K, Y = synth_bxd()
    # Data resident in device memory before timing — the analog of the
    # reference's benchmark, which times compute with both matrices already
    # in Julia RAM (reference README.md:336-339; CSV load is excluded there
    # too). The timed path covers the host eigendecomposition, the fused
    # rotation + grid-fit + LOD device program, and result completion.
    Gd, Yd = jax.device_put(G), jax.device_put(Y)
    jax.block_until_ready((Gd, Yd))

    def run():
        return bulkscan(Yd, Gd, K, method="null-grid", precision=BALANCED).L

    wall(run)  # compile warm-up
    value = statistics.median(wall(run) for _ in range(5))
    print(json.dumps({
        "metric": "bulkscan_null_grid_bxd_35554x7321",
        "value": value,
        "unit": "s",
        "vs_baseline": BASELINE_S / value,
        "device": device_info(devs),
    }))


if __name__ == "__main__":
    main()
