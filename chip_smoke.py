"""Smoke test of the scan engine on NVIDIA GPUs, at full BXD width.

Runs the public entry points once on seeded synthetic data of the
reference's demo shape (79 strains x 7,321 markers x 35,554 traits, h2
grid 0:0.1:0.9, BALANCED precision) and holds every result to the repo's
accuracy bar against two plain references:

- the same call on the same card with ``engine="xla"`` and
  ``precision=EXACT64`` (native f64), at max |dLOD| <= 1e-5, the repo's
  bar for BALANCED against f64;
- a CPU float64 golden of the first 256 traits (the single-trait scan:
  its one trait), computed in this process on the CPU device, at
  max |dLOD| <= 2e-5, the repo's cross-backend bar
  (benchmarks/chip_validation.py).

Phases, in order: bulkscan null-grid (the flagship), null-exact and
alt-grid (the fused Pallas kernel where it applies), bulkscan_perms with
1,000 permutations (ditto), scan of one trait with 1,000 permutations
plus get_thresholds, and the precision pin (every f32 product of the
flagship core at HIGHEST). Each prints its max |dLOD|, tolerance, GEMM
precision, engine and warm wall time.

``--four-gpus`` runs only the multi-card path instead: bulkscan_sharded
and bulkscan_perms_sharded on (4, 1) and (2, 2) meshes, and a 4-process
podscan + merge-shards with one card per process, each against the
one-card result.

Usage: python chip_smoke.py [--four-gpus]

Exits nonzero, printing no result line, when JAX finds no GPU, when the
rest of the repo is missing, or when any phase fails. The last line of
standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from bench import card_line, probe_gpus, require_gpus, synth_bxd  # noqa: E402

N, P, M = 79, 7321, 35554
NPERMS = 1000
N_GOLDEN = 256
TOL = 1e-5  # BALANCED vs f64 on the same card, every phase
GOLDEN_TOL = 2e-5  # vs the CPU f64 golden (benchmarks/chip_validation.py)


class PhaseFailed(Exception):
    pass


def max_abs(a, b) -> float:
    import numpy as np

    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def warm(fn):
    """(warm wall seconds, result): one call to compile, one timed."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return time.perf_counter() - t0, out


def check(name, *, got, ref, tol, golden=None, seconds=None,
          ref_name="f64_xla", **info):
    """Print one phase line; raise if any comparison misses its bar."""
    err = max_abs(got, ref)
    row = {"phase": name, f"max_abs_dlod_vs_{ref_name}": err, "tol": tol}
    ok = err <= tol
    if golden is not None:
        gerr = max_abs(*golden)
        row.update(max_abs_dlod_vs_cpu_f64=gerr, golden_tol=GOLDEN_TOL)
        ok = ok and gerr <= GOLDEN_TOL
    row.update(info)
    if seconds is not None:
        row["warm_wall_s"] = seconds
    row["ok"] = ok
    print(json.dumps(row), flush=True)
    if not ok:
        raise PhaseFailed(name)


def synth(seed=2026):
    return synth_bxd(N, P, M, seed=seed)


def one_gpu():
    import jax

    from bulklmm_tpu.utils.cache import use_compile_cache

    cache = use_compile_cache()
    jax.config.update("jax_enable_x64", True)
    devs = require_gpus(1)
    import numpy as np

    import bulklmm_tpu as bl
    from bulklmm_tpu.models.bulkscan import _altgrid_engine, _null_grid_pipeline
    from bulklmm_tpu.models.bulkperm import _resolve_perm_engine
    from bulklmm_tpu.ops.rotation import resolve_kinship
    from bulklmm_tpu.pallas.altgrid_fused import kernel_dot_precision
    from bulklmm_tpu.utils.config import (
        BALANCED, EXACT64, f32_dots_below_highest,
    )

    print(f"card: {card_line()}")
    print(f"jax {jax.__version__}; devices: {devs[0].device_kind} "
          f"x{len(devs)}; compile cache: {cache}", flush=True)
    G, K, Y = synth()
    Gd, Yd = jax.device_put(G), jax.device_put(Y)
    cpu = jax.devices("cpu")[0]
    sub = slice(0, N_GOLDEN)
    prec = "BALANCED: f64 solve, f32 GEMMs at HIGHEST (FP32)"
    kdot = kernel_dot_precision(BALANCED.gemm_precision).name

    def prec_of(engine):
        if engine == "pallas":
            return f"BALANCED: f64 solve, fused-kernel dots {kdot}"
        return prec

    def golden(fn):
        with jax.default_device(cpu):
            return jax.block_until_ready(fn())

    # (a) bulkscan, null methods: XLA on every backend
    for method in ("null-grid", "null-exact"):
        s, got = warm(lambda: bl.bulkscan(Yd, Gd, K, method=method,
                                          precision=BALANCED).L)
        ref = bl.bulkscan(Yd, Gd, K, method=method, precision=EXACT64).L
        gold = golden(lambda: bl.bulkscan(Y[:, sub], G, K, method=method,
                                          precision=EXACT64).L)
        check(f"bulkscan_{method}", got=got, ref=ref, tol=TOL,
              golden=(np.asarray(got)[:, sub], gold), seconds=s,
              precision=prec, engine="xla", shape=list(np.shape(got)))
        if method == "null-grid":
            stats = devs[0].memory_stats() or {}
            print(json.dumps({"flagship_peak_bytes_in_use":
                              stats.get("peak_bytes_in_use")}))
        del got, ref

    # (b) alt-grid: the fused kernel where it applies
    eng = _altgrid_engine("auto", BALANCED, 10)
    def alt(precision, engine="auto"):
        res = bl.bulkscan(Yd, Gd, K, method="alt-grid", precision=precision,
                          engine=engine)
        return res.L, res.h2_panel

    s, (got, panel) = warm(lambda: alt(BALANCED))
    ref, ref_panel = alt(EXACT64, "xla")
    gold = golden(lambda: bl.bulkscan(Y[:, sub], G, K, method="alt-grid",
                                      precision=EXACT64).L)
    check("bulkscan_alt-grid", got=got, ref=ref, tol=TOL,
          golden=(np.asarray(got)[:, sub], gold), seconds=s,
          precision=prec_of(eng), engine=eng,
          h2_panel_mismatch_share=float(np.mean(
              np.asarray(panel) != np.asarray(ref_panel))))
    del got, ref

    # (c) bulk permutations: the fused kernel where it applies
    eng, _ = _resolve_perm_engine("auto", N, precision=BALANCED)
    s, got = warm(lambda: bl.bulkscan_perms(Yd, Gd, K, nperms=NPERMS,
                                            precision=BALANCED).maxlods)
    ref = bl.bulkscan_perms(Yd, Gd, K, nperms=NPERMS, precision=EXACT64,
                            engine="xla").maxlods
    gold = golden(lambda: bl.bulkscan_perms(
        Y[:, sub], G, K, nperms=NPERMS, precision=EXACT64).maxlods)
    check("bulkscan_perms_1000", got=got, ref=ref, tol=TOL,
          golden=(np.asarray(got)[sub], gold), seconds=s,
          precision=prec_of(eng), engine=eng, shape=list(np.shape(got)))
    del got, ref

    # (d) one trait, 1,000 permutations, thresholds
    y = Y[:, 0]
    levels = [0.10, 0.05]

    def single(precision):
        res = bl.scan(y, G, K, permutation_test=True, nperms=NPERMS,
                      precision=precision)
        thr = bl.get_thresholds(res.L_perms, levels).thrs
        return np.concatenate([np.ravel(res.lod), np.ravel(res.L_perms),
                               np.ravel(thr)])

    s, got = warm(lambda: single(BALANCED))
    ref = single(EXACT64)
    gold = golden(lambda: single(EXACT64))
    check("scan_perms_1000_thresholds", got=got, ref=ref, tol=TOL,
          golden=(got, gold), seconds=s, precision=prec, engine="xla")

    # (e) precision pin: no f32 product of the flagship core below HIGHEST
    Ut, lam = resolve_kinship(K, "eigen", np.float64)
    f64 = np.float64
    text = _null_grid_pipeline.lower(
        Yd.astype(f64), Gd.astype(f64), np.ones((N, 1)), Ut, lam,
        np.arange(0.0, 0.91, 0.1), prior=(1.0, 0.0), reml=False,
        method="qr", precision=BALANCED,
    ).as_text()
    bad = f32_dots_below_highest(text)
    n_dots = text.count("stablehlo.dot_general")
    print(json.dumps({"phase": "flagship_f32_dots_at_highest",
                      "dot_generals": n_dots, "below_highest": len(bad),
                      "ok": not bad}), flush=True)
    if bad:
        raise PhaseFailed("precision pin: " + bad[0][:200])
    return devs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pods(G, K, Y, workdir: Path):
    """4-process podscan (one card each) + merge-shards; returns the
    merged (p, m) LODs. Runs before this process opens any card."""
    import numpy as np

    np.savez(workdir / "geno.npz", geno=G)
    np.savez(workdir / "pheno.npz", pheno=Y)
    np.savez(workdir / "kinship.npz", kinship=K)
    shards = workdir / "shards"
    shards.mkdir()
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "bulklmm_tpu", "podscan",
           "--geno", str(workdir / "geno.npz"),
           "--pheno", str(workdir / "pheno.npz"),
           "--kinship", str(workdir / "kinship.npz"),
           "-o", str(workdir / "pod.npz"), "--save-shards", str(shards),
           "--coordinator", f"localhost:{port}", "--nproc", "4"]
    procs = [subprocess.Popen(cmd + ["--pid", str(i), "--local-device",
                                     str(i)], env=env)
             for i in range(4)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise PhaseFailed(f"podscan exit codes {rcs}")
    subprocess.run([sys.executable, "-m", "bulklmm_tpu", "merge-shards",
                    "--shards-dir", str(shards),
                    "-o", str(workdir / "merged.npz")],
                   env=env, check=True, timeout=600)
    return np.load(workdir / "merged.npz")["L"]


def four_gpus():
    # the platform check runs in a child so that this process holds no
    # card while the pods below each open theirs
    plat, count = probe_gpus()
    if plat != "gpu" or count < 4:
        print(f"needs 4 GPUs; JAX found {count} {plat} device(s)",
              file=sys.stderr)
        sys.exit(2)
    G, K, Y = synth()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pod_L = _pods(G, K, Y, Path(tmp))
        pod_s = time.perf_counter() - t0

    import jax

    from bulklmm_tpu.utils.cache import use_compile_cache

    cache = use_compile_cache()
    jax.config.update("jax_enable_x64", True)
    devs = require_gpus(4)
    import numpy as np

    import bulklmm_tpu as bl
    from bulklmm_tpu.parallel import (
        bulkscan_perms_sharded, bulkscan_sharded, make_mesh,
    )
    from bulklmm_tpu.utils.config import BALANCED

    print(f"card: {card_line()}")
    print(f"jax {jax.__version__}; devices: {devs[0].device_kind} "
          f"x{len(devs)}; compile cache: {cache}", flush=True)
    Gd = jax.device_put(G, devs[0])
    Yd = jax.device_put(Y, devs[0])
    one_L = np.asarray(bl.bulkscan(Yd, Gd, K, precision=BALANCED).L)
    one_perm = np.asarray(bl.bulkscan_perms(Yd, Gd, K, nperms=NPERMS,
                                            precision=BALANCED).maxlods)
    check("podscan_4proc_merge", got=pod_L, ref=one_L, tol=TOL,
          ref_name="one_card", seconds=pod_s, precision="BALANCED",
          processes=4,
          note="seconds include process start and compile")
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(4, marker_shards=shape[1])
        s, res = warm(lambda: bulkscan_sharded(Y, G, K, mesh=mesh,
                                               precision=BALANCED).L)
        cards = {sh.device.id for sh in res.addressable_shards}
        check(f"bulkscan_sharded_{shape[0]}x{shape[1]}", got=res, ref=one_L,
              tol=TOL, seconds=s, precision="BALANCED", ref_name="one_card",
              cards_holding_shards=sorted(cards))
        if len(cards) != 4:
            raise PhaseFailed(f"shards on cards {sorted(cards)}, not 4")
        s, pr = warm(lambda: bulkscan_perms_sharded(
            Y, G, K, mesh=mesh, nperms=NPERMS, precision=BALANCED).maxlods)
        cards = {sh.device.id for sh in pr.addressable_shards}
        check(f"bulkscan_perms_sharded_{shape[0]}x{shape[1]}", got=pr,
              ref=one_perm, tol=TOL, seconds=s, precision="BALANCED",
              ref_name="one_card",
              cards_holding_shards=sorted(cards))
        if len(cards) != 4:
            raise PhaseFailed(f"shards on cards {sorted(cards)}, not 4")
    return devs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-card sharded and pod paths")
    args = ap.parse_args()
    try:
        devs = four_gpus() if args.four_gpus else one_gpu()
    except PhaseFailed as e:
        print(f"FAILED phase: {e}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
