"""Command-line interface: kinship / scan / bulkscan from CSV files.

The reference has no CLI (driven from the Julia REPL, reference
README.md:99-361); this is an addition for production use. ``kinship`` and
``scan`` write CSV or ``.npz``; ``bulkscan`` writes ``.npz`` (multiple
arrays). ``--kinship`` feeds a precomputed kinship (dense or rank-k
factors) back into scan/bulkscan.

  python -m bulklmm_tpu kinship --geno geno.csv -o kinship.csv
  python -m bulklmm_tpu scan --geno geno.csv --pheno pheno.csv --trait 1112 \
      --nperms 1000 -o scan1112.csv
  python -m bulklmm_tpu bulkscan --geno geno.csv --pheno pheno.csv \
      --method null-grid -o lods.npz
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_geno(args):
    from . import io as bio

    if args.geno.endswith(".npz"):
        return np.load(args.geno)["geno"]
    if args.exclude_complements:
        return bio.read_geno_prob_exclude_complements(args.geno)
    return bio.read_geno_prob(args.geno)


def _load_pheno(args):
    from . import io as bio

    if args.pheno.endswith(".npz"):
        return np.load(args.pheno)["pheno"]
    return bio.read_bxd_pheno(args.pheno)


def _resolve_precision(args):
    """Map --precision to a PrecisionConfig, enabling x64 first when needed
    (must happen before any array work, kinship included)."""
    from .utils.config import BALANCED, EXACT64, FAST32, MIXED, THROUGHPUT

    precision = {
        "fast32": FAST32, "balanced": BALANCED, "mixed": MIXED,
        "exact64": EXACT64, "throughput": THROUGHPUT,
    }[args.precision]
    if args.precision not in ("fast32", "throughput"):
        import jax

        jax.config.update("jax_enable_x64", True)
    return precision


def _kinship(args):
    precision = _resolve_precision(args)
    from . import calc_kinship
    from . import io as bio

    G = _load_geno(args)
    if getattr(args, "lowrank_k", 0):
        # rank-k factors: the n x n kinship is never materialized
        if not args.output.endswith(".npz"):
            raise SystemExit("--lowrank-k output must be .npz (U, lam fields)")
        from . import kinship_lowrank_from_geno

        lr = kinship_lowrank_from_geno(G, args.lowrank_k, precision=precision)
        np.savez_compressed(
            args.output, U=np.asarray(lr.U), lam=np.asarray(lr.lam)
        )
        print(f"kinship rank-{lr.rank} factors ({lr.n} x {lr.rank}) "
              f"-> {args.output}")
        return
    K = np.asarray(calc_kinship(G))
    if args.output.endswith(".npz"):
        np.savez_compressed(args.output, kinship=K)
    else:
        bio.write_to_file(K, args.output)
    print(f"kinship {K.shape} -> {args.output}")


def _load_kinship(args, G, precision):
    """Kinship from --kinship (a file previously written by the kinship
    subcommand: dense CSV/.npz, or rank-k U/lam factors from
    ``kinship --lowrank-k``) — or computed from the genotypes. A dense
    file combined with --lowrank-k is factored to rank k (device
    randomized eigen) rather than silently running full-rank."""
    from . import calc_kinship

    k = getattr(args, "lowrank_k", 0)
    f = getattr(args, "kinship", None)
    if f:
        if f.endswith(".npz"):
            z = np.load(f)
            if "U" in z:  # rank-k factors
                from .ops.lowrank import LowRankKinship

                return LowRankKinship(U=z["U"], lam=z["lam"])
            K = z["kinship"]
        else:
            K = np.loadtxt(f, delimiter=",")
        if k:
            from . import kinship_lowrank

            return kinship_lowrank(K, k, precision=precision)
        return K
    return np.asarray(calc_kinship(G))


def _loco_chrom(args, p):
    """Chromosome labels for --loco from the marker map (--gmap)."""
    from . import read_gmap

    if not args.gmap:
        raise SystemExit("--loco requires --gmap (marker map with Chr column)")
    chrom = read_gmap(args.gmap).chromosome
    if chrom.shape[0] != p:
        raise SystemExit(
            f"--gmap has {chrom.shape[0]} markers but the genotype file has {p}"
        )
    return chrom


def _scan(args):
    precision = _resolve_precision(args)
    from . import get_thresholds, scan, scan_loco
    from . import io as bio

    G = _load_geno(args)
    Y = _load_pheno(args)
    y = Y[:, args.trait]
    kwargs = dict(
        reml=args.reml,
        assumption=args.assumption,
        permutation_test=args.nperms > 0,
        nperms=max(args.nperms, 1),
        rndseed=args.seed,
        output_pvals=args.pvals,
        output_effects=args.effects,
        precision=precision,
        missing=args.missing,
    )
    if args.loco and getattr(args, "kinship", None):
        raise SystemExit(
            "--loco builds per-chromosome leave-out kinships from the "
            "genotypes; --kinship cannot be combined with it"
        )
    if args.loco:
        res = scan_loco(
            y, G, _loco_chrom(args, G.shape[1]),
            lowrank_k=getattr(args, "lowrank_k", 0), **kwargs,
        )
    elif getattr(args, "lowrank_k", 0) and not getattr(args, "kinship", None):
        # rank-k engine: no n x n kinship, no host eigh (ops/lowrank.py)
        from . import kinship_lowrank_from_geno

        K = kinship_lowrank_from_geno(G, args.lowrank_k, precision=precision)
        res = scan(y, G, K, **kwargs)
    else:
        res = scan(y, G, _load_kinship(args, G, precision), **kwargs)
    out = {"lod": np.asarray(res.lod)}
    if args.effects:
        out["beta"] = np.asarray(res.beta)
        out["beta_se"] = np.asarray(res.beta_se)
    meta = {
        "trait": args.trait,
        "h2_null": float(res.h2_null),
        "sigma2_e": float(res.sigma2_e),
    }
    if getattr(res, "h2_null_by_chrom", None):
        # LOCO: h2_null above is the across-chromosome mean
        meta["h2_null_by_chrom"] = {
            str(c): float(v) for c, v in res.h2_null_by_chrom.items()
        }
    if args.nperms > 0:
        thr = get_thresholds(res.L_perms, [0.10, 0.05, 0.01])
        meta["thresholds"] = dict(zip(["0.10", "0.05", "0.01"], map(float, thr.thrs)))
    if args.pvals:
        out["log10pvals"] = np.asarray(res.log10pvals)
    if args.output.endswith(".npz"):
        np.savez_compressed(args.output, **out)
    else:
        cols = np.column_stack(list(out.values()))
        bio.write_to_file(cols, args.output)
    print(json.dumps(meta))


def _make_cli_mesh(args):
    """Mesh over the visible devices for --sharded (optionally splitting a
    model-parallel markers axis with --marker-shards)."""
    from .parallel import make_mesh

    return make_mesh(marker_shards=args.marker_shards or None)


def _bulkscan(args):
    precision = _resolve_precision(args)
    from . import bulkscan, bulkscan_loco

    if not args.output.endswith(".npz"):
        raise SystemExit(
            "bulkscan writes multiple arrays; -o/--output must end in .npz"
        )
    sharded = args.sharded
    stream = args.stream_markers
    if args.loco and stream:
        raise SystemExit(
            "--loco does not compose with --stream-markers; use --sharded "
            "or stream via the Python API"
        )
    if getattr(args, "checkpoint_every", 1) != 1:
        # fail BEFORE compute: outside the marker-streamed checkpointed
        # permutation sweep the flag would be silently ignored
        if not stream:
            raise SystemExit(
                "--checkpoint-every applies only to the marker-streamed "
                "permutation sweep; add --stream-markers BLOCK or drop "
                "the flag"
            )
        if args.nperms <= 0:
            raise SystemExit(
                "--checkpoint-every applies only to the permutation "
                "sweep; add --nperms N or drop the flag"
            )
        if not args.resume:
            raise SystemExit(
                "--checkpoint-every needs a checkpoint directory; add "
                "--resume DIR or drop the flag"
            )
    mesh = _make_cli_mesh(args) if sharded else None
    G = _load_geno(args)
    Y = _load_pheno(args)
    kwargs = dict(
        method=args.method,
        reml=args.reml,
        precision=precision,
        trait_chunk=args.trait_chunk,
        output_pvals=args.pvals,
        output_effects=args.effects,
        missing=args.missing,
    )
    if args.loco and getattr(args, "kinship", None):
        raise SystemExit(
            "--loco builds per-chromosome leave-out kinships from the "
            "genotypes; --kinship cannot be combined with it"
        )
    K = None
    chrom = _loco_chrom(args, G.shape[1]) if args.loco else None
    if args.loco:
        res = bulkscan_loco(
            Y, G, chrom, mesh=mesh,
            lowrank_k=getattr(args, "lowrank_k", 0), **kwargs,
        )
    else:
        if getattr(args, "lowrank_k", 0) and not getattr(args, "kinship", None):
            # rank-k engine (ops/lowrank.py): no n x n kinship, no host eigh
            from . import kinship_lowrank_from_geno

            K = kinship_lowrank_from_geno(
                G, args.lowrank_k, precision=precision
            )
        else:
            K = _load_kinship(args, G, precision)
            from .ops.lowrank import LowRankKinship
            from .ops.rotation import decompose_kinship

            if not isinstance(K, LowRankKinship):
                # one decomposition serves the scan AND the permutation
                # engine below — a raw K would pay the O(n^3) eigh twice
                K = decompose_kinship(np.asarray(K))
        if stream:
            # host-resident genotype panel streamed in marker blocks;
            # composes with --sharded (per-block kernels run on the mesh)
            from . import bulkscan_streamed

            skw = dict(kwargs)
            skw.pop("trait_chunk")  # size marker blocks instead
            res = bulkscan_streamed(
                Y, G, K, marker_block=stream, mesh=mesh, **skw
            )
        elif mesh is not None:
            from .parallel import bulkscan_sharded

            res = bulkscan_sharded(Y, G, K, mesh=mesh, **kwargs)
        else:
            res = bulkscan(Y, G, K, **kwargs)
    out = {"L": np.asarray(res.L)}
    if args.effects:
        out["beta"] = np.asarray(res.beta_mat)
        out["beta_se"] = np.asarray(res.beta_se_mat)
    if res.h2_null_list is not None:
        out["h2_null_list"] = np.asarray(res.h2_null_list)
    if res.h2_panel is not None:
        out["h2_panel"] = np.asarray(res.h2_panel)
    if getattr(res, "h2_null_by_chrom", None):
        # LOCO: the null h2 is chromosome-specific — one (m,) array (or
        # (p_c, m) panel for alt-grid) per chromosome
        for c, v in res.h2_null_by_chrom.items():
            out[f"h2_null_chr{c}"] = np.asarray(v)
    if args.pvals:
        out["log10Pvals"] = np.asarray(res.log10Pvals_mat)
    if args.nperms > 0:
        # all-trait permutation FWER thresholds (models/bulkperm.py);
        # with --loco, per-chromosome maxima stitched via elementwise max
        # (models/loco.py::bulkscan_perms_loco)
        from . import bulkscan_perms, bulkscan_perms_loco, get_thresholds_bulk

        perm_kwargs = dict(
            nperms=args.nperms, rndseed=args.seed,
            method=args.method if args.method != "alt-grid" else "null-grid",
            # the permutation sweep must run under the SAME likelihood
            # criterion as the scan — REML thresholds for an ML scan (or
            # vice versa) would be silently inconsistent
            reml=args.reml,
            precision=precision,
            missing=args.missing,
        )
        if args.resume:
            perm_kwargs["checkpoint"] = args.resume
            if args.trait_chunk is not None:
                perm_kwargs["trait_chunk"] = args.trait_chunk
        if stream and getattr(args, "checkpoint_every", 1) != 1:
            perm_kwargs["checkpoint_every"] = args.checkpoint_every
        if args.loco:
            # checkpoint (if any) fans out to per-chromosome subdirectories
            pr = bulkscan_perms_loco(
                Y, G, chrom, mesh=mesh,
                lowrank_k=getattr(args, "lowrank_k", 0), **perm_kwargs,
            )
        elif stream:
            # composes with --sharded: per-block chunk cores run on the
            # mesh (models/streaming.py::_perms_streamed_sharded)
            from . import bulkscan_perms_streamed

            pr = bulkscan_perms_streamed(
                Y, G, K, marker_block=stream, mesh=mesh, **perm_kwargs
            )
        elif mesh is not None:
            from .parallel import bulkscan_perms_sharded

            pr = bulkscan_perms_sharded(Y, G, K, mesh=mesh, **perm_kwargs)
        else:
            # K from the scan branch above: dense, or rank-k with
            # --lowrank-k (bulkscan_perms runs the Woodbury whitening path)
            pr = bulkscan_perms(Y, G, K, **perm_kwargs)
        thr = get_thresholds_bulk(pr.perm_maxima, [0.10, 0.05, 0.01])
        out["perm_maxlods"] = np.asarray(pr.maxlods)
        out["thresholds"] = thr.thrs  # (3, m): rows = 0.10 / 0.05 / 0.01
        out["log10_adj_pvals"] = np.asarray(pr.log10_adj_pvals)
    np.savez_compressed(args.output, **out)
    print(f"bulkscan {out['L'].shape} ({args.method}) -> {args.output}")


def _podscan(args):
    """One process of a multi-host (pod) run: jax.distributed handshake,
    local trait block in, per-process shard file out (no host ever gathers
    the full matrix). Every host runs the same command with its own --pid."""
    precision = _resolve_precision(args)
    from pathlib import Path

    from .parallel import (
        bulkscan_distributed,
        bulkscan_perms_distributed,
        init_distributed,
        local_trait_slice,
        make_global_mesh,
    )

    if (args.coordinator is not None) != (args.nproc is not None) or (
        args.coordinator is not None
    ) != (args.pid is not None):
        raise SystemExit(
            "--coordinator/--nproc/--pid must be given together (or all "
            "omitted for a single-process run)"
        )
    if getattr(args, "loco", False) or getattr(args, "gmap", None):
        raise SystemExit(
            "podscan does not support --loco/--gmap yet; run per-chromosome "
            "pods or use bulkscan --loco --sharded on one host"
        )
    pid = init_distributed(
        args.coordinator, args.nproc, args.pid,
        local_device_ids=args.local_device,
    )
    save_dir = args.save_shards or str(Path(args.output).parent)

    G = _load_geno(args)
    Y = _load_pheno(args)
    if getattr(args, "missing", "error") != "error":
        finite = np.isfinite(np.asarray(Y, dtype=np.float64))
        if not finite.all():
            if args.missing == "mask":
                raise SystemExit(
                    "podscan supports --missing drop only: per-trait "
                    "pattern masking changes the row geometry per trait, "
                    "which does not compose with the pod's fixed trait "
                    "sharding. Run bulkscan --missing mask on one host, "
                    "or --missing drop here."
                )
            # listwise drop from the FULL trait matrix — every process
            # loads the same phenotype file, so the row set is identical
            # across the pod
            rows = finite.all(axis=1)
            Y = np.asarray(Y)[rows]
            G = np.asarray(G)[rows]
            drop_rows = np.flatnonzero(rows)
        else:
            drop_rows = None
    else:
        drop_rows = None
    mesh = make_global_mesh()
    sl = local_trait_slice(Y.shape[1], mesh)
    if getattr(args, "lowrank_k", 0) and not getattr(args, "kinship", None):
        # rank-k factors straight from genotypes — the pod-scale cohorts
        # this subcommand targets are exactly where a dense n x n kinship
        # and its host eigh stop being an option (built from the already-
        # subset G when --missing drop removed rows)
        from . import kinship_lowrank_from_geno

        K = kinship_lowrank_from_geno(G, args.lowrank_k, precision=precision)
    else:
        K = _load_kinship(args, G, precision)
        kn = (
            K.Ut.shape[0] if hasattr(K, "Ut")
            else K.U.shape[0] if hasattr(K, "U")
            else np.shape(K)[0]
        )
        if drop_rows is not None and kn != G.shape[0]:
            # a --kinship FILE still covers the full cohort: subset it to
            # the dropped-row geometry (type-preserving — raw matrix,
            # decomposition, or rank-k factors)
            from .models.missing import subset_kinship

            K = subset_kinship(K, drop_rows)

    if args.nperms > 0:
        _, lo, hi = bulkscan_perms_distributed(
            Y[:, sl], G, K, m_total=Y.shape[1], mesh=mesh,
            save_dir=save_dir, nperms=args.nperms, rndseed=args.seed,
            method=args.method, reml=args.reml, precision=precision,
        )
        shard = f"perm_shard_{pid:05d}.npz"
    else:
        res = bulkscan_distributed(
            Y[:, sl], G, K, m_total=Y.shape[1], mesh=mesh,
            method=args.method, reml=args.reml, precision=precision,
            save_dir=save_dir,
        )
        lo, hi = res.trait_lo, res.trait_hi
        shard = f"lod_shard_{pid:05d}.npz"
    print(json.dumps({
        "pid": pid, "traits": [int(lo), int(hi)],
        "shard": str(Path(save_dir) / shard),
    }))


def _merge_shards(args):
    from .parallel import merge_perm_shards, merge_shards

    if args.perms:
        maxlods = merge_perm_shards(args.shards_dir)
        from . import get_thresholds_bulk

        # merged maxima are (m, 1 + nperms) with the unpermuted column
        # first (original=True default); replicates are columns 1:
        thr = get_thresholds_bulk(maxlods[:, 1:], [0.10, 0.05, 0.01])
        np.savez_compressed(
            args.output, perm_maxlods=maxlods, thresholds=thr.thrs
        )
        print(f"merged perm maxima {maxlods.shape} -> {args.output}")
    else:
        L = merge_shards(args.shards_dir)
        np.savez_compressed(args.output, L=L)
        print(f"merged LODs {L.shape} -> {args.output}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bulklmm_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, pheno=True):
        p.add_argument("--geno", required=True, help="genotype-prob CSV or .npz")
        p.add_argument(
            "--exclude-complements", action="store_true",
            help="keep only odd genotype-prob columns (complement pairs)",
        )
        if pheno:
            p.add_argument("--pheno", required=True, help="phenotype CSV or .npz")
        p.add_argument("-o", "--output", required=True)
        p.add_argument(
            "--precision",
            choices=["fast32", "balanced", "mixed", "exact64", "throughput"],
            default="balanced",
            help="numerics preset (utils/config.py): throughput = the "
            "Precision.HIGH screening tier (TF32 in XLA on a GPU, three-pass "
            "bf16 in the fused kernels)",
        )
        p.add_argument(
            "--lowrank-k", type=int, default=0,
            help="use the rank-k kinship engine (no n x n kinship / host "
            "eigh); 0 = full-rank (default)",
        )
        if pheno:
            p.add_argument(
                "--missing", choices=["error", "mask", "drop"],
                default="error",
                help="NaN-phenotype policy: error (default), mask "
                "(per-trait complete-case, pattern-grouped), or drop "
                "(listwise deletion). See COMPAT.md #18",
            )
            p.add_argument(
                "--loco", action="store_true",
                help="leave-one-chromosome-out kinship (needs --gmap)",
            )
            p.add_argument("--gmap", help="marker map CSV (Locus,Chr,cM,Mb)")
            p.add_argument(
                "--kinship",
                help="precomputed kinship from the kinship subcommand "
                "(CSV/.npz dense, or rank-k U/lam .npz factors) instead of "
                "recomputing from the genotypes",
            )

    k = sub.add_parser("kinship", help="kinship matrix from genotype probs")
    common(k, pheno=False)
    k.set_defaults(fn=_kinship)

    s = sub.add_parser("scan", help="single-trait genome scan")
    common(s)
    s.add_argument("--trait", type=int, default=0, help="0-based trait column")
    s.add_argument("--assumption", choices=["null", "alt"], default="null")
    s.add_argument("--reml", action="store_true")
    s.add_argument("--nperms", type=int, default=0, help=">0 enables permutation test")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--pvals", action="store_true")
    s.add_argument(
        "--effects", action="store_true",
        help="also output per-marker GLS effect sizes + Wald SEs",
    )
    s.set_defaults(fn=_scan)

    b = sub.add_parser("bulkscan", help="all-trait genome scan")
    common(b)
    b.add_argument(
        "--method", choices=["null-grid", "null-exact", "alt-grid"],
        default="null-grid",
    )
    b.add_argument("--reml", action="store_true")
    b.add_argument("--trait-chunk", type=int, default=None)
    b.add_argument("--pvals", action="store_true")
    b.add_argument(
        "--nperms", type=int, default=0,
        help=">0 adds per-trait permutation FWER thresholds "
        "(perm_maxlods/thresholds/log10_adj_pvals in the .npz); "
        "composes with --loco",
    )
    b.add_argument("--seed", type=int, default=0)
    b.add_argument(
        "--effects", action="store_true",
        help="also output (p, m) GLS effect sizes + Wald SEs (null methods)",
    )
    b.add_argument(
        "--resume", metavar="DIR", default=None,
        help="with --nperms: write per-trait-chunk checkpoints to DIR and "
        "resume any found there (a preempted sweep continues where it "
        "stopped; config or input-data mismatches are refused)",
    )
    b.add_argument(
        "--checkpoint-every", type=int, default=1, metavar="N",
        help="with --nperms --stream-markers --resume: persist the "
        "running-max accumulator every N marker blocks instead of every "
        "block (each save syncs the device and rewrites the full state; "
        "raise for biobank-scale sweeps)",
    )
    b.add_argument(
        "--sharded", action="store_true",
        help="run on a device mesh over all visible chips "
        "(traits data-parallel; see --marker-shards)",
    )
    b.add_argument(
        "--marker-shards", type=int, default=0,
        help="with --sharded: split off a model-parallel markers axis "
        "(must divide the device count; 0 = traits-only mesh)",
    )
    b.add_argument(
        "--stream-markers", type=int, default=0, metavar="BLOCK",
        help="stream the genotype panel through the device in marker "
        "blocks of this width (for p beyond one HBM); composes with "
        "--sharded",
    )
    b.set_defaults(fn=_bulkscan)

    pd = sub.add_parser(
        "podscan",
        help="one process of a multi-host (pod) bulkscan: every host runs "
        "this with the same --coordinator/--nproc and its own --pid, each "
        "writes its own LOD shard; assemble with merge-shards",
    )
    common(pd)
    pd.add_argument(
        "--method", choices=["null-grid", "null-exact", "alt-grid"],
        default="null-grid",
    )
    pd.add_argument("--reml", action="store_true")
    pd.add_argument(
        "--coordinator", default=None,
        help="host:port of process 0 (maps to jax.distributed); omit for a "
        "single-process run",
    )
    pd.add_argument("--nproc", type=int, default=None)
    pd.add_argument("--pid", type=int, default=None)
    pd.add_argument(
        "--local-device", type=int, action="append", default=None,
        metavar="ID",
        help="local device id this process owns (repeatable); with several "
        "processes on one host, give each its own card",
    )
    pd.add_argument(
        "--save-shards", default=None,
        help="directory for per-process lod_shard_<pid>.npz files "
        "(default: the -o directory)",
    )
    pd.add_argument(
        "--nperms", type=int, default=0,
        help=">0 runs the distributed permutation engine instead, writing "
        "perm_shard_<pid>.npz per process",
    )
    pd.add_argument("--seed", type=int, default=0)
    pd.set_defaults(fn=_podscan)

    mg = sub.add_parser(
        "merge-shards",
        help="assemble podscan shard files into one .npz",
    )
    mg.add_argument("--shards-dir", required=True)
    mg.add_argument("-o", "--output", required=True)
    mg.add_argument(
        "--perms", action="store_true",
        help="merge perm_shard_*.npz (permutation maxima) instead of LODs",
    )
    mg.set_defaults(fn=_merge_shards)

    args = ap.parse_args(argv)
    from .utils.cache import use_compile_cache

    use_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
