"""Biobank-scale permutation thresholds, end to end — the rank-k pipeline.

Past the host-eigh wall (n >= ~20k individuals) the full-rank workflow's
O(n^3) eigendecomposition and (n, n) eigenvector upload dominate everything
else. This example runs the whole FWER-threshold pipeline without EVER
materializing an n x n kinship:

  1. rank-k kinship factors straight from genotypes (device randomized
     eigen — GEMMs only, ops/lowrank.py);
  2. all-trait genome scan on the Woodbury engine;
  3. all-trait permutation null maxima + per-trait FWER thresholds +
     genome-wide adjusted p-values on the rank-k whitening engine
     (A_j = I + U diag(sqrt(w_j)-1) U^T applied implicitly);
  4. the same thresholds with the marker panel streamed from a host
     memmap (p beyond device HBM).

Shapes are scaled down so the example runs in seconds on CPU; every call
is the identical API used at cohort scale.

  python examples/biobank_thresholds.py
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bulklmm_tpu as bl  # noqa: E402


def main():
    rng = np.random.default_rng(7)
    n, p, m, k = 400, 600, 12, 64

    # structured genotypes -> kinship with a realistic decaying spectrum
    founders = rng.uniform(0, 1, (24, p)).astype(np.float32)
    mix = rng.dirichlet(np.ones(24) * 0.3, size=n).astype(np.float32)
    G = np.clip(mix @ founders + 0.05 * rng.normal(size=(n, p)), 0, 1)
    G = G.astype(np.float32)
    Y = rng.normal(size=(n, m)).astype(np.float32)
    Y[:, 3] += 2.0 * (G[:, 123] - G[:, 123].mean())  # planted signal

    # 1. rank-k kinship factors: K never exists as an (n, n) matrix
    lr = bl.kinship_lowrank_from_geno(G, k)
    print(f"rank-{lr.rank} kinship factors: U {lr.U.shape}, no n x n matrix")

    # 2. all-trait scan on the Woodbury engine
    res = bl.bulkscan(Y, G, lr)
    print(f"bulkscan L {res.L.shape}; trait 3 peak at marker "
          f"{int(np.argmax(np.asarray(res.L)[:, 3]))}")

    # 3. all-trait permutation FWER thresholds on the rank-k whitening
    pr = bl.bulkscan_perms(Y, G, lr, nperms=200, rndseed=1)
    thr = bl.get_thresholds_bulk(pr.perm_maxima, [0.10, 0.05])
    adj = np.asarray(pr.log10_adj_pvals)
    print(f"thresholds (alpha=0.05): {np.round(np.asarray(thr.thrs)[1], 2)}")
    print(f"adjusted -log10 p: {np.round(adj, 2)} "
          f"(most significant: trait {int(np.argmax(adj))})")

    # 4. identical thresholds with the marker panel streamed from a memmap
    with tempfile.TemporaryDirectory() as d:
        mm = np.memmap(Path(d) / "geno.dat", dtype=np.float32, mode="w+",
                       shape=G.shape)
        mm[:] = G
        mm.flush()
        pr2 = bl.bulkscan_perms_streamed(
            Y, mm, lr, nperms=200, rndseed=1, marker_block=256
        )
        diff = float(np.max(np.abs(
            np.asarray(pr2.maxlods) - np.asarray(pr.maxlods)
        )))
    print(f"streamed-from-memmap maxima match in-memory: max|diff| = {diff:.2e}")


if __name__ == "__main__":
    main()
