"""Production multi-chip workflow: sharded scans, preemption-safe
permutation sweeps, and the pod launch pattern.

The reference runs one multicore node and defers distribution to future
work (reference README.md:66-72). This example shows the operational
surface a production deployment uses on a multi-GPU host:

  1. a (traits x markers) device mesh over every visible chip;
  2. the full bulkscan on the mesh, with per-device memory bounded by
     trait_chunk;
  3. a genotype panel streamed from a host memmap THROUGH the mesh
     (p beyond one chip's HBM, scaled over all chips at once);
  4. an all-trait permutation sweep with checkpoint=DIR — kill it at any
     point and re-running the same command resumes from the last
     completed trait chunk;
  5. what a multi-host pod launch looks like (one command per host;
     shard files merged offline).

Runs in seconds on the 8-device virtual CPU mesh:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/production_sweep.py
"""

import os
import tempfile

# virtual multi-chip setup when no real mesh is attached (set BEFORE jax)
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

if os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

import bulklmm_tpu as bl
from bulklmm_tpu.parallel import (
    bulkscan_perms_sharded,
    bulkscan_sharded,
    make_mesh,
)

rng = np.random.default_rng(7)
n, p, m = 64, 400, 48
G = rng.choice([0.0, 0.5, 1.0], size=(n, p))
K = np.asarray(bl.calc_kinship(G))
Y = rng.normal(size=(n, m))
Y[:, 3] += 2.5 * (G[:, 123] - G[:, 123].mean())

# 1. mesh over every visible device; split a model-parallel markers axis
mesh = make_mesh(marker_shards=2)
print(f"mesh: {dict(mesh.shape)} over {mesh.devices.size} devices")

# 2. full scan on the mesh; trait_chunk bounds per-device peak memory the
#    same way the single-device engines chunk
res = bulkscan_sharded(Y, G, K, mesh=mesh, trait_chunk=16)
print("sharded bulkscan:", res.L.shape, "peak LOD",
      float(np.max(np.asarray(res.L))))

# 3. marker panel streamed from a host memmap, each block sharded over the
#    mesh (the p-beyond-one-HBM axis and the multi-chip axis together)
with tempfile.TemporaryDirectory() as td:
    mm = np.memmap(os.path.join(td, "geno.dat"), dtype=np.float32,
                   mode="w+", shape=(n, p))
    mm[:] = G
    st = bl.bulkscan_streamed(Y, mm, K, marker_block=128, mesh=mesh)
    print("streamed-on-mesh max|diff| vs in-memory:",
          float(np.max(np.abs(np.asarray(st.L) - np.asarray(res.L)))))

    # 4. preemption-safe permutation sweep: per-trait-chunk maxima persist;
    #    re-running the same call resumes (kill-and-resume tested in
    #    tests/test_bulkperm.py). CLI: bulkscan --nperms N --resume DIR
    ck = os.path.join(td, "ckpt")
    pr = bulkscan_perms_sharded(
        Y, G, K, mesh=mesh, nperms=99, rndseed=11, trait_chunk=16,
        checkpoint=ck,
    )
    thr = bl.get_thresholds_bulk(pr.perm_maxima, [0.10, 0.05])
    print("perm sweep:", pr.maxlods.shape, "chunks on disk:",
          len([f for f in os.listdir(ck) if f.startswith("maxlods_")]))
    print("trait-3 alpha=0.05 threshold", float(thr.thrs[1, 3]),
          "observed max", float(pr.lod_max[3]))

# 5. pod launch (multi-host): every host runs ONE process with its own
#    --pid; each writes only its own shard; merge offline. Shown as the
#    commands a launcher issues (subprocess-tested in tests/test_cli.py):
print("""
pod launch pattern (one line per host):
  python -m bulklmm_tpu podscan --geno geno.csv --pheno pheno.csv \\
      --coordinator host0:1234 --nproc 4 --pid $I \\
      --save-shards /shared/shards -o /shared/run.npz
  python -m bulklmm_tpu merge-shards --shards-dir /shared/shards \\
      -o /shared/lods.npz
""")
