"""Subprocess worker for the multi-process distributed tests.

Each instance is one "host" of a pod: it initializes jax.distributed against
the shared coordinator, loads ONLY its trait block from the fixture file,
runs :func:`bulklmm_tpu.parallel.bulkscan_distributed`, and writes its own
LOD shard — the full per-host feeding path of a real multi-host run
(the reference defers distribution entirely,
reference README.md:66-72).

Usage: mp_worker.py <coordinator> <nproc> <pid> <data.npz> <outdir> <method>
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    coord, nproc, pid, data_path, outdir, method = sys.argv[1:7]

    import jax

    # workers run on the CPU (see tests/conftest.py)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(nproc),
        process_id=int(pid),
    )

    from bulklmm_tpu.parallel import (
        bulkscan_distributed,
        local_trait_slice,
        make_global_mesh,
    )

    d = np.load(data_path)
    Y, G, K = d["Y"], d["G"], d["K"]
    if method.startswith("lowrank:"):
        # rank-k pod path: host-exact eigenpairs are deterministic, so every
        # process builds the identical LowRankKinship from the replicated K
        method = method.split(":", 1)[1]
        from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact

        K = kinship_lowrank_exact(K, 16)
    mesh = make_global_mesh()
    assert len(mesh.devices.ravel()) == jax.device_count()

    sl = local_trait_slice(Y.shape[1], mesh)
    if method.startswith("perms_ckpt:"):
        # pod-level checkpointed sweep (kill-and-resume test): each
        # process owns its checkpoint subdirectory; many small trait
        # chunks widen the mid-sweep kill window
        ck_base = method.split(":", 1)[1]
        from bulklmm_tpu.parallel import bulkscan_perms_distributed

        res, lo, hi = bulkscan_perms_distributed(
            Y[:, sl], G, K,
            m_total=Y.shape[1], mesh=mesh, save_dir=outdir,
            nperms=199, rndseed=7, trait_chunk=1,
            checkpoint=f"{ck_base}/p{pid}",
        )
        print(f"worker {pid}: wrote checkpointed perm traits [{lo}, {hi})")
        return
    if method == "perms":
        # pod permutation thresholds: each process tests only its trait
        # block; shuffle indices are identical across processes
        from bulklmm_tpu.parallel import bulkscan_perms_distributed

        res, lo, hi = bulkscan_perms_distributed(
            Y[:, sl], G, K,
            m_total=Y.shape[1], mesh=mesh, save_dir=outdir,
            nperms=24, rndseed=7,
        )
        assert lo == sl.start and hi == (sl.stop or Y.shape[1])
        assert res.maxlods.shape == (hi - lo, 25)
        print(f"worker {pid}: wrote perm traits [{lo}, {hi})")
        return
    res = bulkscan_distributed(
        Y[:, sl], G, K,
        m_total=Y.shape[1], mesh=mesh, method=method,
        h2_grid=np.arange(0.0, 0.91, 0.1),
        save_dir=outdir,
    )
    assert res.trait_lo == sl.start and res.trait_hi == (sl.stop or Y.shape[1])
    assert res.L_local.shape == (G.shape[1], res.trait_hi - res.trait_lo)
    print(f"worker {pid}: wrote traits [{res.trait_lo}, {res.trait_hi})")


if __name__ == "__main__":
    main()
