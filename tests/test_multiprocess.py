"""True multi-process execution tests: N separate jax.distributed processes
(2 CPU devices each) compute a trait-sharded bulkscan where every process
feeds only its own trait block, and the merged per-process shards must equal
the single-process engine to 1e-9.

This executes the multi-host path the reference defers to future work
(reference README.md:66-72) — process handshake, per-host input assembly via
``jax.make_array_from_process_local_data``, SPMD execution, and independent
per-process shard output.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "mp_worker.py"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _synth(seed=11, n=40, p=30, m=10):
    rng = np.random.default_rng(seed)
    G = rng.uniform(0, 1, (n, p))
    X = G - 0.5
    K = 2.0 * X @ X.T / p + 0.5
    np.fill_diagonal(K, 1.0)
    Y = rng.normal(size=(n, m))
    Y[:, 0] += 0.8 * (G[:, 3] - G[:, 3].mean())
    return Y, G, K


def _worker_env(devices_per_proc: int) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices_per_proc}"
    )
    return env


def _run_pod(nproc: int, method: str, tmp_path, m=10, devices_per_proc=2):
    Y, G, K = _synth(m=m)
    data = tmp_path / "data.npz"
    np.savez(data, Y=Y, G=G, K=K)
    outdir = tmp_path / "shards"
    coord = f"127.0.0.1:{_free_port()}"
    env = _worker_env(devices_per_proc)

    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), coord, str(nproc), str(i),
             str(data), str(outdir), method],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"

    shard_files = sorted(outdir.glob("lod_shard_*.npz"))
    assert len(shard_files) == nproc, "each process must write its own shard"
    return Y, G, K, outdir


@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_bulkscan_matches_single_process(nproc, tmp_path):
    Y, G, K, outdir = _run_pod(nproc, "null-grid", tmp_path)

    from bulklmm_tpu import bulkscan
    from bulklmm_tpu.parallel import merge_shards

    merged = merge_shards(outdir)
    single = np.asarray(
        bulkscan(Y, G, K, method="null-grid", h2_grid=np.arange(0.0, 0.91, 0.1)).L
    )
    assert merged.shape == single.shape
    assert float(np.max(np.abs(merged - single))) < 1e-9


def test_multiprocess_alt_grid_matches_single_process(tmp_path):
    Y, G, K, outdir = _run_pod(2, "alt-grid", tmp_path, m=6)

    from bulklmm_tpu import bulkscan
    from bulklmm_tpu.parallel import merge_shards

    merged = merge_shards(outdir)
    single = np.asarray(
        bulkscan(Y, G, K, method="alt-grid", h2_grid=np.arange(0.0, 0.91, 0.1)).L
    )
    assert float(np.max(np.abs(merged - single))) < 1e-9


def test_multiprocess_lowrank_matches_single_process(tmp_path):
    """Rank-k pod path: unrotated per-process trait feed, replicated (n, k)
    eigenfactor — merged shards must equal the single-process rank-k scan."""
    Y, G, K, outdir = _run_pod(2, "lowrank:null-grid", tmp_path, m=8)

    import jax.numpy as jnp

    from bulklmm_tpu import bulkscan
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact
    from bulklmm_tpu.parallel import merge_shards

    merged = merge_shards(outdir)
    lr = kinship_lowrank_exact(K, 16, dtype=jnp.float64)
    single = np.asarray(
        bulkscan(Y, G, lr, method="null-grid",
                 h2_grid=np.arange(0.0, 0.91, 0.1)).L
    )
    assert merged.shape == single.shape
    assert float(np.max(np.abs(merged - single))) < 1e-9


def test_local_trait_slice_partitions_exactly():
    """Single-process geometry: slices tile [0, m) without gap or overlap."""
    from bulklmm_tpu.parallel import local_trait_slice

    sl = local_trait_slice(17)
    assert (sl.start, sl.stop) == (0, 17)


def test_distributed_weights_guard_and_warning():
    """bulkscan_distributed routes weights through the shared
    _apply_weights: cached decompositions are rejected with the friendly
    message and non-positive weights warn (reference src/wls.jl:35-37)."""
    import warnings

    import pytest

    from bulklmm_tpu.ops.rotation import decompose_kinship
    from bulklmm_tpu.parallel.distributed import bulkscan_distributed

    rng = np.random.default_rng(5)
    n, p, m = 30, 12, 8
    import bulklmm_tpu as bl

    G = rng.choice([0.0, 1.0], size=(n, p))
    K = np.asarray(bl.calc_kinship(G))
    Y = rng.normal(size=(n, m))
    with pytest.raises(ValueError, match="cached decomposition"):
        bulkscan_distributed(Y, G, decompose_kinship(K),
                             weights=np.ones(n), m_total=m)
    w = np.ones(n)
    w[0] = -1.0
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        bulkscan_distributed(Y, G, K, weights=np.abs(w) + 0.5, m_total=m)
        assert not any("not positive" in str(r.message) for r in rec)
        bulkscan_distributed(Y, G, K, weights=w, m_total=m)
        assert any("not positive" in str(r.message) for r in rec)


def test_multiprocess_perms_matches_single_process(tmp_path):
    """Pod permutation thresholds: merged per-process maxima shards equal
    the single-process bulkscan_perms exactly (identical shuffle indices
    on every process; zero cross-process communication)."""
    Y, G, K = _synth(m=10)
    data = tmp_path / "data.npz"
    np.savez(data, Y=Y, G=G, K=K)
    outdir = tmp_path / "shards"
    coord = f"127.0.0.1:{_free_port()}"
    env = _worker_env(2)
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), coord, "2", str(i),
             str(data), str(outdir), "perms"],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker {i} failed:\n{out}"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import bulklmm_tpu as bl
    from bulklmm_tpu.parallel import merge_perm_shards

    merged = merge_perm_shards(outdir)
    ref = bl.bulkscan_perms(Y, G, K, nperms=24, rndseed=7)
    np.testing.assert_allclose(merged, np.asarray(ref.maxlods), atol=1e-9)


def test_multiprocess_8proc_pod(tmp_path):
    """8-process pod: merged shards equal the
    single-process engine; one CPU device per process keeps the fixture
    light while exercising the full 8-way handshake + shard geometry."""
    Y, G, K, outdir = _run_pod(8, "null-grid", tmp_path, m=16,
                               devices_per_proc=1)

    from bulklmm_tpu import bulkscan
    from bulklmm_tpu.parallel import merge_shards

    merged = merge_shards(outdir)
    single = np.asarray(
        bulkscan(Y, G, K, method="null-grid",
                 h2_grid=np.arange(0.0, 0.91, 0.1)).L
    )
    assert merged.shape == single.shape
    assert float(np.max(np.abs(merged - single))) < 1e-9


def test_pod_kill_and_resume(tmp_path):
    """Pod-level kill-and-resume: one worker of a
    2-process checkpointed perm pod is SIGKILLed mid-sweep; the restarted
    pod resumes from the per-process checkpoints and the merged shards
    equal the uninterrupted single-process sweep exactly."""
    import signal
    import time as _t

    Y, G, K = _synth(m=16)
    data = tmp_path / "data.npz"
    np.savez(data, Y=Y, G=G, K=K)
    ck_base = tmp_path / "ck"
    env = _worker_env(1)

    def launch(outdir):
        coord = f"127.0.0.1:{_free_port()}"
        return [
            subprocess.Popen(
                [sys.executable, str(WORKER), coord, "2", str(i),
                 str(data), str(outdir), f"perms_ckpt:{ck_base}"],
                env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            for i in range(2)
        ]

    out1 = tmp_path / "shards_killed"
    procs = launch(out1)
    victim_ck = ck_base / "p1"
    deadline = _t.time() + 240
    try:
        # kill worker 1 the moment its first chunk file publishes
        while _t.time() < deadline:
            if len(list(victim_ck.glob("maxlods_*.npy"))) >= 1:
                break
            if procs[1].poll() is not None:
                break
            _t.sleep(0.02)
        if procs[1].poll() is None:
            import os as _os

            _os.kill(procs[1].pid, signal.SIGKILL)
    finally:
        for p in procs:
            try:
                p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
    assert len(list(victim_ck.glob("maxlods_*.npy"))) >= 1, (
        "worker 1 finished before the kill could land"
    )

    # restart the pod on a fresh coordinator; both workers resume from
    # their checkpoints (worker 0's may already be complete)
    out2 = tmp_path / "shards_resumed"
    procs = launch(out2)
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"resumed worker {i} failed:\n{outs[i]}"
    assert len(sorted(out2.glob("perm_shard_*.npz"))) == 2

    import jax

    jax.config.update("jax_platforms", "cpu")
    import bulklmm_tpu as bl
    from bulklmm_tpu.parallel import merge_perm_shards

    merged = merge_perm_shards(out2)
    ref = bl.bulkscan_perms(Y, G, K, nperms=199, rndseed=7, trait_chunk=1)
    np.testing.assert_allclose(merged, np.asarray(ref.maxlods), atol=1e-12)
