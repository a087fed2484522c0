"""Entry-point plumbing that needs no card: chip_smoke.py refuses to run
without a GPU, the compile-cache helper honors JAX_COMPILATION_CACHE_DIR,
and pod processes autotune their own GPU fusions."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run(
        [sys.executable] + args, cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_chip_smoke_exits_nonzero_without_gpu():
    r = _run([str(REPO / "chip_smoke.py")], REPO,
             {"PYTHONPATH": str(REPO)})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "GPU" in r.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Copied into a directory without the package, it fails and prints
    no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path, {"PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


_CACHE_PROBE = (
    "import jax; from bulklmm_tpu.utils.cache import use_compile_cache; "
    "d = use_compile_cache(); print(d); "
    "print(jax.config.jax_compilation_cache_dir)"
)


def test_compile_cache_defaults_to_checkout(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    used, configured = r.stdout.split()
    assert used == configured == str(REPO / ".jax_cache")


def test_compile_cache_env_var_wins(tmp_path):
    want = str(tmp_path / "cc")
    r = _run(["-c", _CACHE_PROBE], tmp_path,
             {"PYTHONPATH": str(REPO), "JAX_COMPILATION_CACHE_DIR": want})
    assert r.returncode == 0, r.stderr
    used, configured = r.stdout.split()
    # the helper sets nothing; JAX reads the variable itself
    assert used == configured == want


def test_pod_processes_autotune_their_own_fusions(monkeypatch):
    """A multi-process run turns XLA's sharded autotuning off (it
    segfaulted a pod process on H100s), after the caller's own flags."""
    from bulklmm_tpu.parallel.distributed import _own_autotuning

    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    _own_autotuning()
    assert os.environ["XLA_FLAGS"] == (
        "--xla_force_host_platform_device_count=8 "
        "--xla_gpu_shard_autotuning=false"
    )


def test_pod_autotuning_flag_of_caller_kept(monkeypatch):
    from bulklmm_tpu.parallel.distributed import _own_autotuning

    monkeypatch.setenv("XLA_FLAGS", "--xla_gpu_shard_autotuning=true")
    _own_autotuning()
    assert os.environ["XLA_FLAGS"] == "--xla_gpu_shard_autotuning=true"
