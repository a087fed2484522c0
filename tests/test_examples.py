"""Execute examples/*.py as subprocess smoke tests.

The three user-facing entry documents were the only files with no
verification story; running them here means they cannot silently drift
from the API. Each runs on CPU with the repo on PYTHONPATH (the scripts
already fall back to synthetic data when the reference mount is absent)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "examples").glob("*.py"))


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    xla = env.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in xla:
        env["XLA_FLAGS"] = (
            xla + " --xla_force_host_platform_device_count=8"
        ).strip()
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_examples_enumerated():
    """Every example is exercised below — adding a new one without a
    completion marker here fails, not drifts."""
    assert [p.name for p in EXAMPLES] == [
        "biobank_thresholds.py", "bxd_workflow.py", "production_sweep.py",
    ]


@pytest.mark.parametrize(
    "name,marker",
    [
        ("bxd_workflow.py", "workflow complete"),
        ("biobank_thresholds.py", None),
        ("production_sweep.py", None),
    ],
)
def test_example_runs(name, marker):
    r = subprocess.run(
        [sys.executable, str(REPO / "examples" / name)],
        env=_env(), capture_output=True, text=True, timeout=900,
        cwd=REPO,
    )
    assert r.returncode == 0, (
        f"{name} failed\n--- stdout ---\n{r.stdout[-1500:]}"
        f"\n--- stderr ---\n{r.stderr[-1500:]}"
    )
    if marker is not None:
        assert marker in r.stdout, r.stdout[-1500:]
