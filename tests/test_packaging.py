"""Packaging smoke tests: the repo must install as a
real package — console-script entry point, single-sourced version, wheel
that imports — not just run from a checkout."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """pip-install the package (no build isolation: the sandbox has no
    network; setuptools is in the env) into a throwaway prefix."""
    prefix = tmp_path_factory.mktemp("prefix")
    r = subprocess.run(
        [sys.executable, "-m", "pip", "install", "-q", "--no-deps",
         "--no-build-isolation", "--prefix", str(prefix), str(REPO)],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    pyver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    site = prefix / "lib" / pyver / "site-packages"
    return prefix, site


def test_installed_package_imports_and_versions(installed):
    prefix, site = installed
    env = _clean_env()
    env["PYTHONPATH"] = str(site)
    r = subprocess.run(
        [sys.executable, "-c",
         "import bulklmm_tpu as bl; print(bl.__version__); "
         "print(len(bl.__all__))"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    version, nexports = r.stdout.split()
    # version single-sourced: pyproject's dynamic attr == runtime attr
    import bulklmm_tpu

    assert version == bulklmm_tpu.__version__
    assert int(nexports) > 30


def test_console_script_entry_point(installed):
    prefix, site = installed
    script = prefix / "bin" / "bulklmm-tpu"
    assert script.exists(), "console script bulklmm-tpu not installed"
    env = _clean_env()
    env["PYTHONPATH"] = str(site)
    r = subprocess.run(
        [str(script), "--help"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    for sub in ("kinship", "scan", "bulkscan", "podscan", "merge-shards"):
        assert sub in r.stdout


def test_wheel_builds_and_carries_native_source(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "-q", "--no-deps",
         "--no-build-isolation", "-w", str(tmp_path), str(REPO)],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    wheels = list(tmp_path.glob("bulklmm_tpu-*.whl"))
    assert len(wheels) == 1
    import zipfile

    names = zipfile.ZipFile(wheels[0]).namelist()
    # the C++ CSV parser ships as source (compiled on first use)
    assert any(n.endswith("_native/fastcsv.cpp") for n in names)
    assert any("licenses/LICENSE" in n or "LICENSE" in n for n in names)
