"""Pure-f32 smoke: the engines run with jax_enable_x64 OFF (the FAST32
screening configuration) — a subprocess, because the main suite enables
x64 globally. Catches dtype-promotion regressions (e.g. python-float Brent
bounds resolving to f64) and f32-only numeric traps that the f64 suite
can't see."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
# x64 stays OFF: everything below must run end-to-end in f32
import numpy as np
import bulklmm_tpu as bl
from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact
from bulklmm_tpu.utils.config import FAST32

rng = np.random.default_rng(3)
n, p, m = 60, 80, 5
G = rng.uniform(0, 1, (n, p)).astype(np.float32)
K = np.asarray(bl.calc_kinship(G))
Y = rng.normal(size=(n, m)).astype(np.float32)
Y[:, 1] += 1.5 * (G[:, 7] - G[:, 7].mean())

r = bl.scan(Y[:, 1], G, K, precision=FAST32)
assert np.isfinite(np.asarray(r.lod)).all()
assert 0.0 <= float(r.h2_null) <= 1.0
assert np.argmax(np.asarray(r.lod)) == 7

ra = bl.scan(Y[:, 1], G, K, assumption="alt", precision=FAST32)
assert np.isfinite(np.asarray(ra.lod)).all()
assert np.asarray(ra.lod).min() > -1e-2

rp = bl.scan(Y[:, 1], G, K, permutation_test=True, nperms=24, rndseed=1,
             precision=FAST32)
assert np.isfinite(np.asarray(rp.L_perms)).all()

b = bl.bulkscan(Y, G, K, precision=FAST32)
assert np.isfinite(np.asarray(b.L)).all()

pr = bl.bulkscan_perms(Y, G, K, nperms=16, rndseed=2, precision=FAST32)
assert np.isfinite(np.asarray(pr.maxlods)).all()

lr = kinship_lowrank_exact(K, 20)
bl2 = bl.bulkscan(Y, G, lr, precision=FAST32)
assert np.isfinite(np.asarray(bl2.L)).all()
pr2 = bl.bulkscan_perms(Y, G, lr, nperms=16, rndseed=2, precision=FAST32)
assert np.isfinite(np.asarray(pr2.maxlods)).all()

print("FAST32-SMOKE-OK")
"""


def test_fast32_engines_run_without_x64():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=420,
    )
    assert r.returncode == 0, (r.stdout + r.stderr)[-2000:]
    assert "FAST32-SMOKE-OK" in r.stdout
