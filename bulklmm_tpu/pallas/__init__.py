"""Pallas kernels for NVIDIA GPUs, compiled through Triton — the
hand-fused perf layer.

- :func:`fused_alt_grid` (altgrid_fused.py) — the alt-grid engine: the
  h2-grid loop runs inside each output tile's program, with the running
  min/argmin in registers (the XLA ``lax.scan`` formulation round-trips
  the (p, m) carries through device memory on every grid step).
- ``fused_perm_maxlods`` (bulkperm_fused.py) — the bulk permutation
  engine: a running max over markers in registers, so the
  (p, traits, perms) correlations never reach device memory.

:func:`resolve_engine` is the one place that decides whether a kernel
runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .altgrid_fused import fused_alt_grid


def kernels_apply(device=None) -> bool:
    """Whether the Triton-route kernels compile for ``device`` (default:
    JAX's first device) — true on CUDA GPUs."""
    if device is None:
        device = jax.devices()[0]
    return device.platform == "gpu"


def resolve_engine(engine: str, precision, *, device=None,
                   interpret: bool = False, eligible: bool = True) -> str:
    """"pallas" or "xla" for an engine that has a fused kernel.

    "auto" picks the kernel where :func:`kernels_apply` holds, the GEMM
    dtype is float32 and the caller's shape is ``eligible``; XLA
    otherwise. Explicit "pallas" raises instead of silently downgrading an
    f64 GEMM config to the f32 kernel, and off the GPU unless
    ``interpret=True`` (test/debug mode, never chosen by the library).
    """
    f32 = precision.resolve_gemm() == jnp.float32
    if engine == "pallas":
        if interpret:
            return "pallas"
        if not f32:
            raise ValueError(
                "engine='pallas' runs the fused kernel in f32; the current "
                "precision config resolves GEMMs to "
                f"{jnp.dtype(precision.resolve_gemm()).name}, which it "
                "would silently downgrade. Use engine='xla' (honors the "
                "config) or a precision whose GEMM dtype is float32."
            )
        if not kernels_apply(device):
            raise ValueError(
                "engine='pallas' requires a CUDA GPU backend; on other "
                "backends pass interpret=True (test/debug mode) or use "
                "engine='xla'."
            )
        return "pallas"
    if engine == "auto" and f32 and eligible and kernels_apply(device):
        return "pallas"
    return "xla"


__all__ = ["fused_alt_grid", "kernels_apply", "resolve_engine"]
