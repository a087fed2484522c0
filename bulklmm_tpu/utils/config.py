"""Precision / numerics configuration for the LMM engines.

The reference (BulkLMM.jl) is float64 end-to-end on CPU BLAS. The engine
splits precision into two knobs:

- ``solve_dtype``: dtype for the scalar-heavy path (weights, likelihoods,
  per-trait/marker WLS solves, Brent iterations). float64 on CPU tests gives
  bit-comparable parity with the reference formulas.
- ``gemm_dtype`` + ``gemm_precision``: dtype/precision of the large
  trait x marker correlation GEMMs (the throughput core). float32 with
  ``Precision.HIGHEST`` is an IEEE f32 product (on a GPU: the CUDA cores,
  not TF32 on the tensor cores).

There is no config-file / env-var system in the reference (everything is
keyword arguments; see reference src/scan.jl:94-109); we mirror that with a
small frozen dataclass passed as a keyword.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp


def with_highest_matmul(fn):
    """Scope ``jax.default_matmul_precision('highest')`` around ``fn``.

    Statistical numerics first: a GPU's default f32 matmul is TF32 (measured
    3.2e-4 relative on an H100, against 3.9e-7 at HIGHEST), which costs
    ~1e-3 absolute LOD error through the likelihood path — including inside
    primitives that take no precision argument (``jnp.linalg.qr``'s
    internal matmuls). Every engine entry point wraps its math in this
    context instead of mutating process-global JAX config at import time
    (which would silently change the numerics/performance of unrelated user
    code in the same process). The big correlation GEMMs still take their
    precision explicitly from PrecisionConfig.
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper


def f32_dots_below_highest(stablehlo_text: str) -> list:
    """The f32 ``dot_general`` lines of lowered StableHLO text (``jit(f)
    .lower(...).as_text()``) that do not run at HIGHEST — the check that
    :func:`with_highest_matmul` reached every product of a jitted core."""
    return [
        line.strip() for line in stablehlo_text.splitlines()
        if "stablehlo.dot_general" in line
        and "xf32>" in line.rsplit(": (", 1)[-1]
        and "precision = [HIGHEST, HIGHEST]" not in line
    ]


def default_float() -> Any:
    """float64 when jax x64 is enabled, else float32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Numerics knobs for the scan engines.

    Attributes:
      solve_dtype: dtype for likelihood / WLS / optimizer math. ``None``
        resolves to float64 if x64 is enabled, else float32.
      gemm_dtype: dtype for the big correlation GEMMs. ``None`` resolves to
        ``solve_dtype``.
      gemm_precision: ``jax.lax.Precision`` for those GEMMs.
    """

    solve_dtype: Optional[Any] = None
    gemm_dtype: Optional[Any] = None
    gemm_precision: jax.lax.Precision = jax.lax.Precision.HIGHEST
    kernel_dtype: Optional[Any] = None  # correlation-kernel combine dtype

    def resolve_solve(self) -> Any:
        return self.solve_dtype if self.solve_dtype is not None else default_float()

    def resolve_gemm(self) -> Any:
        return self.gemm_dtype if self.gemm_dtype is not None else self.resolve_solve()

    def resolve_kernel(self) -> Any:
        """Dtype for the (p x m)-scale combining inside the correlation
        kernel; defaults to the solve dtype. The BALANCED preset keeps the
        cheap rotation/likelihood math in f64 but the big combines in f32."""
        return self.kernel_dtype if self.kernel_dtype is not None else self.resolve_solve()


DEFAULT_PRECISION = PrecisionConfig()

# Presets (the float64 members require jax x64):
#   FAST32  — everything f32, GEMMs at HIGHEST.
#   MIXED   — f64 likelihood/combining math, f32 HIGHEST GEMMs. Accuracy set
#             by the GEMM rounding alone.
#   EXACT64 — f64 end-to-end (native f64 on an H100). Bit-level agreement
#             with the reference formulas (~1e-13 LOD); the on-card
#             reference that chip_smoke.py holds the other tiers to.
FAST32 = PrecisionConfig(solve_dtype=jnp.float32, gemm_dtype=jnp.float32)
MIXED = PrecisionConfig(solve_dtype=jnp.float64, gemm_dtype=jnp.float32)
EXACT64 = PrecisionConfig(solve_dtype=jnp.float64, gemm_dtype=jnp.float64)
# BALANCED: f64 rotation + likelihood/grid math (small arrays), f32 GEMMs
# AND f32 kernel combines (the (p x m)-scale traffic); held to 1e-5 max
# LOD error against EXACT64.
BALANCED = PrecisionConfig(
    solve_dtype=jnp.float64, gemm_dtype=jnp.float32, kernel_dtype=jnp.float32
)
# THROUGHPUT: like FAST32 but GEMMs at Precision.HIGH. On an H100 XLA
# lowers a HIGH f32 product exactly as DEFAULT: single-pass TF32 on the
# tensor cores. The fused Pallas kernels run it as a three-pass bf16 split
# (pallas/altgrid_fused.py::kernel_dot_precision). Screening-grade: rank
# candidate loci fast, confirm peaks with BALANCED/EXACT64.
THROUGHPUT = PrecisionConfig(
    solve_dtype=jnp.float32,
    gemm_dtype=jnp.float32,
    gemm_precision=jax.lax.Precision.HIGH,
)


def enable_x64() -> None:
    """Enable float64 globally (call before creating arrays)."""
    jax.config.update("jax_enable_x64", True)
