"""Bulk permutation testing: genome-wide permutation null maxima and
family-wise-error thresholds for EVERY trait in one pass.

Beyond-reference capability. The reference's permutation test is
single-trait (``scan_perms_lite``, src/scan.jl:485-557 + ``get_thresholds``,
src/analysis_helpers/single_trait_analysis.jl:13-23); thresholding all
35,554 BXD traits means 35,554 sequential scans (~47 min at the README's
0.079 s per trait, README.md:229-233). ``bulkscan_perms`` produces the same
per-trait genome-wide null maxima for all traits at once: per-trait null h2
fits (grid or exact, as ``bulkscan``), shared shuffle indices (identical to
the single-trait path's), and a fused max-over-markers correlation pass
(ops/bulkperm.py derivation; pallas/bulkperm_fused.py kernel) that never
materializes the (p, m, nperms) LOD tensor (~1 TB at BXD scale).

Column semantics match ``transform_permute(original=True)``: column 0 of
``maxlods`` is the observed (unpermuted) genome-wide max LOD per trait;
columns 1.. are the permutation null replicates.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.bulkperm import (
    max_r2_perms_xla,
    maxr2_to_lod,
    perm_trait_marker_parts,
    perm_trait_parts,
    perm_trait_parts_lowrank,
    permutation_indices,
)
from ..ops.lmm import fit_lmm
from ..ops.rotation import resolve_kinship
from ..ops.smallchol import decovariate
from ..ops.weights import make_weights
from ..ops.wls import wls_ell
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from .bulkscan import grid_null_ell
from .scan import _apply_weights


@dataclasses.dataclass
class BulkPermResult:
    """Output of :func:`bulkscan_perms`.

    ``maxlods`` (m, 1 + nperms) when ``original=True`` (column 0 observed),
    else (m, nperms). Use :func:`bulklmm_tpu.get_thresholds_bulk` on
    ``perm_maxima`` for per-trait FWER thresholds.

    ``maxlods`` stays DEVICE-resident: at BXD scale it is ~140 MB, and the
    downstream consumers (thresholds, adjusted p-values) are tiny
    reductions that run on device — fetching the full matrix is the user's
    explicit choice via ``np.asarray``.
    """

    maxlods: jnp.ndarray
    h2_null_list: jnp.ndarray  # (m,)
    sigma2_e_list: jnp.ndarray  # (m,)
    nperms: int = 0
    original: bool = True
    log10_adj_pvals: Optional[jnp.ndarray] = None  # (m,) genome-wide adjusted
    h2_null_by_chrom: Optional[dict] = None  # LOCO: chrom -> (m,) h2s
    sigma2_by_chrom: Optional[dict] = None  # LOCO: chrom -> (m,) sigma2_e

    @property
    def perm_maxima(self) -> jnp.ndarray:
        """(m, nperms) null maxima (observed column stripped)."""
        return self.maxlods[:, 1:] if self.original else self.maxlods

    @property
    def lod_max(self) -> Optional[jnp.ndarray]:
        """(m,) observed genome-wide max LOD (``original=True`` only)."""
        return self.maxlods[:, 0] if self.original else None


def _attach_adj_pvals(result: BulkPermResult) -> BulkPermResult:
    """Permutation-adjusted genome-wide -log10 p per trait:
    (1 + #{null max >= observed}) / (nperms + 1), on device."""
    if result.original and result.nperms > 0:
        exceed = jnp.sum(
            result.perm_maxima >= result.lod_max[:, None], axis=1
        )
        result.log10_adj_pvals = -jnp.log10(
            (1.0 + exceed) / (result.nperms + 1.0)
        )
    return result


class _PermCheckpoint:
    """Per-trait-chunk checkpointing for the bulk permutation engines.

    A biobank-scale sweep (m ~ 1e4-1e5 traits x 1e3 perms) loops host-side
    trait chunks for minutes-to-hours; preemption would lose everything.
    With a checkpoint directory, each completed (trait chunk) row of
    genome-wide maxima is written to ``maxlods_<lo>_<hi>.npy`` and a
    ``meta.json`` fingerprints the run configuration — re-running the same
    call resumes, computing only the missing chunks (shuffle indices depend
    only on (n, nperms, rndseed), so recomputed chunks are bit-identical).
    A config mismatch against an existing meta.json raises instead of
    silently mixing sweeps. Checkpointing syncs once per trait chunk (the
    row readback), trading the fully-async pipeline for resumability.
    """

    def __init__(self, path, meta: dict):
        import json
        from pathlib import Path

        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.meta_path = self.dir / "meta.json"
        meta = {k: meta[k] for k in sorted(meta)}
        if self.meta_path.is_file():
            existing = json.loads(self.meta_path.read_text())
            if existing != meta:
                diff = {
                    k for k in set(existing) | set(meta)
                    if existing.get(k) != meta.get(k)
                }
                raise ValueError(
                    f"checkpoint directory {self.dir} holds a different "
                    f"sweep (mismatched keys: {sorted(diff)}); point at a "
                    "fresh directory or delete it. (Checkpoints written by "
                    "older framework versions lack newer fingerprint keys "
                    "— e.g. precision/engine — and cannot be safely "
                    "resumed, because the unrecorded settings cannot be "
                    "verified; such sweeps must restart.)"
                )
        else:
            blob = json.dumps(meta, indent=1).encode()
            self._atomic_write("meta.json", lambda fh: fh.write(blob))

    def load(self, lo: int, hi: int):
        f = self.dir / f"maxlods_{lo}_{hi}.npy"
        return np.load(f) if f.is_file() else None

    def save(self, lo: int, hi: int, row) -> None:
        arr = np.asarray(row)  # syncs this chunk's device work
        self._atomic_write(f"maxlods_{lo}_{hi}.npy", lambda fh: np.save(fh, arr))

    def _atomic_write(self, name: str, write) -> None:
        import os
        import tempfile

        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                write(fh)
            # atomic publish: a kill mid-write never leaves a torn file
            os.replace(tmp, self.dir / name)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # --- cursor-style state for the marker-STREAMED engine: the (m, K)
    # running-max accumulator + how many marker blocks folded in so far ---

    def save_state(self, maxima, blocks_done: int) -> None:
        arr = np.asarray(maxima)
        self._atomic_write(
            "acc_state.npz",
            lambda fh: np.savez(fh, maxima=arr, blocks_done=blocks_done),
        )

    def load_state(self):
        f = self.dir / "acc_state.npz"
        if not f.is_file():
            return None
        z = np.load(f)
        return z["maxima"], int(z["blocks_done"])


def _data_fingerprint(*arrays, max_bytes: int = 1 << 28):
    """Order-sensitive content digest of a sweep's input arrays.

    Shapes/config alone cannot distinguish "the same sweep" from "the same
    sweep on a corrected phenotype CSV" — resuming across such an edit
    would silently mix stale and fresh maxima rows in one FWER threshold
    matrix. This folds the actual bytes into the checkpoint fingerprint.

    Arrays up to ``max_bytes`` (256 MB) are hashed in full. Larger ones
    (memmap-scale genotype panels) are hashed by (a) a deterministic sample
    of ~1024 evenly spaced rows (column-subsampled if still too large) AND
    (b) a full-pass per-row INTEGER checksum over the raw row bytes,
    ``sum_k byte[i, k] * w_k  (mod 2^64)`` with fixed position-dependent
    uint64 weights, computed in row chunks — a single edited byte anywhere
    perturbs its row's checksum (delta * w_k != 0 mod 2^64 for any
    byte-sized delta), even when the edited row is not in the sample, and
    within-row swaps change it too (all weights distinct). Integer
    arithmetic wraps mod 2^64 identically on every platform, so the digest
    is bit-stable across BLAS builds / thread counts / numpy versions
    (same dtype + endianness) — a checkpoint written on one machine
    resumes on another. The checksum pass reads the full array once — for
    a memmap that is one extra IO sweep, paid only when checkpointing is
    requested. Lazy containers (``np.memmap``, h5py datasets) are sized
    from their ``shape``/``dtype`` and read strictly by slice — never
    materialized whole.
    ``KinshipDecomposition`` / ``LowRankKinship`` hash their factor arrays.
    """
    import hashlib

    h = hashlib.blake2b(digest_size=16)

    def feed(a):
        if a is None:
            h.update(b"<none>")
            return
        # unwrap cached decompositions into their defining factors
        if hasattr(a, "Ut") and hasattr(a, "lam"):       # KinshipDecomposition
            feed(a.Ut_host if a.Ut_host is not None else a.Ut)
            feed(a.lam_host if a.lam_host is not None else a.lam)
            return
        if hasattr(a, "U") and hasattr(a, "lam"):        # LowRankKinship
            feed(a.U)
            feed(a.lam)
            return
        # size WITHOUT materializing: memmap/h5py/device arrays all expose
        # shape+dtype; np.asarray on a >RAM lazy container would OOM here
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            shape = tuple(int(s) for s in a.shape)
            dt = np.dtype(a.dtype)
        else:
            a = np.asarray(a)
            shape, dt = a.shape, a.dtype
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        h.update(str(dt).encode())
        h.update(str(shape).encode())
        if nbytes <= max_bytes:
            h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
            return
        rows = np.linspace(
            0, shape[0] - 1, num=min(shape[0], 1024)
        ).astype(np.int64)
        # strictly-increasing row selection: valid for memmap, h5py
        # (sorted fancy selection), numpy, and jax arrays alike
        sample = np.ascontiguousarray(np.asarray(a[rows]))
        if sample.nbytes > max_bytes:
            flat = sample.reshape(sample.shape[0], -1)
            ncols = max(1, max_bytes // max(1, flat[:, :1].nbytes))
            cols = np.linspace(
                0, flat.shape[1] - 1, num=min(flat.shape[1], ncols)
            ).astype(np.int64)
            sample = np.ascontiguousarray(flat[:, cols])
        h.update(sample.tobytes())
        # full-pass per-row integer checksum: catches edits the row
        # sample misses (one byte anywhere -> its row's checksum moves)
        row_nbytes = (
            int(np.prod(shape[1:], dtype=np.int64)) * dt.itemsize
        )
        # affine golden-ratio weights: k * GOLD + 1 is a bijection of
        # uint64 (GOLD odd), so weights are distinct and nonzero
        mult = np.arange(row_nbytes, dtype=np.uint64) * np.uint64(
            0x9E3779B97F4A7C15
        ) + np.uint64(1)
        # chunk bound: the uint64-widened byte block is 8x the raw bytes
        chunk = max(1, max_bytes // max(1, row_nbytes * 8))
        sums = np.empty(shape[0], dtype=np.uint64)
        for lo in range(0, shape[0], chunk):
            hi_ = min(lo + chunk, shape[0])
            blk = np.ascontiguousarray(np.asarray(a[lo:hi_]))
            bb = blk.view(np.uint8).reshape(hi_ - lo, row_nbytes)
            sums[lo:hi_] = (bb.astype(np.uint64) * mult[None, :]).sum(
                axis=1, dtype=np.uint64
            )
        h.update(sums.tobytes())

    for a in arrays:
        feed(a)
    return h.hexdigest()


def _perm_checkpoint(checkpoint, *, n, m, p, nperms, rndseed, method, reml,
                     original, trait_chunk, h2_grid, prior, rank,
                     precision=None, engine=None, data_digest=None):
    """Build the checkpoint handle (or None) with the run fingerprint.

    ``precision`` (PrecisionConfig) and ``engine`` (the RESOLVED engine
    string) are part of the fingerprint: resuming an EXACT64 sweep under
    FAST32, or a fused-Pallas sweep on an XLA backend, would silently mix
    numerics across trait chunks in one FWER threshold matrix — refuse it
    like any other config mismatch. ``data_digest``
    (:func:`_data_fingerprint` of Y/G/covar/weights/K) guards the same
    failure for same-shape same-seed INPUT edits — e.g. a corrected
    phenotype CSV between runs.
    """
    if checkpoint is None:
        return None
    meta = dict(
        n=int(n), m=int(m), p=int(p), nperms=int(nperms),
        rndseed=int(rndseed), method=str(method), reml=bool(reml),
        original=bool(original), trait_chunk=int(trait_chunk),
        h2_grid=[float(v) for v in np.asarray(h2_grid).ravel()],
        prior=[float(prior[0]), float(prior[1])], rank=str(rank),
    )
    if precision is not None:
        meta["precision"] = "{}/{}/{}".format(
            jnp.dtype(precision.resolve_solve()).name,
            jnp.dtype(precision.resolve_gemm()).name,
            jnp.dtype(precision.resolve_kernel()).name,
        )
    if engine is not None:
        meta["engine"] = str(engine)
    if data_digest is not None:
        meta["data"] = str(data_digest)
    return _PermCheckpoint(checkpoint, meta)


def _perm_common_inputs(
    Y, G, K, covar, *, method, engine, h2_grid, weights, add_intercept,
    prior_variance, prior_sample_size,
):
    """Shared validation + trait/covariate/prior prep for the three
    permutation entry points (in-memory / marker-streamed / sharded) —
    they must never diverge on argument semantics."""
    if method not in ("null-grid", "null-exact"):
        raise ValueError("method must be one of 'null-grid', 'null-exact'")
    if engine not in ("auto", "xla", "pallas"):
        raise ValueError("engine must be one of 'auto', 'xla', 'pallas'")
    Y = jnp.asarray(Y)
    Y = Y[:, None] if Y.ndim == 1 else Y
    n = Y.shape[0]
    if h2_grid is None:
        h2_grid = jnp.arange(0.0, 0.91, 0.1)
    h2_grid = jnp.asarray(h2_grid)
    if covar is None:
        covar = jnp.ones((n, 1), dtype=Y.dtype)
        add_intercept = False
    else:
        from ..ops.stats import check_covar_full_rank

        check_covar_full_rank(covar, add_intercept)
        covar = jnp.asarray(covar)
        covar = covar[:, None] if covar.ndim == 1 else covar
    if weights is not None:
        from ..ops.lowrank import LowRankKinship
        from ..ops.rotation import KinshipDecomposition

        if isinstance(K, (KinshipDecomposition, LowRankKinship)):
            raise ValueError(
                "weights rescale the kinship matrix (K -> WKW); pass the raw "
                "K, not a cached decomposition or rank-k factorization."
            )
        Y, G, covar, K, add_intercept = _apply_weights(
            Y, G, covar, K, weights, add_intercept
        )
    if add_intercept:
        covar = jnp.concatenate(
            [jnp.ones((n, 1), dtype=covar.dtype), covar], axis=1
        )
    prior = (float(prior_variance), float(prior_sample_size))
    return Y, G, K, covar, h2_grid, prior


def _resolve_perm_engine(
    engine, n, *, precision, device=None, interpret=False, p=None,
    trait_block=None,
):
    """Engine + perm-chunk cap policy shared by the three entry points.

    Returns ``(eng, cap)``: ``eng`` from :func:`pallas.resolve_engine` (the
    fused kernel on a GPU at f32 GEMM dtype); ``cap`` the perm-chunk
    width that keeps one chunk's temporaries inside the device budget
    (``ops.bulkperm.perm_chunk_cap``), or None when ``p`` is not supplied.
    ``p`` is the marker width a chunk sees and ``trait_block`` the per-call
    trait-block size (default: the engine's trait chunk). The fused kernel
    never materializes a (Kc, p) numerator, so its cap counts no markers.
    """
    from ..pallas import resolve_engine

    eng = resolve_engine(engine, precision, device=device, interpret=interpret)
    if p is None:
        return eng, None
    from ..ops.bulkperm import perm_chunk_cap

    return eng, perm_chunk_cap(
        n, 0 if eng == "pallas" else p,
        trait_chunk=trait_block or _default_trait_chunk(eng),
        itemsize=max(jnp.dtype(precision.resolve_gemm()).itemsize,
                     jnp.dtype(precision.resolve_kernel()).itemsize),
    )


def _default_trait_chunk(eng) -> int:
    """Traits per device call: the kernel's programs each take 8 traits,
    so wide blocks fill the card; the XLA engine's (mb, Kc, p) numerator
    keeps its blocks narrow."""
    return 1024 if eng == "pallas" else 16


_STATIC_PREP = (
    "prior", "reml", "method", "solve_method", "optim_interval", "precision"
)


@partial(jax.jit, static_argnames=_STATIC_PREP)
@with_highest_matmul
def _bulkperm_prep_traits(
    Y, C, Ut, lam, h2_grid, *,
    prior, reml, method, solve_method, optim_interval, precision,
):
    """Trait-side prep (no markers): rotation + per-trait null fits +
    whitening parts, one device program. The marker-streamed engine
    (models/streaming.py::bulkscan_perms_streamed) rotates marker blocks
    separately."""
    Y0 = jnp.matmul(Ut, Y)
    C0 = jnp.matmul(Ut, C)

    if method == "null-grid":
        kdt = precision.resolve_kernel()
        ells = grid_null_ell(
            Y0.astype(kdt), C0.astype(kdt), lam.astype(kdt),
            h2_grid.astype(kdt), prior, reml=reml,
        )
        h2_list = h2_grid[jnp.argmax(ells, axis=0)]
    else:  # null-exact
        fits = jax.vmap(
            lambda yj: fit_lmm(
                yj, C0, lam, prior,
                reml=reml, method=solve_method, optim_interval=optim_interval,
            ),
            in_axes=1,
        )(Y0)
        h2_list = fits.h2

    sigma2_list = jax.vmap(
        lambda yj, h2: wls_ell(
            yj[:, None], C0, make_weights(h2, lam), prior, reml=reml
        )[1][0],
        in_axes=(1, 0),
    )(Y0, h2_list)

    sqrtw, Q, wrn = perm_trait_parts(Y0, C0, lam, h2_list, precision=precision)
    Qstack = jnp.transpose(jnp.stack(Q, axis=0), (2, 0, 1))  # (m, c, n)
    return h2_list, sigma2_list, sqrtw.T, Qstack, wrn


_STATIC_PREP_LR = ("prior", "reml", "method", "optim_interval", "precision", "n")


@partial(jax.jit, static_argnames=_STATIC_PREP_LR)
@with_highest_matmul
def _bulkperm_prep_traits_lowrank(
    Y, C, U, lam, h2_grid, *,
    n, prior, reml, method, optim_interval, precision,
):
    """Rank-k trait-side prep: per-trait null fits on the Woodbury
    likelihood (no rotation, no (n, n) kinship) + standard-coordinate
    whitening parts (ops/bulkperm.py::perm_trait_parts_lowrank)."""
    from ..ops.lowrank import (
        LowRankKinship, _parts_kwargs, _shared_parts, _trait_side_parts,
        fit_h2_lowrank, grid_null_ell_lowrank, null_sigma2_lowrank,
    )

    lr = LowRankKinship(U=U, lam=lam)
    kw = _parts_kwargs(precision)
    kdt = precision.resolve_kernel()
    parts = {**_shared_parts(C, lr, **kw), **_trait_side_parts(Y, C, lr, **kw)}
    lam_k = lam.astype(kdt)

    if method == "null-grid":
        ells = grid_null_ell_lowrank(
            parts, lam_k, h2_grid.astype(kdt), prior, n=n, reml=reml
        )
        h2_list = h2_grid[jnp.argmax(ells, axis=0)]
    else:  # null-exact
        h2_list = fit_h2_lowrank(
            parts, lam_k, prior, n=n, reml=reml, optim_interval=optim_interval
        )
    sigma2_list = null_sigma2_lowrank(
        parts, lam_k, h2_list.astype(kdt), prior, n=n, reml=reml
    )

    sm1, Qstack, wrn = perm_trait_parts_lowrank(
        Y, C, U, lam, h2_list, precision=precision
    )
    return h2_list, sigma2_list, sm1, Qstack, wrn


@partial(jax.jit, static_argnames=("precision",))
def _bulkperm_lr_marker_prep(X, U, *, precision):
    from ..ops.bulkperm import lowrank_perm_marker_parts

    return lowrank_perm_marker_parts(X, U, precision=precision)


@partial(jax.jit, static_argnames=("precision",))
def _bulkperm_lr_trait_block(X, U, UtX, UtX2, xsq, sm1_blk, Qblk, *, precision):
    from ..ops.bulkperm import lowrank_perm_trait_marker_parts

    return lowrank_perm_trait_marker_parts(
        X, U, UtX, UtX2, xsq, sm1_blk, Qblk, precision=precision
    )


@partial(jax.jit, static_argnames=("n", "precision"))
def _bulkperm_chunk_lowrank(
    X, U, UtX, sm1_blk, Qblk, qXs, xns, wrn_blk, idx_blk, *, n, precision
):
    """(mb, Kc) genome-wide max LODs for one (trait, perm) chunk, rank-k
    whitening (XLA only — the fused Pallas kernel assumes the diagonal
    whitening of the rotated basis)."""
    from ..ops.bulkperm import max_r2_perms_lowrank_xla

    maxr2 = max_r2_perms_lowrank_xla(
        X, U, UtX, sm1_blk, Qblk, qXs, xns, wrn_blk, idx_blk,
        precision=precision,
    )
    return maxr2_to_lod(maxr2, n, precision=precision)


def _bulkscan_perms_lowrank(
    Y, G, lr, covar, *,
    nperms, rndseed, method, h2_grid, prior, reml, optim_interval,
    precision, trait_chunk, perm_chunk, original, checkpoint=None,
    data_digest=None,
):
    """Rank-k engine body for :func:`bulkscan_perms` (same chunk loop and
    result semantics; whitening in standard coordinates). Marker-side
    projections are computed once; per-trait-block whitened-marker norms
    once per trait chunk; only the numerator GEMMs run per (trait, perm)
    chunk."""
    from ..ops.bulkperm import lowrank_perm_chunk_cap

    n, m = Y.shape
    dtype = precision.resolve_solve()
    U = jnp.asarray(lr.U, dtype=dtype)
    lam = jnp.asarray(lr.lam, dtype=dtype)

    h2_list, sigma2_list, sm1, Qstack, wrn = _bulkperm_prep_traits_lowrank(
        Y.astype(dtype), covar.astype(dtype), U, lam, h2_grid.astype(dtype),
        n=n, prior=prior, reml=reml, method=method,
        optim_interval=optim_interval, precision=precision,
    )

    X = jnp.asarray(G, dtype=dtype)
    p = X.shape[1]
    if trait_chunk is None:
        trait_chunk = 16
    perm_chunk = min(
        perm_chunk, lowrank_perm_chunk_cap(n, p, trait_chunk=trait_chunk)
    )
    idx = permutation_indices(n, nperms, rndseed, original=original)
    K_total = int(idx.shape[0])

    ckpt = _perm_checkpoint(
        checkpoint, n=n, m=m, p=p, nperms=nperms, rndseed=rndseed,
        method=method, reml=reml, original=original, trait_chunk=trait_chunk,
        h2_grid=h2_grid, prior=prior, rank=f"lowrank{lr.rank}",
        precision=precision, engine="xla", data_digest=data_digest,
    )

    UtX, UtX2, xsq = _bulkperm_lr_marker_prep(X, U, precision=precision)

    trait_rows = []
    for ms in range(0, m, trait_chunk):
        me = min(ms + trait_chunk, m)
        if ckpt is not None:
            done = ckpt.load(ms, me)
            if done is not None:
                trait_rows.append(jnp.asarray(done))
                continue
        sm1_b, Q_b = sm1[ms:me], Qstack[ms:me]
        qXs, xns = _bulkperm_lr_trait_block(
            X, U, UtX, UtX2, xsq, sm1_b, Q_b, precision=precision
        )
        perm_cols = []
        for ks in range(0, K_total, perm_chunk):
            ke = min(ks + perm_chunk, K_total)
            perm_cols.append(_bulkperm_chunk_lowrank(
                X, U, UtX, sm1_b, Q_b, qXs, xns, wrn[:, ms:me], idx[ks:ke],
                n=n, precision=precision,
            ))
        row = (
            perm_cols[0] if len(perm_cols) == 1
            else jnp.concatenate(perm_cols, axis=1)
        )
        if ckpt is not None:
            ckpt.save(ms, me, row)
        trait_rows.append(row)
    maxlods = (
        trait_rows[0] if len(trait_rows) == 1
        else jnp.concatenate(trait_rows, axis=0)
    )
    return BulkPermResult(
        maxlods=maxlods,
        h2_null_list=h2_list,
        sigma2_e_list=sigma2_list,
        nperms=nperms,
        original=original,
    )


@partial(jax.jit, static_argnames=_STATIC_PREP)
@with_highest_matmul
def _bulkperm_prep(
    Y, Xm, C, Ut, lam, h2_grid, *,
    prior, reml, method, solve_method, optim_interval, precision,
):
    """Trait-side prep + marker rotation fused into one device program.
    The rotated markers lose their covariate span here, at the solve dtype
    (ops/smallchol.py::decovariate), before either engine's f32 GEMMs."""
    out = _bulkperm_prep_traits(
        Y, C, Ut, lam, h2_grid,
        prior=prior, reml=reml, method=method, solve_method=solve_method,
        optim_interval=optim_interval, precision=precision,
    )
    return (decovariate(jnp.matmul(Ut, Xm), jnp.matmul(Ut, C)),) + tuple(out)


def _chunk_impl(
    X0m, sqrtw_blk, Qblk, wrn_blk, idx_blk, *,
    engine, n, precision, tile_p, interpret,
):
    """(mb, Kc) genome-wide max LODs for one (trait, perm) chunk, trait
    marker-parts computed inline. Pure — jitted directly (single device,
    single perm chunk) or as a ``shard_map`` body
    (parallel/sharding.py::bulkscan_perms_sharded, per-device shards —
    one chunk per call, so inline parts waste nothing there)."""
    if engine == "pallas":
        from ..pallas.bulkperm_fused import fused_perm_maxlods, fused_perm_prep

        # v2: the (n,)-scale trait-side work (shuffle, covariate
        # residualization via the self-adjoint identity, weight folding,
        # marker residual norms) runs here in XLA; the kernel itself is a
        # pure num-dot + masked running max (pallas/bulkperm_fused.py)
        S2, inv_xn = fused_perm_prep(
            X0m, sqrtw_blk, Qblk, wrn_blk, idx_blk, precision=precision
        )
        return fused_perm_maxlods(
            X0m, S2, inv_xn,
            n=n, tile_p=tile_p, precision=precision, interpret=interpret,
        )
    pXs, xns = perm_trait_marker_parts(
        X0m, sqrtw_blk, Qblk, precision=precision
    )
    maxr2 = max_r2_perms_xla(
        X0m, sqrtw_blk, Qblk, pXs, xns, wrn_blk, idx_blk, precision=precision
    )
    return maxr2_to_lod(maxr2, n, precision=precision)


_bulkperm_chunk = partial(
    jax.jit,
    static_argnames=("engine", "n", "precision", "tile_p", "interpret"),
)(_chunk_impl)


@partial(jax.jit, static_argnames=("precision",))
def _bulkperm_xla_trait_block(X0m, sqrtw_blk, Qblk, *, precision):
    """Hoisted permutation-independent trait marker-parts for the XLA
    engine (one call per trait block, reused by every perm chunk)."""
    return perm_trait_marker_parts(
        X0m, sqrtw_blk, Qblk, precision=precision
    )


@partial(jax.jit, static_argnames=("precision",))
def _bulkperm_pallas_trait_block(X0m, sqrtw_blk, Qblk, *, precision):
    """Hoisted permutation-independent inv_xn for the Pallas engine."""
    from ..pallas.bulkperm_fused import fused_perm_trait_block

    return fused_perm_trait_block(X0m, sqrtw_blk, Qblk, precision=precision)


@partial(jax.jit, static_argnames=("n", "precision", "tile_p", "interpret"))
def _bulkperm_chunk_pallas(
    X0m, sqrtw_blk, Qblk, inv_xn, wrn_blk, idx_blk, *,
    n, precision, tile_p, interpret,
):
    """(mb, Kc) genome-wide max LODs, Pallas engine with the hoisted
    trait-block inv_xn (only the chunk-dependent S2 prep runs here)."""
    from ..pallas.bulkperm_fused import fused_perm_chunk_inputs, fused_perm_maxlods

    S2 = fused_perm_chunk_inputs(sqrtw_blk, Qblk, wrn_blk, idx_blk)
    return fused_perm_maxlods(
        X0m, S2, inv_xn,
        n=n, tile_p=tile_p, precision=precision, interpret=interpret,
    )


@partial(jax.jit, static_argnames=("n", "precision"))
def _bulkperm_chunk_xla(
    X0m, sqrtw_blk, Qblk, pXs, xns, wrn_blk, idx_blk, *, n, precision
):
    """(mb, Kc) genome-wide max LODs, XLA engine with hoisted trait parts."""
    maxr2 = max_r2_perms_xla(
        X0m, sqrtw_blk, Qblk, pXs, xns, wrn_blk, idx_blk, precision=precision
    )
    return maxr2_to_lod(maxr2, n, precision=precision)


def bulkscan_perms(
    Y,
    G,
    K,
    covar=None,
    *,
    nperms: int = 1000,
    rndseed: int = 0,
    method: str = "null-grid",
    h2_grid=None,
    add_intercept: bool = True,
    weights=None,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    solve_method: str = "qr",
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    precision: PrecisionConfig = DEFAULT_PRECISION,
    engine: str = "auto",
    trait_chunk: Optional[int] = None,
    perm_chunk: int = 2048,
    original: bool = True,
    tile_p: int = 64,
    interpret: bool = False,
    checkpoint=None,
    _adj_pvals: bool = True,
    missing: str = "error",
) -> BulkPermResult:
    """Permutation-null genome-wide max LODs for every trait at once.

    Semantics per trait are exactly ``scan(y_j, G, K, permutation_test=True,
    nperms=nperms, rndseed=rndseed)`` followed by a max over markers — same
    whitened-residual shuffles, SAME shuffle indices (so results for trait j
    match the single-trait call at the same fitted h2) — but the null h2 is
    fitted per trait the ``bulkscan`` way (``method``: "null-grid" grid
    argmax, default, or "null-exact" per-trait Brent).

    ``engine``: "auto" picks the fused Pallas kernel on a CUDA GPU at f32
    GEMM dtype (the (p, m, nperms) LOD tensor never exists; running max in
    registers), "xla" the chunked vmap formulation (any backend).
    ``trait_chunk`` / ``perm_chunk`` bound device memory per step.

    ``K`` may be a :class:`~bulklmm_tpu.ops.lowrank.LowRankKinship`: the
    whole test then runs on the rank-k Woodbury likelihood with whitening
    in standard coordinates (``A_j = I + U diag(sqrt(w_j)-1) U^T``; the
    whitened residual's standard coordinates are iid under the null) — no
    (n, n) kinship and no host eigh, for cohorts beyond the eigh wall
    (XLA engine only). Note the shuffles act on DIFFERENT (equally valid)
    exchangeable coordinates than the full-rank engine's rotated basis, so
    even at k = n the individual permutation columns are different draws
    from the same null — the OBSERVED column and the threshold
    distribution agree (tested vs a dense whitening oracle), the
    realization-level perm columns do not.

    Returns :class:`BulkPermResult`; feed ``result.perm_maxima`` to
    :func:`bulklmm_tpu.get_thresholds_bulk` for (levels x m) thresholds.
    ``log10_adj_pvals`` holds -log10 of the standard permutation-adjusted
    genome-wide p-value per trait, ``(1 + #{null max >= observed}) /
    (nperms + 1)``.
    """
    from ..ops.lowrank import LowRankKinship
    from .missing import (
        finite_flag, group_checkpoint, maybe_masked, raise_if_missing,
        subset_kinship,
    )

    masked = maybe_masked(
        Y, missing,
        lambda Ys, rows, traits, gi: bulkscan_perms(
            Ys, np.asarray(G)[rows], subset_kinship(K, rows),
            None if covar is None else np.asarray(covar)[rows],
            nperms=nperms, rndseed=rndseed, method=method, h2_grid=h2_grid,
            add_intercept=add_intercept,
            weights=None if weights is None else np.asarray(weights)[rows],
            prior_variance=prior_variance,
            prior_sample_size=prior_sample_size, reml=reml,
            solve_method=solve_method, optim_interval=optim_interval,
            decomp_scheme=decomp_scheme, precision=precision, engine=engine,
            trait_chunk=trait_chunk, perm_chunk=perm_chunk,
            original=original, tile_p=tile_p, interpret=interpret,
            checkpoint=group_checkpoint(checkpoint, gi),
            _adj_pvals=_adj_pvals,
        ),
        covar=covar, weights=weights, add_intercept=add_intercept,
        what="bulkscan_perms",
    )
    if masked is not None:
        return masked
    _finite = finite_flag(Y)  # background guard, checked at return

    lowrank = isinstance(K, LowRankKinship)
    if lowrank and engine == "pallas":
        raise ValueError(
            "engine='pallas' is not available for LowRankKinship inputs "
            "(the fused kernel assumes the rotated basis's diagonal "
            "whitening); use engine='xla' or 'auto'."
        )

    # content digest of the raw user inputs (pre-conversion), folded into
    # the checkpoint fingerprint — same-shape same-seed input edits between
    # runs must refuse to resume, not silently mix maxima rows
    data_digest = (
        _data_fingerprint(Y, G, covar, weights, K)
        if checkpoint is not None else None
    )
    Y, G, K, covar, h2_grid, prior = _perm_common_inputs(
        Y, G, K, covar, method=method, engine=engine, h2_grid=h2_grid,
        weights=weights, add_intercept=add_intercept,
        prior_variance=prior_variance, prior_sample_size=prior_sample_size,
    )
    n, m = Y.shape
    if lowrank:
        res = _bulkscan_perms_lowrank(
            Y, G, K, covar,
            nperms=nperms, rndseed=rndseed, method=method, h2_grid=h2_grid,
            prior=prior, reml=reml, optim_interval=optim_interval,
            precision=precision, trait_chunk=trait_chunk,
            perm_chunk=perm_chunk, original=original, checkpoint=checkpoint,
            data_digest=data_digest,
        )
        raise_if_missing(_finite, "bulkscan_perms")
        return _attach_adj_pvals(res) if _adj_pvals else res
    G = jnp.asarray(G)
    dtype = precision.resolve_solve()
    Ut, lam = resolve_kinship(K, decomp_scheme, dtype)

    X0m, h2_list, sigma2_list, sqrtw, Qstack, wrn = _bulkperm_prep(
        Y.astype(dtype), G.astype(dtype), covar.astype(dtype), Ut, lam,
        h2_grid.astype(dtype),
        prior=prior, reml=reml, method=method, solve_method=solve_method,
        optim_interval=optim_interval, precision=precision,
    )

    eng, cap = _resolve_perm_engine(
        engine, n, precision=precision, interpret=interpret,
        p=G.shape[1], trait_block=trait_chunk,
    )
    perm_chunk = min(perm_chunk, cap)
    if trait_chunk is None:
        trait_chunk = _default_trait_chunk(eng)

    idx = permutation_indices(n, nperms, rndseed, original=original)
    K_total = int(idx.shape[0])

    ckpt = _perm_checkpoint(
        checkpoint, n=n, m=m, p=G.shape[1], nperms=nperms, rndseed=rndseed,
        method=method, reml=reml, original=original, trait_chunk=trait_chunk,
        h2_grid=h2_grid, prior=prior, rank="full",
        precision=precision, engine=eng, data_digest=data_digest,
    )

    # results stay device-resident; every chunk dispatch is async (no host
    # sync in the loop, unless checkpointing), so the per-chunk kernels
    # pipeline back-to-back
    trait_rows = []
    for ms in range(0, m, trait_chunk):
        me = min(ms + trait_chunk, m)
        mb = me - ms
        if ckpt is not None:
            done = ckpt.load(ms, me)
            if done is not None:
                trait_rows.append(jnp.asarray(done))
                continue
        sw_b, Q_b, wrn_b = sqrtw[ms:me], Qstack[ms:me], wrn[:, ms:me]
        if eng == "pallas" and mb % 8:
            # zero-padded traits: all-zero operands -> max r2 = 0, no NaN
            pad = -mb % 8
            sw_b = jnp.pad(sw_b, ((0, pad), (0, 0)))
            Q_b = jnp.pad(Q_b, ((0, pad), (0, 0), (0, 0)))
            wrn_b = jnp.pad(wrn_b, ((0, 0), (0, pad)))
        if eng == "xla":
            # perm-independent trait parts hoisted out of the chunk loop
            pXs, xns = _bulkperm_xla_trait_block(
                X0m, sw_b, Q_b, precision=precision
            )
        elif eng == "pallas":
            inv_xn = _bulkperm_pallas_trait_block(
                X0m, sw_b, Q_b, precision=precision
            )
        perm_cols = []
        for ks in range(0, K_total, perm_chunk):
            ke = min(ks + perm_chunk, K_total)
            if eng == "xla":
                blk = _bulkperm_chunk_xla(
                    X0m, sw_b, Q_b, pXs, xns, wrn_b, idx[ks:ke],
                    n=n, precision=precision,
                )
            else:  # eng == "pallas" (_resolve_perm_engine returns only xla/pallas)
                blk = _bulkperm_chunk_pallas(
                    X0m, sw_b, Q_b, inv_xn, wrn_b, idx[ks:ke],
                    n=n, precision=precision,
                    tile_p=tile_p, interpret=interpret,
                )
            perm_cols.append(blk[:mb])
        row = (
            perm_cols[0] if len(perm_cols) == 1
            else jnp.concatenate(perm_cols, axis=1)
        )
        if ckpt is not None:
            ckpt.save(ms, me, row)
        trait_rows.append(row)
    maxlods = (
        trait_rows[0] if len(trait_rows) == 1
        else jnp.concatenate(trait_rows, axis=0)
    )

    res = BulkPermResult(
        maxlods=maxlods,
        h2_null_list=h2_list,
        sigma2_e_list=sigma2_list,
        nperms=nperms,
        original=original,
    )
    raise_if_missing(_finite, "bulkscan_perms")
    return _attach_adj_pvals(res) if _adj_pvals else res
