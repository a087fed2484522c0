"""Multi-host (pod) execution: per-process trait feeding + sharded output.

The reference explicitly defers multi-machine distribution to future work
(reference README.md:66-72). Here a pod run is:

  1. ``init_distributed()`` on every host (jax.distributed handshake);
  2. one global ("traits",) mesh over every device of every process
     (:func:`make_global_mesh`);
  3. each process feeds ONLY its local trait block
     (:func:`local_trait_slice` -> :func:`bulkscan_distributed`), which is
     assembled into one global trait-sharded array via
     ``jax.make_array_from_process_local_data`` — no host ever holds the
     full trait matrix;
  4. results stay sharded: each process reads back / writes only its own
     LOD columns (``save_dir=...`` writes one ``lod_shard_<pid>.npz`` per
     process).

Trait sharding is embarrassingly parallel: the only cross-host traffic is
eigen-factor replication (n x n, tiny; sent once) — the scan
kernels themselves run collective-free, and every process executes the same
jitted SPMD program.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.bulkscan import (
    _bulkscan_alt_grid_core,
    _bulkscan_null_exact_core,
    _bulkscan_null_grid_core,
)
from ..models.scan import _apply_weights
from ..ops.rotation import resolve_kinship_with_host
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig

TRAITS_AXIS = "traits"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> int:
    """Initialize JAX's multi-host runtime; returns this process's index.

    No-ops when already initialized or when running single-process (so the
    same launcher script works on one host and on a pod).

    ``local_device_ids`` (int or list of ints) restricts this process to
    those local devices: several processes on one host each own one card
    instead of every process opening them all.

    ``jax.distributed.initialize`` must run BEFORE any backend initializes,
    and ``jax.process_count()`` itself initializes them — so when explicit
    coordinator args are given, initialize() is attempted first and an
    already-initialized runtime is detected from its error, never by
    touching the backends up front.
    """
    if coordinator_address is None and num_processes in (None, 1):
        # single-process (or env-configured) path: safe to query
        return jax.process_index() if jax.process_count() > 1 else 0
    if num_processes is not None and num_processes > 1:
        _own_autotuning()
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as e:
        msg = str(e).lower()
        # jax's genuinely-already-initialized message is
        # "distributed.initialize should only be called once." — no-op,
        # as documented. "must be called before" means some backend was
        # touched first in THIS process: surface it with actionable advice.
        if "once" in msg:
            pass
        elif "before" in msg:
            raise RuntimeError(
                "jax.distributed.initialize must run before any JAX "
                "backend initializes: call init_distributed (or "
                "jax.distributed.initialize) before the first array/device "
                "operation in this process."
            ) from e
        else:
            raise
    return jax.process_index()


def _own_autotuning() -> None:
    """Have every process autotune its own GPU fusions.

    By default XLA shares autotuning across the processes of a
    distributed run: each autotunes a share of the fusions and they
    exchange results. On NVIDIA H100s with jax 0.9.0, four podscan
    processes compiling the pod scan that way segfaulted in one process
    (on four cards, and on one card shared by four processes); with
    ``--xla_gpu_shard_autotuning=false`` the same runs passed. XLA reads
    ``XLA_FLAGS`` when a backend starts, and :func:`init_distributed` runs
    before any does. A caller's own setting of the flag is kept."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_shard_autotuning" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_gpu_shard_autotuning=false"
        ).strip()


def make_global_mesh() -> Mesh:
    """A 1-D ("traits",) mesh over every device of every process, ordered so
    each process's devices own one contiguous block of the traits axis."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs), (TRAITS_AXIS,))


def _shard_geometry(m_total: int, mesh: Mesh):
    """(per_shard, M_padded, local_ndev, col_lo, col_hi) for this process."""
    tshards = mesh.shape[TRAITS_AXIS]
    nproc = jax.process_count()
    if tshards % nproc != 0:
        raise ValueError(
            f"traits-axis size {tshards} must be a multiple of the process "
            f"count {nproc} (every process contributes the same device count)"
        )
    per_shard = -(-m_total // tshards)
    M = per_shard * tshards
    ld = tshards // nproc
    pid = jax.process_index()
    # A tail process can own nothing but padding (m_total < lo): clamp both
    # ends so its slice is empty rather than negative.
    lo = min(pid * ld * per_shard, m_total)
    hi = min(lo + ld * per_shard, m_total)
    return per_shard, M, ld, lo, hi


def local_trait_slice(m_total: int, mesh: Optional[Mesh] = None) -> slice:
    """The trait columns this process owns under even trait sharding.

    With a ``mesh``, blocks align to the padded per-device shard width, so a
    slice of the global trait matrix fed to :func:`bulkscan_distributed`
    lands exactly on this process's devices. Without one, plain
    ceil-division by process count (the two agree whenever the device count
    per process divides the per-process trait block).
    """
    if mesh is None:
        nproc = jax.process_count()
        pid = jax.process_index()
        per = -(-m_total // nproc)
        return slice(pid * per, min((pid + 1) * per, m_total))
    _, _, _, lo, hi = _shard_geometry(m_total, mesh)
    return slice(lo, hi)


class DistributedScanResult(NamedTuple):
    """Output of :func:`bulkscan_distributed` — sharded-first.

    L: (p, M_padded) global trait-sharded LOD matrix (a multi-host
       ``jax.Array``; only this process's columns are addressable).
    h2: (M_padded,) per-trait h2 (null engines) or (p, M_padded) panel
       (alt-grid), trait-sharded like ``L``.
    trait_lo / trait_hi: the [lo, hi) global trait columns this process owns.
    L_local: (p, hi - lo) numpy copy of this process's unpadded LOD columns.
    h2_local: matching local h2 columns.
    """

    L: jax.Array
    h2: jax.Array
    trait_lo: int
    trait_hi: int
    L_local: np.ndarray
    h2_local: np.ndarray


def _local_cols(arr: jax.Array, axis: int) -> np.ndarray:
    """Concatenate this process's addressable shards along ``axis``."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[axis].start or 0)
    blocks, seen = [], set()
    for s in shards:
        key = (s.index[axis].start, s.index[axis].stop)
        if key in seen:  # replicated over another mesh axis
            continue
        seen.add(key)
        blocks.append(np.asarray(s.data))
    return np.concatenate(blocks, axis=axis)


def _replicated(x, mesh: Mesh, dtype) -> jax.Array:
    """A fully-replicated global array from identical per-process data."""
    x = np.asarray(x, dtype=dtype)
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(*((None,) * x.ndim))), x, x.shape
    )


def bulkscan_distributed(
    Y_local,
    G,
    K,
    covar=None,
    *,
    m_total: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    method: str = "null-grid",
    h2_grid=None,
    add_intercept: bool = True,
    weights=None,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    solve_method: str = "qr",
    precision: PrecisionConfig = DEFAULT_PRECISION,
    save_dir: Optional[str] = None,
) -> DistributedScanResult:
    """Multi-trait scan where each process supplies ONLY its trait block.

    ``Y_local`` must be exactly ``Y_global[:, local_trait_slice(m_total,
    mesh)]``; genotypes / covariates / kinship are small and replicated
    (every process passes the same arrays). Numerics are identical to
    :func:`bulklmm_tpu.bulkscan` — the jitted cores are shared; only data
    placement differs. Single-process calls work too (m_total defaults to
    ``Y_local.shape[1]``), exercising the same assembly path.

    With ``save_dir``, this process writes its own LOD columns to
    ``<save_dir>/lod_shard_<pid>.npz`` (fields: trait_lo, trait_hi, lod,
    h2) — the pod-scale output path where no host gathers the full matrix.
    """
    if method not in ("null-grid", "null-exact", "alt-grid"):
        # validate BEFORE the O(n^3) eigh + O(n^2 m) host rotation
        raise ValueError(
            "method must be one of 'null-grid', 'null-exact', 'alt-grid'"
        )
    if mesh is None:
        mesh = make_global_mesh()
    if m_total is None:
        if jax.process_count() > 1:
            raise ValueError("m_total (global trait count) is required multi-process")
        m_total = np.shape(Y_local)[1]

    per_shard, M, ld, lo, hi = _shard_geometry(m_total, mesh)
    Y_local = np.asarray(Y_local, dtype=np.float64)
    Y_local = Y_local[:, None] if Y_local.ndim == 1 else Y_local
    if Y_local.shape[1] != hi - lo:
        raise ValueError(
            f"process {jax.process_index()} expected {hi - lo} local trait "
            f"columns (= local_trait_slice({m_total}, mesh)), got {Y_local.shape[1]}"
        )
    n = Y_local.shape[0]
    G = np.asarray(G, dtype=np.float64)

    if covar is None:
        covar = np.ones((n, 1))
        add_intercept = False
    else:
        covar = np.asarray(covar, dtype=np.float64)
        covar = covar[:, None] if covar.ndim == 1 else covar

    from ..ops.lowrank import LowRankKinship

    if weights is not None:
        from ..ops.rotation import KinshipDecomposition

        if isinstance(K, (KinshipDecomposition, LowRankKinship)):
            raise ValueError(
                "weights rescale the kinship matrix (K -> WKW); pass the raw "
                "K, not a cached decomposition."
            )
        # Weights scale rows (individuals): local trait blocks scale
        # independently; K -> WKW is identical on every process
        # (models/scan.py::_apply_weights — host f64, non-positive warning).
        Y_local, G, covar, K, add_intercept = _apply_weights(
            Y_local, G, covar, K, weights, add_intercept
        )

    if add_intercept:
        covar = np.concatenate([np.ones((n, 1)), covar], axis=1)

    dtype = precision.resolve_solve()
    prior = (float(prior_variance), float(prior_sample_size))
    if h2_grid is None:
        h2_grid = np.arange(0.0, 0.91, 0.1)
    grid = jnp.asarray(np.asarray(h2_grid), dtype=dtype)
    p = G.shape[1]

    if isinstance(K, LowRankKinship):
        # rank-k engine on the pod: UNROTATED local trait feed (no host
        # rotation at all), replicated (n, k) eigenfactor, same sharded
        # core as the single-process path (ops/lowrank.py).
        if method not in ("null-grid", "null-exact", "alt-grid"):
            raise ValueError(
                "method must be one of 'null-grid', 'null-exact', 'alt-grid'"
            )
        from ..ops.lowrank import _bulkscan_lowrank_core

        pad = ld * per_shard - Y_local.shape[1]
        Yl = (
            np.concatenate([Y_local, np.zeros((n, pad))], axis=1)
            if pad else Y_local
        )
        Ys = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(None, TRAITS_AXIS)), Yl.astype(dtype), (n, M)
        )
        Gs = _replicated(G, mesh, dtype)
        Cs = _replicated(covar, mesh, dtype)
        Us = _replicated(np.asarray(K.U, dtype=np.float64), mesh, dtype)
        lams = _replicated(np.asarray(K.lam, dtype=np.float64), mesh, dtype)
        L, h2 = _bulkscan_lowrank_core(
            Ys, Gs, Cs, Us, lams, grid,
            n=n, prior=prior, reml=reml, precision=precision,
            method=method, optim_interval=optim_interval,
        )
        h2_axis = 1 if method == "alt-grid" else 0
        keep = hi - lo
        L_local = _local_cols(L, axis=1)[:p, :keep]
        h2_local = _local_cols(h2, axis=h2_axis)
        h2_local = h2_local[:keep] if h2_axis == 0 else h2_local[:p, :keep]
        if save_dir is not None:
            from pathlib import Path

            out = Path(save_dir)
            out.mkdir(parents=True, exist_ok=True)
            np.savez(
                out / f"lod_shard_{jax.process_index():05d}.npz",
                trait_lo=lo, trait_hi=hi, lod=L_local, h2=h2_local,
            )
        return DistributedScanResult(
            L=L, h2=h2, trait_lo=lo, trait_hi=hi,
            L_local=L_local, h2_local=h2_local,
        )

    _, _, Ut_h, lam_h = resolve_kinship_with_host(K, decomp_scheme, dtype)

    # Host-side rotation of the LOCAL trait block only (f64, backend-
    # deterministic like the single-process path); pad to this process's
    # device block width.
    y0_local = Ut_h @ Y_local
    pad = ld * per_shard - y0_local.shape[1]
    if pad:
        y0_local = np.concatenate([y0_local, np.zeros((n, pad))], axis=1)
    C0_h = Ut_h @ covar
    X0m_h = Ut_h @ G

    y0s = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(None, TRAITS_AXIS)),
        y0_local.astype(dtype),
        (n, M),
    )
    C0s = _replicated(C0_h, mesh, dtype)
    X0ms = _replicated(X0m_h, mesh, dtype)
    lams = _replicated(lam_h, mesh, dtype)

    if method == "null-grid":
        L, h2 = _bulkscan_null_grid_core(
            y0s, X0ms, C0s, lams, grid,
            prior=prior, reml=reml, method=solve_method, precision=precision,
        )
        h2_axis = 0
    elif method == "null-exact":
        L, h2 = _bulkscan_null_exact_core(
            y0s, X0ms, C0s, lams,
            prior=prior, reml=reml, method=solve_method,
            optim_interval=optim_interval, precision=precision,
        )
        h2_axis = 0
    elif method == "alt-grid":
        L, h2 = _bulkscan_alt_grid_core(
            y0s, X0ms, C0s, lams, grid,
            prior=prior, reml=reml, method=solve_method, precision=precision,
        )
        h2_axis = 1
    else:
        raise ValueError("method must be one of 'null-grid', 'null-exact', 'alt-grid'")

    keep = hi - lo
    L_local = _local_cols(L, axis=1)[:p, :keep]
    h2_local = _local_cols(h2, axis=h2_axis)
    h2_local = h2_local[:keep] if h2_axis == 0 else h2_local[:p, :keep]

    if save_dir is not None:
        from pathlib import Path

        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        np.savez(
            out / f"lod_shard_{jax.process_index():05d}.npz",
            trait_lo=lo, trait_hi=hi, lod=L_local, h2=h2_local,
        )

    return DistributedScanResult(
        L=L, h2=h2, trait_lo=lo, trait_hi=hi, L_local=L_local, h2_local=h2_local
    )


def _check_shards_tile(loaded, m: int, save_dir) -> None:
    """Shard ranges must tile [0, m) exactly: a dead process or a partial
    copy would otherwise merge into silently-fabricated all-zero trait
    columns that downstream thresholds/FDR consume without error."""
    spans = sorted((int(d["trait_lo"]), int(d["trait_hi"])) for d in loaded)
    cursor = 0
    for lo, hi in spans:
        if lo != cursor:
            raise ValueError(
                f"shard files under {save_dir} do not cover traits "
                f"[{cursor}, {lo}) — a process's shard is missing or the "
                "directory is partially copied"
            )
        cursor = hi
    if cursor != m:
        raise ValueError(
            f"shard files under {save_dir} stop at trait {cursor} of {m}"
        )


def merge_shards(save_dir) -> np.ndarray:
    """Assemble the global (p, m) LOD matrix from per-process shard files.

    An offline/driver utility — pod runs themselves never gather.
    """
    from pathlib import Path

    shards = sorted(Path(save_dir).glob("lod_shard_*.npz"))
    if not shards:
        raise FileNotFoundError(f"no lod_shard_*.npz under {save_dir}")
    loaded = [np.load(s) for s in shards]
    m = max(int(d["trait_hi"]) for d in loaded)
    _check_shards_tile(loaded, m, save_dir)
    p = loaded[0]["lod"].shape[0]
    L = np.zeros((p, m))
    for d in loaded:
        L[:, int(d["trait_lo"]):int(d["trait_hi"])] = d["lod"]
    return L


def bulkscan_perms_distributed(
    Y_local,
    G,
    K,
    covar=None,
    *,
    m_total: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    save_dir: Optional[str] = None,
    **kwargs,
):
    """Pod-scale bulk permutation thresholds: each process permutation-
    tests ONLY its local trait block.

    Traits are embarrassingly parallel in the permutation engine (the
    marker panel, kinship, and shuffle indices are trait-independent), and
    the shuffle indices depend only on ``(n, nperms, rndseed)`` — so every
    process draws IDENTICAL permutations and the merged per-process rows
    equal the single-process :func:`bulklmm_tpu.bulkscan_perms` exactly,
    with zero cross-process communication. ``Y_local`` must be exactly
    ``Y_global[:, local_trait_slice(m_total, mesh)]``; remaining keywords
    go to :func:`bulklmm_tpu.bulkscan_perms` (nperms, rndseed, method,
    engine, LowRankKinship ``K``, ...).

    With ``save_dir``, this process writes
    ``<save_dir>/perm_shard_<pid>.npz`` (fields: trait_lo, trait_hi,
    maxlods, h2, sigma2, log10_adj_pvals) — merge offline with
    :func:`merge_perm_shards`. Returns ``(result, trait_lo, trait_hi)``
    where ``result`` is this process's local :class:`BulkPermResult`.
    """
    from ..models.bulkperm import bulkscan_perms

    if mesh is None:
        mesh = make_global_mesh()
    if m_total is None:
        if jax.process_count() > 1:
            raise ValueError(
                "m_total (global trait count) is required multi-process"
            )
        m_total = np.shape(Y_local)[1]
    _, _, _, lo, hi = _shard_geometry(m_total, mesh)
    Y_local = np.asarray(Y_local, dtype=np.float64)
    Y_local = Y_local[:, None] if Y_local.ndim == 1 else Y_local
    if Y_local.shape[1] != hi - lo:
        raise ValueError(
            f"process {jax.process_index()} expected {hi - lo} local trait "
            f"columns (= local_trait_slice({m_total}, mesh)), got {Y_local.shape[1]}"
        )

    res = bulkscan_perms(Y_local, G, K, covar, **kwargs)

    if save_dir is not None:
        from pathlib import Path

        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        np.savez(
            out / f"perm_shard_{jax.process_index():05d}.npz",
            trait_lo=lo, trait_hi=hi,
            maxlods=np.asarray(res.maxlods),
            h2=np.asarray(res.h2_null_list),
            sigma2=np.asarray(res.sigma2_e_list),
            log10_adj_pvals=(
                np.asarray(res.log10_adj_pvals)
                if res.log10_adj_pvals is not None else np.zeros(0)
            ),
        )
    return res, lo, hi


def merge_perm_shards(save_dir) -> np.ndarray:
    """Assemble the global (m, 1 + nperms) permutation maxima matrix from
    per-process ``perm_shard_*.npz`` files (offline/driver utility)."""
    from pathlib import Path

    shards = sorted(Path(save_dir).glob("perm_shard_*.npz"))
    if not shards:
        raise FileNotFoundError(f"no perm_shard_*.npz under {save_dir}")
    loaded = [np.load(s) for s in shards]
    m = max(int(d["trait_hi"]) for d in loaded)
    _check_shards_tile(loaded, m, save_dir)
    K_cols = loaded[0]["maxlods"].shape[1]
    out = np.zeros((m, K_cols))
    for d in loaded:
        out[int(d["trait_lo"]):int(d["trait_hi"])] = d["maxlods"]
    return out
