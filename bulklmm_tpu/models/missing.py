"""Missing-phenotype (NaN) support: pattern-grouped complete-case scans.

The reference ducks missingness entirely — its tour feeds a
"spleen-pheno-nomissing.csv" input and its readers do no NaN handling
(/root/reference/README.md:157, /root/reference/src/readData.jl:159). Real
trait matrices have per-trait missing individuals, so every public engine
here accepts a ``missing=`` keyword:

- ``"error"`` (default): refuse non-finite phenotypes with a clear error.
  The guard is asynchronous: a device-side ``isfinite`` reduction started
  when Y lands on the device and checked only at result-assembly time, so the hot path
  pays ~0 latency (a host-side scan of a biobank-scale Y costs ~200 ms;
  the async device reduction overlaps compute entirely).
- ``"mask"``: per-trait complete-case analysis. Exact — NOT a weighting
  approximation: a shared rotation cannot represent per-trait row deletion
  (K[obs, obs] has pattern-specific eigenvectors), so traits are grouped
  by missingness PATTERN and each group runs the full engine on its row
  subset (its own rotation, its own null fits, its own effective n through
  every LOD / sigma^2 formula), then LOD columns scatter back. Traits
  sharing a pattern — the common case: sample QC drops the same
  individuals from many traits — share one rotation and one compiled
  program.
- ``"drop"``: listwise deletion — drop every individual missing in ANY
  trait; one rotation for all traits. This is exactly the preprocessing
  the reference's "nomissing" input file bakes in upstream.

Ill-defined cases refuse with named traits: a pattern with fewer than
``c + 2`` observations (covariate count + intercept + marker + 1 residual
df) cannot be tested; non-finite covariates/weights/genotypes are the
user's to impute (genotype NaN checking would cost a full (n, p) pass on
the streamed engines' host panels — documented, not scanned).

Oracle guarantee (tested in tests/test_missing.py): a masked run equals
the engine run on the hand-subsetted complete data, per trait — exactly
up to batched-GEMM summation order (bit-exact when the group's shapes
match the oracle's, <= 1e-9 otherwise). Permutation engines draw the
same shuffle indices as the complete-case run would (indices depend on
(n_obs, nperms, seed) only — so pattern groups that happen to share an
n_obs also share indices; each trait's own FWER threshold is valid
regardless, exactly as in the complete-case analyses it reproduces).
"""

from __future__ import annotations

import os
import warnings
import weakref

import jax
import jax.numpy as jnp
import numpy as np

#: memoized missing='error' verdicts for (immutable) device arrays,
#: keyed by id with weakref.finalize cleanup — see finite_flag
_DEVICE_FLAG_CACHE: dict = {}

#: minimum observations beyond the covariate column count: +1 for the
#: tested marker, +1 residual degree of freedom
MIN_EXTRA_OBS = 2

#: above this many distinct missingness patterns, warn: each pattern
#: compiles its own program shapes (one rotation + one engine trace each)
PATTERN_WARN_THRESHOLD = 64

_MODES = ("error", "mask", "drop")


def finite_flag(Y):
    """Start the missing='error' finiteness guard; returns a zero-arg
    callable materialized by :func:`raise_if_missing` at return time.

    Cost model (the guard sits on the hot path of every engine): a
    device-side reduction would need a synchronous host fetch in front of
    the scan's dispatch. Host arrays instead
    scan on a BACKGROUND THREAD (np.isfinite releases the GIL, so the
    pass overlaps device dispatch/compute; joined at return, net wall
    cost ~0 even for GB-scale Y). Tiny arrays check inline; arrays
    already on device use the async jnp reduction (the RTT is amortized
    by whatever put them there).
    """
    if isinstance(Y, jax.Array) and not isinstance(Y, np.ndarray):
        # Device array: a synchronous scalar fetch would stall the
        # dispatch loop, and so would a fetch THREAD via GIL switch
        # intervals; dispatching the tiny reduction is a program of its
        # own. So: (a) the
        # verdict is MEMOIZED per array — jax.Arrays are immutable, so
        # repeated scans of the same staged Y (the marginal-scan
        # workflow) pay once; (b) the scalar rides a runtime-level async
        # D2H copy, making bool(flag) at return time a local read.
        key = id(Y)
        if key in _DEVICE_FLAG_CACHE:
            ok = _DEVICE_FLAG_CACHE[key]
            return lambda: ok
        flag = jnp.all(jnp.isfinite(Y))
        try:
            flag.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass

        def get(_key=key, _ref=Y):
            ok = bool(flag)
            if _key not in _DEVICE_FLAG_CACHE:
                _DEVICE_FLAG_CACHE[_key] = ok
                # drop the entry when the array dies (ids recycle)
                weakref.finalize(
                    _ref, _DEVICE_FLAG_CACHE.pop, _key, None
                )
            return ok

        return get
    Yn = np.asarray(Y)
    if Yn.dtype.kind not in "fc":
        return lambda: True
    if Yn.size <= 1_000_000:
        ok = bool(np.isfinite(Yn).all())
        return lambda: ok
    return _background(lambda: bool(np.isfinite(Yn).all()))


def _background(compute):
    """Run ``compute`` on a daemon thread; return a joining getter."""
    import threading

    box = {}

    def work():
        try:
            box["ok"] = compute()
        except BaseException as e:  # surfaced at the join
            box["err"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()

    def get():
        t.join()
        if "err" in box:
            raise box["err"]
        return box["ok"]

    return get


def raise_if_missing(flag, what: str) -> None:
    """Materialize the guard flag; refuse with the remediation recipe."""
    if not (flag() if callable(flag) else bool(flag)):
        raise ValueError(
            f"{what}: the phenotype matrix contains non-finite (missing) "
            "values. Pass missing='mask' for per-trait complete-case "
            "analysis (traits grouped by missingness pattern, one "
            "rotation per pattern) or missing='drop' to drop every "
            "individual with any missing trait (single rotation). "
            "See COMPAT.md #18."
        )


def validate_missing_kwarg(missing: str) -> None:
    if missing not in _MODES:
        raise ValueError(f"missing must be one of {_MODES}, got {missing!r}")


def _ncov_total(covar, add_intercept: bool) -> int:
    """Total covariate column count including the intercept."""
    if covar is None:
        return 1
    c = 1 if np.ndim(covar) == 1 else int(np.shape(covar)[1])
    return c + int(bool(add_intercept))


def missing_groups(finite: np.ndarray, *, drop: bool):
    """[(rows, traits)] index groups from the (n, m) finite mask.

    ``drop``: one group of rows finite across ALL traits. Otherwise one
    group per distinct missingness pattern (column of the mask); rows and
    traits are strictly increasing (h5py-compatible fancy selection).
    """
    if drop:
        rows = np.flatnonzero(finite.all(axis=1))
        return [(rows, np.arange(finite.shape[1]))]
    pats, inv = np.unique(finite.T, axis=0, return_inverse=True)
    groups = [
        (np.flatnonzero(pats[gi]), np.flatnonzero(inv == gi))
        for gi in range(pats.shape[0])
    ]
    if len(groups) > PATTERN_WARN_THRESHOLD:
        warnings.warn(
            f"{len(groups)} distinct missingness patterns: each compiles "
            "its own program shapes (one kinship decomposition + engine "
            "trace per pattern). Consider missing='drop', or imputing "
            "rarely-observed traits.",
            stacklevel=3,
        )
    return groups


def _check_group_sizes(groups, ncov: int, *, what: str, drop: bool) -> None:
    need = ncov + MIN_EXTRA_OBS
    bad = [(rows, traits) for rows, traits in groups if len(rows) < need]
    if not bad:
        return
    if drop:
        n_left = len(bad[0][0])
        raise ValueError(
            f"{what}: missing='drop' leaves {n_left} fully-observed "
            f"individuals but the model needs at least {need} "
            f"({ncov} covariate columns + marker + residual df); use "
            "missing='mask' for per-trait complete-case analysis."
        )
    names = []
    for rows, traits in bad[:8]:
        t = ", ".join(map(str, traits[:6])) + ("..." if len(traits) > 6 else "")
        names.append(f"trait(s) [{t}] with {len(rows)} observations")
    raise ValueError(
        f"{what}: {sum(len(t) for _, t in bad)} trait(s) have fewer than "
        f"{need} observations ({ncov} covariate columns + marker + "
        f"residual df): " + "; ".join(names) + ". Drop or impute these "
        "traits before scanning."
    )


def _check_side_inputs(covar, weights, what: str) -> None:
    for name, a in (("covar", covar), ("weights", weights)):
        if a is not None and not np.all(np.isfinite(np.asarray(a))):
            raise ValueError(
                f"{what}: {name} contains non-finite values; missing "
                "covariates/weights are not maskable (they define the "
                "model for every trait) — impute or drop those "
                "individuals explicitly."
            )


def subset_kinship(K, rows: np.ndarray):
    """Row/column subset of a kinship input, preserving its type.

    - raw (n, n) array -> K[rows][:, rows]
    - KinshipDecomposition -> reconstructed K subset (raw array; the
      engine re-decomposes — the subset's eigenvectors genuinely differ)
    - LowRankKinship -> exact rank-preserving refactorization of
      ``U[rows] diag(lam) U[rows]^T``: with B = U[rows] sqrt(lam) and the
      k x k eigendecomposition B^T B = V diag(mu) V^T, the subset kinship
      is ``U' diag(mu) U'^T`` with orthonormal ``U' = B V mu^{-1/2}``
      (near-zero mu dropped — rows can reduce the rank).
    """
    from ..ops.lowrank import LowRankKinship
    from ..ops.rotation import KinshipDecomposition

    if isinstance(K, LowRankKinship):
        U = np.asarray(K.U, dtype=np.float64)[rows]
        lam = np.maximum(np.asarray(K.lam, dtype=np.float64), 0.0)
        B = U * np.sqrt(lam)[None, :]
        mu, V = np.linalg.eigh(B.T @ B)
        keep = mu > 1e-12 * max(float(mu[-1]), 1.0)
        mu, V = mu[keep][::-1], V[:, keep][:, ::-1]  # descending
        Us = (B @ V) / np.sqrt(mu)[None, :]
        return LowRankKinship(
            U=jnp.asarray(Us, dtype=K.U.dtype),
            lam=jnp.asarray(mu, dtype=K.lam.dtype),
        )
    if isinstance(K, KinshipDecomposition):
        Ut = (
            K.Ut_host if K.Ut_host is not None
            else np.asarray(K.Ut, dtype=np.float64)
        )
        lam = (
            K.lam_host if K.lam_host is not None
            else np.asarray(K.lam, dtype=np.float64)
        )
        Kfull = (Ut.T * lam[None, :]) @ Ut
        return Kfull[np.ix_(rows, rows)]
    return np.asarray(K)[np.ix_(rows, rows)]


class RowSubsetView:
    """Lazy row subset of a host (n, p) sliceable (numpy, np.memmap, h5py)
    for the marker-streamed engines: column blocks are sliced FIRST (a
    view / contiguous read), then the subset rows gathered — the full
    (n_obs, p) panel is never materialized."""

    def __init__(self, G, rows: np.ndarray):
        self._g = G
        self._rows = np.asarray(rows)

    @property
    def shape(self):
        return (len(self._rows),) + tuple(self._g.shape[1:])

    @property
    def dtype(self):
        return self._g.dtype

    def __getitem__(self, idx):
        if isinstance(idx, tuple) and len(idx) == 2:
            r, c = idx
            return self._g[:, c][self._rows[r]]
        # plain row indexing (checkpoint fingerprint chunks)
        return self._g[self._rows[idx]]

    def __array__(self, dtype=None, copy=None):
        # materializes the subset — the checkpoint fingerprint takes this
        # path only for small (< hash cap) panels; without it np.asarray
        # would wrap the view in a 0-d OBJECT array whose bytes are a heap
        # pointer (a nondeterministic digest between identical runs)
        out = np.asarray(self._g[self._rows])
        return out.astype(dtype) if dtype is not None else out


class ColSubsetOut:
    """Write-through column subset of a host (p, m) output (numpy or
    np.memmap): the streamed engine writes full-width row slabs
    ``out[lo:hi] = blk``; this maps them onto the group's trait columns
    of the user's array (mixed slice+fancy assignment writes in place)."""

    def __init__(self, out, traits: np.ndarray):
        self._out = out
        self._traits = np.asarray(traits)

    @property
    def shape(self):
        return (self._out.shape[0], len(self._traits))

    @property
    def dtype(self):
        return self._out.dtype

    def __getitem__(self, idx):
        return self._out[idx, self._traits]

    def __setitem__(self, idx, value):
        self._out[idx, self._traits] = value


def maybe_masked(Y, missing: str, run_group, *, covar=None, weights=None,
                 add_intercept: bool = True, what: str):
    """Dispatch a masked run, or return None when Y is fully observed.

    ``run_group(Ys, rows, traits, gi)`` executes the engine on one pattern
    group's complete-case data and returns its result object; results are
    stitched trait-wise by :func:`stitch_results`.
    """
    validate_missing_kwarg(missing)
    if missing == "error":
        return None
    # scan the ORIGINAL dtype first (no copy): the f64 conversion below
    # would double host RAM for a complete f32 matrix just to find no NaN
    Y0 = np.asarray(Y)
    Y0 = Y0[:, None] if Y0.ndim == 1 else Y0
    if Y0.dtype.kind not in "fc":
        return None
    finite = np.isfinite(Y0)
    if finite.all():
        return None
    Yn = Y0.astype(np.float64, copy=False)  # no copy when already f64
    _check_side_inputs(covar, weights, what)
    groups = missing_groups(finite, drop=(missing == "drop"))
    _check_group_sizes(
        groups, _ncov_total(covar, add_intercept),
        what=what, drop=(missing == "drop"),
    )
    pairs = []
    for gi, (rows, traits) in enumerate(groups):
        Ys = Yn[np.ix_(rows, traits)]
        pairs.append((traits, run_group(Ys, rows, traits, gi)))
    return stitch_results(pairs, m=Yn.shape[1])


def group_checkpoint(checkpoint, gi: int):
    """Per-pattern checkpoint subdirectory (each group is its own sweep:
    different n_obs, different shuffle indices, different fingerprint)."""
    if checkpoint is None:
        return None
    return os.path.join(str(checkpoint), f"pattern_{gi:03d}")


def _scatter(vals_by_traits, m: int, axis: int):
    """Allocate the stitched host array and scatter each group's slab
    onto its trait indices along ``axis``."""
    first = vals_by_traits[0][1]
    shape = list(first.shape)
    shape[axis] = m
    dst = np.full(shape, np.nan, dtype=np.asarray(first).dtype)
    for traits, v in vals_by_traits:
        idx = [slice(None)] * dst.ndim
        idx[axis] = traits
        dst[tuple(idx)] = np.asarray(v)
    return dst


def stitch_results(pairs, m: int):
    """Reassemble per-group result dataclasses into one with m traits.

    Arrays scatter on their traits axis (axis 0 for ``maxlods`` — the
    perm engines' (m, K) maxima — and the last axis everywhere else:
    L/h2_panel/beta/pvals are (p, m_g), the per-trait vectors (m_g,)).
    Dict fields (LOCO per-chromosome maps) scatter value-wise; scalar
    config fields must agree across groups and pass through.
    """
    import dataclasses

    first = pairs[0][1]
    if not dataclasses.is_dataclass(first):
        raise TypeError(f"cannot stitch {type(first)!r}")
    out = {}
    for f in dataclasses.fields(first):
        vals = [(traits, getattr(r, f.name)) for traits, r in pairs]
        v0 = vals[0][1]
        axis = 0 if f.name == "maxlods" else -1
        if v0 is None:
            out[f.name] = None
        elif isinstance(v0, dict):
            out[f.name] = {
                k: _scatter([(t, np.asarray(v[k])) for t, v in vals], m, axis)
                for k in v0
            }
        elif np.ndim(v0) == 0:
            if not all(np.ndim(v) == 0 and v == v0 for _, v in vals):
                raise ValueError(
                    f"pattern groups disagree on scalar result field "
                    f"{f.name!r}: {[v for _, v in vals]!r}"
                )
            out[f.name] = v0
        else:
            stitched = _scatter(
                [(t, np.asarray(v)) for t, v in vals], m, axis
            )
            if f.name == "maxlods":
                # restore the documented device-resident contract
                # (BulkPermResult.maxlods feeds on-device threshold /
                # adjusted-p reductions downstream); MB-scale upload
                stitched = jnp.asarray(stitched)
            out[f.name] = stitched
    return type(first)(**out)


def subset_rows_single(y, g, K, covar, weights, *, missing: str, what: str,
                       add_intercept: bool = True):
    """Single-trait complete-case row subset (scan / scan_perms_lite):
    'mask' and 'drop' coincide at m = 1. Returns the subset tuple, or
    None when y is fully observed. The result needs no stitching — LODs
    are per marker and p is unchanged."""
    validate_missing_kwarg(missing)
    yn = np.asarray(y, dtype=np.float64)
    y2 = yn[:, None] if yn.ndim == 1 else yn
    finite = np.isfinite(y2).all(axis=1)
    if missing == "error":
        raise_if_missing(finite.all(), what)
        return None
    if finite.all():
        return None
    _check_side_inputs(covar, weights, what)
    rows = np.flatnonzero(finite)
    ncov = _ncov_total(covar, add_intercept)
    _check_group_sizes(
        [(rows, np.array([0]))], ncov, what=what, drop=False
    )
    gs = g[jnp.asarray(rows)] if isinstance(g, jnp.ndarray) else (
        np.asarray(g)[rows]
    )
    cv = None if covar is None else np.asarray(covar)[rows]
    ws = None if weights is None else np.asarray(weights)[rows]
    return yn[rows] if yn.ndim == 1 else y2[rows], gs, subset_kinship(
        K, rows
    ), cv, ws
