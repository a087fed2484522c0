"""Branch-free Brent minimization, vmappable and jit-safe.

Device replacement for Optim.jl's Brent + the reference's ``gridbrent``
multi-interval wrapper (src/gridbrent.jl:9-24, src/lmm.jl:81): the classic
parabolic-interpolation/golden-section method is rewritten with ``lax`` masked
updates and a fixed iteration budget so it can be ``vmap``-ed over thousands
of traits or markers simultaneously — every Brent iteration across the whole
batch becomes one fused device step instead of a per-trait CPU loop.

Convergence criterion matches Optim.jl defaults (rel_tol = sqrt(eps),
abs_tol ~ eps-scale): lanes that converge early freeze their state while the
rest keep iterating.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

_CGOLD = 0.3819660112501051  # 2 - golden ratio


def brent_min(
    f: Callable,
    lo,
    hi,
    *,
    rel_tol: float = None,
    abs_tol: float = None,
    maxiter: int = 96,
    dtype=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Minimize scalar ``f`` on [lo, hi]; returns ``(fmin, xmin)``.

    ``f`` must be traceable; endpoints are never evaluated exactly (the first
    probe is the interior golden point), matching Brent's bracketing.
    Tolerances default to Optim.jl's dtype-adaptive values
    (rel_tol = sqrt(eps(T)), abs_tol = eps(T)) — hardcoded float64 values
    would sit below one float32 ulp and the convergence test (and the
    all-lanes early exit) could never fire in f32 mode.

    ``dtype``: domain dtype of the optimization variable. Pass the data's
    dtype (e.g. ``lam.dtype``): python-float bounds otherwise resolve to
    the DEFAULT dtype, and with x64 enabled a strongly-typed f64 probe
    would silently promote an f32 objective to f64.
    """
    lo = jnp.asarray(
        lo, dtype=dtype if dtype is not None else jnp.result_type(lo, 0.0)
    )
    hi = jnp.asarray(hi, dtype=lo.dtype)
    eps = float(jnp.finfo(lo.dtype).eps)
    if rel_tol is None:
        rel_tol = eps ** 0.5
    if abs_tol is None:
        abs_tol = eps

    a, b = lo, hi
    x = a + _CGOLD * (b - a)
    fx = f(x)
    w = v = x
    fw = fv = fx
    d = jnp.zeros_like(x)
    e = jnp.zeros_like(x)

    def cond(st):
        # run until every lane converged (vmap batches the test) or the
        # iteration budget is exhausted — typical convergence is ~30-45
        # iterations, so the early exit halves fixed-budget wall time
        a, b, x, w, v, fx, fw, fv, d, e, it = st
        xm = 0.5 * (a + b)
        tol1 = rel_tol * jnp.abs(x) + abs_tol
        tol2 = 2.0 * tol1
        done = jnp.abs(x - xm) <= (tol2 - 0.5 * (b - a))
        return jnp.logical_and(it < maxiter, ~jnp.all(done))

    def body(st):
        a, b, x, w, v, fx, fw, fv, d, e, it = st
        xm = 0.5 * (a + b)
        tol1 = rel_tol * jnp.abs(x) + abs_tol
        tol2 = 2.0 * tol1
        done = jnp.abs(x - xm) <= (tol2 - 0.5 * (b - a))

        # Trial parabolic fit through (x, w, v).
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q = 2.0 * (q - r)
        p = jnp.where(q > 0.0, -p, p)
        q = jnp.abs(q)
        etemp = e
        safe_q = jnp.where(q == 0.0, 1.0, q)
        d_para = p / safe_q
        u_para = x + d_para
        use_para = (
            (jnp.abs(etemp) > tol1)
            & (jnp.abs(p) < jnp.abs(0.5 * q * etemp))
            & (p > q * (a - x))
            & (p < q * (b - x))
        )
        # Parabolic step landing within tol2 of a bound: nudge toward midpoint.
        d_para = jnp.where(
            (u_para - a < tol2) | (b - u_para < tol2),
            jnp.where(xm - x >= 0.0, tol1, -tol1),
            d_para,
        )
        # Golden-section fallback.
        e_gold = jnp.where(x >= xm, a - x, b - x)
        d_gold = _CGOLD * e_gold

        e_new = jnp.where(use_para, d, e_gold)
        d_new = jnp.where(use_para, d_para, d_gold)

        # Never step less than tol1.
        u = jnp.where(
            jnp.abs(d_new) >= tol1,
            x + d_new,
            x + jnp.where(d_new >= 0.0, tol1, -tol1),
        )
        fu = f(u)

        better = fu <= fx
        a_n = jnp.where(better, jnp.where(u >= x, x, a), jnp.where(u < x, u, a))
        b_n = jnp.where(better, jnp.where(u >= x, b, x), jnp.where(u < x, b, u))

        # Rotate the (x, w, v) history.
        x_n = jnp.where(better, u, x)
        fx_n = jnp.where(better, fu, fx)
        promote_w = (~better) & ((fu <= fw) | (w == x))
        promote_v = (~better) & ~promote_w & ((fu <= fv) | (v == x) | (v == w))
        v_n = jnp.where(better, w, jnp.where(promote_w, w, jnp.where(promote_v, u, v)))
        fv_n = jnp.where(better, fw, jnp.where(promote_w, fw, jnp.where(promote_v, fu, fv)))
        w_n = jnp.where(better, x, jnp.where(promote_w, u, w))
        fw_n = jnp.where(better, fx, jnp.where(promote_w, fu, fw))

        new = (a_n, b_n, x_n, w_n, v_n, fx_n, fw_n, fv_n, d_new, e_new)
        old = (a, b, x, w, v, fx, fw, fv, d, e)
        frozen = tuple(jnp.where(done, o, nv) for o, nv in zip(old, new))
        return frozen + (it + 1,)

    it0 = jnp.zeros((), dtype=jnp.int32)
    st = jax.lax.while_loop(cond, body, (a, b, x, w, v, fx, fw, fv, d, e, it0))
    return st[5], st[2]


def gridbrent(
    f: Callable,
    a: float,
    b: float,
    ninterval: int = 1,
    **brent_kwargs,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Brent on ``ninterval`` equal subdivisions of [a, b]; global minimum.

    Guards against multi-modal profile likelihoods exactly like the
    reference's ``gridbrent`` (src/gridbrent.jl:9-24), but the subintervals
    run as one vmapped batch instead of a broadcast loop.

    The LOWER interval endpoint is additionally evaluated as a candidate:
    bounded Brent never samples exactly at a bound (neither does the
    reference's Optim.Brent), so an h2-profile whose global maximum sits
    AT h2=0 with a local rise toward the boundary would otherwise trap
    the default single-interval fit at the wrong mode (COMPAT.md #19).
    The UPPER endpoint is deliberately NOT a candidate: h2=1 is an open
    boundary of the model (the reference throws there, src/lmm.jl:19-21;
    this framework's delta clamp exists only so traced evaluations stay
    finite) — selecting the clamped point exactly would return a
    degenerate sigma2_e ~ 0 fit whenever a profile rises monotonically
    into the boundary, where Brent's interior 1-eps convergence is the
    meaningful answer. One extra evaluation; well-behaved fits unchanged.
    """
    pts = jnp.linspace(a, b, ninterval + 1, dtype=brent_kwargs.get("dtype"))
    # the lower endpoint rides the SAME vmapped batch as a degenerate
    # [a, a] lane (brent_min converges immediately there and returns
    # (f(a), a)) — a separate f(a) call-site would duplicate the traced
    # objective in the compiled graph
    av = jnp.concatenate([pts[:-1], pts[:1]])
    bv = jnp.concatenate([pts[1:], pts[:1]])
    fmins, xmins = jax.vmap(lambda lo, hi: brent_min(f, lo, hi, **brent_kwargs))(av, bv)
    # a degenerate evaluation must lose, not poison argmin
    fmins = jnp.where(jnp.isnan(fmins), jnp.inf, fmins)
    i = jnp.argmin(fmins)
    return fmins[i], xmins[i]
