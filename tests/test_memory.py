"""Auto memory sizing (utils/memory.py).

The engines must be OOM-free at default settings: trait_chunk/marker_block
are derived from the device budget + footprint model, and the (p, m)-
doesn't-fit case falls back to sequential host trait blocks automatically.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import bulklmm_tpu as bl
from bulklmm_tpu.utils import memory as mem

#: the usable budget of a 16 GiB device (0.82 x 16 GiB)
_BUDGET_16G = 14_087_492_730


def test_flagship_shapes_stay_unchunked():
    """BXD flagship (79 x 7321 x 35554) must keep the single-dispatch
    fast path even on a 16 GB device — auto sizing returns None."""
    assert mem.auto_trait_chunk(79, 7321, 35554, budget=_BUDGET_16G) is None


def test_midsize_shapes_get_a_chunk():
    """A config whose temporaries (not residents) overflow gets a device
    trait chunk, and the modeled footprint at that chunk fits."""
    budget = _BUDGET_16G
    mc = mem.auto_trait_chunk(5000, 50_000, 20_000, budget=budget)
    assert mc is not None and 256 <= mc <= 20_000 and mc % 256 == 0
    used = (
        mem.bulkscan_static_bytes(5000, 50_000, 20_000, 1, 4)
        * mem._STATIC_HEADROOM
        + mem.bulkscan_chunk_bytes(5000, 50_000, mc, 10, 1, 4)
    )
    assert used <= budget


def test_biobank_full_goes_host_blocked():
    """The 5000 x 100k x 20k cohort: residents (12.9 GB incl. the 8 GB
    L) + transient headroom exceed a 16 GB device's budget, so bulkscan
    must take the automatic host-block path (~2k traits/block), and each
    block must itself fit unchunked per the model."""
    n, p, m = 5000, 100_000, 20_000
    budget = _BUDGET_16G
    with pytest.raises(ValueError):
        mem.auto_trait_chunk(n, p, m, budget=budget)
    mh = mem.auto_host_block(n, p, m, budget=budget)
    assert 1024 <= mh <= 4096
    assert mem.auto_trait_chunk(n, p, mh, budget=budget) is None


def test_impossible_config_raises_with_recipe():
    with pytest.raises(ValueError, match="bulkscan_streamed"):
        mem.auto_trait_chunk(5000, 1_000_000, 200_000,
                             budget=16 * 1024**3)


def test_auto_host_block_model():
    # (p, m) result >> HBM but the marker panels fit: the host-block case
    n, p, m = 5000, 150_000, 50_000
    budget = 16 * 1024**3
    with pytest.raises(ValueError):  # no trait_chunk can fix a 30 GB L
        mem.auto_trait_chunk(n, p, m, budget=budget)
    mh = mem.auto_host_block(n, p, m, budget=budget)
    assert mh >= 256 and mh % 256 == 0
    base = mem.bulkscan_static_bytes(n, p, 0, 1, 4) + 2 * n * m * 4
    per = mem.bulkscan_chunk_bytes(n, p, 1, 10, 1, 4) + p * 4
    assert base + per * mh <= budget
    # marker panels alone beyond HBM: host blocks rightly refuse and
    # point at marker streaming
    with pytest.raises(ValueError, match="stream"):
        mem.auto_host_block(5000, 1_000_000, 50_000, budget=budget)


def test_auto_marker_block():
    # plenty of memory: the familiar default
    assert mem.auto_marker_block(5000, 20_000,
                                 budget=32 * 1024**3) == 32_768
    # tight memory: shrinks in 1024 quanta, never below 1024
    small = mem.auto_marker_block(5000, 20_000, budget=3 * 1024**3)
    assert 1024 <= small < 32_768 and small % 1024 == 0


def test_device_memory_budget_positive():
    assert mem.device_memory_budget() > 1024**3


@pytest.fixture(scope="module")
def small_data():
    # p large enough that the (p, m) output term dominates the model —
    # the regime where host blocking (rather than trait chunking) is the
    # only fix
    rng = np.random.default_rng(21)
    n, p, m = 40, 2000, 600
    G = rng.uniform(0, 1, (n, p))
    K = np.asarray(bl.calc_kinship(G))
    Y = rng.normal(size=(n, m))
    return G, Y, K


def _forcing_budget(n, p, m, nout=1):
    """A mocked budget inside the window where auto_trait_chunk must
    refuse (mc < 256) but auto_host_block still fits >= 256 traits."""
    static = mem.bulkscan_static_bytes(n, p, m, 1, 8, n_outputs=nout)
    base = mem.bulkscan_static_bytes(n, p, 0, 1, 8) + 2 * n * m * 8
    per_host = mem.bulkscan_chunk_bytes(n, p, 1, 10, 1, 8) + nout * p * 8
    per_chunk = mem.bulkscan_chunk_bytes(n, p, 1, 10, 1, 8)
    lo = base + 256 * per_host
    hi = static + 256 * per_chunk
    assert lo < hi, "test config cannot force the host-block window"
    return (lo + hi) // 2


def test_host_block_fallback_matches_unchunked(small_data, monkeypatch):
    """Force the (p, m)-overflow path with a tiny mocked budget: the
    host-blocked result must equal the unchunked run, for every method
    and with effects + pvals attached."""
    G, Y, K = small_data
    ref = {
        meth: bl.bulkscan(Y, G, K, method=meth, output_pvals=True,
                          trait_chunk=Y.shape[1])
        for meth in ("null-grid", "null-exact", "alt-grid")
    }
    ref_eff = bl.bulkscan(Y, G, K, output_effects=True,
                          trait_chunk=Y.shape[1])

    n, p, m = G.shape[0], G.shape[1], Y.shape[1]

    def set_budget(nout):
        monkeypatch.setattr(
            mem, "device_memory_budget",
            lambda device=None: _forcing_budget(n, p, m, nout=nout),
        )

    set_budget(2)  # L + device p-values
    # sanity: the mocked budget really forces the fallback (and m > the
    # resulting host block, so the loop runs multiple blocks)
    with pytest.raises(ValueError):
        mem.auto_trait_chunk(n, p, m, itemsize=8, n_outputs=2)
    assert mem.auto_host_block(n, p, m, itemsize=8, n_outputs=2) < m

    for meth in ("null-grid", "null-exact", "alt-grid"):
        # alt-grid's h2 panel is one more (p, m) output in the model
        set_budget(3 if meth == "alt-grid" else 2)
        res = bl.bulkscan(Y, G, K, method=meth, output_pvals=True)
        assert isinstance(res.L, np.ndarray)  # host-assembled
        np.testing.assert_allclose(np.asarray(res.L),
                                   np.asarray(ref[meth].L), atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(res.log10Pvals_mat),
            np.asarray(ref[meth].log10Pvals_mat), atol=1e-9,
        )
        if meth == "alt-grid":
            np.testing.assert_allclose(
                np.asarray(res.h2_panel),
                np.asarray(ref[meth].h2_panel), atol=1e-9,
            )
        else:
            np.testing.assert_allclose(
                np.asarray(res.h2_null_list),
                np.asarray(ref[meth].h2_null_list), atol=1e-9,
            )
    set_budget(3)  # L + beta + SE
    res = bl.bulkscan(Y, G, K, output_effects=True)
    np.testing.assert_allclose(np.asarray(res.beta_mat),
                               np.asarray(ref_eff.beta_mat), atol=1e-9)
    np.testing.assert_allclose(np.asarray(res.beta_se_mat),
                               np.asarray(ref_eff.beta_se_mat), atol=1e-9)


def test_host_block_fallback_with_weights(small_data, monkeypatch):
    """Weights pre-scale ONCE before the block loop (same K
    decomposition for every block)."""
    G, Y, K = small_data
    rng = np.random.default_rng(2)
    w = rng.uniform(0.5, 2.0, G.shape[0])
    ref = bl.bulkscan(Y, G, K, weights=w, trait_chunk=Y.shape[1])
    n, p, m = G.shape[0], G.shape[1], Y.shape[1]
    monkeypatch.setattr(
        mem, "device_memory_budget",
        lambda device=None: _forcing_budget(n, p, m),
    )
    res = bl.bulkscan(Y, G, K, weights=w)
    np.testing.assert_allclose(np.asarray(res.L), np.asarray(ref.L),
                               atol=1e-9)


def test_streamed_auto_marker_block(small_data):
    """marker_block=None (new default) sizes itself and matches an
    explicit-block run."""
    G, Y, K = small_data
    a = bl.bulkscan_streamed(Y, G, K)  # auto block
    b = bl.bulkscan_streamed(Y, G, K, marker_block=8)
    np.testing.assert_allclose(np.asarray(a.L), np.asarray(b.L),
                               atol=1e-12)
    pa = bl.bulkscan_perms_streamed(Y, G, K, nperms=8, rndseed=1)
    pb = bl.bulkscan_perms_streamed(Y, G, K, nperms=8, rndseed=1,
                                    marker_block=8)
    np.testing.assert_allclose(np.asarray(pa.maxlods),
                               np.asarray(pb.maxlods), atol=1e-12)


def test_auto_marker_block_raises_when_trait_side_overflows():
    """Trait-side residents beyond the budget raise the actionable error
    (code-review r5) instead of returning a 1024 block that OOMs raw."""
    with pytest.raises(ValueError, match="trait-side"):
        mem.auto_marker_block(50_000, 500_000, budget=4 * 1024**3)


def test_sharded_auto_trait_chunk(monkeypatch):
    """bulkscan_sharded sizes its global trait chunk from the PER-DEVICE
    footprint (chunk/trait_shards columns of p/marker_shards markers per
    device); results equal the unchunked run."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from bulklmm_tpu.parallel import bulkscan_sharded, make_mesh

    rng = np.random.default_rng(31)
    n, p, m = 40, 64, 2048  # per-device: 32 markers x 512 traits
    G = rng.uniform(0, 1, (n, p))
    K = np.asarray(bl.calc_kinship(G))
    Y = rng.normal(size=(n, m))
    mesh = make_mesh(8, marker_shards=2)
    ref = bulkscan_sharded(Y, G, K, mesh=mesh, trait_chunk=m)
    # force a tiny per-device budget so auto chunking engages (room for
    # ~300 trait columns of temps -> a 256-column device chunk)
    base = mem.bulkscan_static_bytes(n, p // 2, -(-m // 4), 1, 8)
    per = mem.bulkscan_chunk_bytes(n, p // 2, 1, 10, 1, 8)
    monkeypatch.setattr(
        mem, "device_memory_budget",
        lambda device=None: int(base * mem._STATIC_HEADROOM) + per * 300,
    )
    assert mem.auto_trait_chunk(n, p // 2, -(-m // 4), itemsize=8) == 256
    res = bulkscan_sharded(Y, G, K, mesh=mesh)  # auto
    np.testing.assert_allclose(np.asarray(res.L), np.asarray(ref.L),
                               atol=1e-10)
    # overflow beyond chunking keeps today's unchunked behavior (no
    # host-block path on the mesh)
    monkeypatch.setattr(mem, "device_memory_budget", lambda device=None: 1)
    res2 = bulkscan_sharded(Y, G, K, mesh=mesh)
    np.testing.assert_allclose(np.asarray(res2.L), np.asarray(ref.L),
                               atol=1e-10)


def test_budget_from_device_stats():
    dev = SimpleNamespace(
        platform="gpu", memory_stats=lambda: {"bytes_limit": 60 * 10**9}
    )
    assert mem.device_memory_budget(dev) == int(
        60 * 10**9 * mem._USABLE_FRACTION
    )


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_statsless_accelerator_raises(stats):
    """An accelerator that reports no bytes_limit gets no guessed budget:
    the error names the explicit chunk arguments."""
    dev = SimpleNamespace(platform="gpu", memory_stats=lambda: stats)
    with pytest.raises(RuntimeError, match="trait_chunk.*marker_block"):
        mem.device_memory_budget(dev)


def test_cpu_budget_is_half_of_host_ram():
    import os

    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert mem.device_memory_budget(SimpleNamespace(platform="cpu")) \
        == ram // 2
