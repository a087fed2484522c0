"""Device-memory-aware auto sizing for the scan engines.

The reference tunes CPU cache/thread blocking by hand (``nb``/``nt_blas``,
reference src/bulkscan.jl:241-252) and otherwise relies on the OS paging;
an accelerator has a hard device-memory wall instead. This module makes
OOM-free the DEFAULT: when ``trait_chunk``/``marker_block`` are not given,
the engines size them from the device's memory budget and a documented
footprint model — the same approach :func:`ops.bulkperm.perm_chunk_cap`
takes for the permutation chunk width.

The footprint model is deliberately simple and conservative (a handful of
linear terms with safety multipliers measured from HLO live-set
inspection at BXD/biobank scale); its job is to pick a chunk that cannot
OOM, not to predict allocator behavior exactly. All sizes in bytes.
"""

from __future__ import annotations

import os

import jax

#: fraction of the device's ``bytes_limit`` treated as usable, leaving
#: room for runtime reserves, fragmentation and fusion temporaries that
#: the footprint model does not count. Not yet measured on the H100:
#: calibrating it against ``peak_bytes_in_use`` is an open item.
_USABLE_FRACTION = 0.82

#: transient-copy headroom on the chunk-independent residents: XLA
#: materializes short-lived copies of the largest buffers around fusions
#: (observed: the biobank (p, m) result's reduce fusion)
_STATIC_HEADROOM = 1.1

#: live-copy multiplier for (p, chunk)-scale kernel temporaries: the
#: per-trait-weight correlation kernel holds the (c+2) partial GEMMs, the
#: r2 -> LOD combine, and XLA remat copies — ~6 live (p, mc) buffers
#: observed at BXD scale; 8 adds headroom (alt-grid's running max + argmax
#: carries are its largest consumer and stay under this)
_P_CHUNK_COPIES = 8

#: live-copy multiplier for (n, chunk)-scale temporaries (weighted trait
#: copies per covariate column, grid likelihood intermediates)
_N_CHUNK_COPIES = 12


def device_memory_budget(device=None) -> int:
    """Usable device memory in bytes.

    An accelerator's budget is ``device.memory_stats()['bytes_limit']``
    times the usable fraction; one that reports no limit raises, since
    any guess could OOM — pass ``trait_chunk`` / ``marker_block``
    explicitly there. CPU "device" memory is host RAM — use half of it
    (the host side of a streamed run holds the other copy).
    """
    if device is None:
        device = jax.devices()[0]
    platform = getattr(device, "platform", "cpu")
    if platform != "cpu":
        stats = device.memory_stats()
        if not stats or "bytes_limit" not in stats:
            raise RuntimeError(
                f"the {platform} device {device} reports no memory "
                "bytes_limit, so the engines cannot size their chunks; pass "
                "trait_chunk= (bulkscan, bulkscan_perms) or marker_block= "
                "(bulkscan_streamed) explicitly"
            )
        return int(stats["bytes_limit"] * _USABLE_FRACTION)
    try:  # CPU: half of host RAM
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return int(total // 2)
    except (ValueError, OSError, AttributeError):
        return 8 * 1024**3


def bulkscan_static_bytes(n: int, p: int, m: int, c: int, itemsize: int,
                          *, n_outputs: int = 1) -> int:
    """Device-resident bytes independent of the trait chunk: the marker
    panel + its rotation (2 x (n, p)), eigenvectors (n, n), traits + their
    rotation (2 x (n, m)), covariates, and ``n_outputs`` (p, m) results
    (L; +2 with effects; +1 with device p-values)."""
    return itemsize * (
        2 * n * p + n * n + 2 * n * m + 2 * n * c + n_outputs * p * m
    )


def bulkscan_chunk_bytes(n: int, p: int, mc: int, grid: int, c: int,
                         itemsize: int) -> int:
    """Modeled live temporaries for one (trait chunk) kernel step."""
    return itemsize * mc * (
        _P_CHUNK_COPIES * p + _N_CHUNK_COPIES * n * max(1, (c + 2) // 2)
        + grid
    )


def auto_trait_chunk(n: int, p: int, m: int, *, grid: int = 10, c: int = 1,
                     itemsize: int = 4, n_outputs: int = 1,
                     budget: int | None = None) -> int | None:
    """Trait-chunk width for the in-memory bulkscan engines.

    Returns ``None`` when the whole problem fits unchunked (small-m fast
    path — one kernel dispatch, today's behavior), else the largest
    multiple of 256 whose modeled footprint stays inside the budget
    (minimum 256: narrower chunks leave the device's GEMM units idle).

    Raises with a streaming recipe when even the chunk-independent
    residents overflow — no chunk size can save a (p, m) result that
    doesn't fit, but ``bulkscan_streamed`` (host L) / host trait blocks
    can (and :func:`auto_host_block` sizes the latter).
    """
    if budget is None:
        budget = device_memory_budget()
    static = int(
        bulkscan_static_bytes(n, p, m, c, itemsize, n_outputs=n_outputs)
        * _STATIC_HEADROOM
    )
    if static + bulkscan_chunk_bytes(n, p, m, grid, c, itemsize) <= budget:
        return None
    room = budget - static
    per_trait = bulkscan_chunk_bytes(n, p, 1, grid, c, itemsize)
    mc = int(room // per_trait)
    if mc < 256:
        raise ValueError(
            f"bulkscan at n={n}, p={p}, m={m} needs "
            f"~{static / 1e9:.1f} GB of chunk-independent device "
            f"residents against a ~{budget / 1e9:.1f} GB budget — no "
            "trait_chunk fits. Use bulkscan_streamed (host-resident "
            "panel + memmap output), host trait blocks "
            "(utils/memory.py::auto_host_block), or a device mesh "
            "(bulklmm_tpu.parallel)."
        )
    return min((mc // 256) * 256, m)


def auto_host_block(n: int, p: int, m: int, *, grid: int = 10, c: int = 1,
                    itemsize: int = 4, n_outputs: int = 1,
                    budget: int | None = None) -> int:
    """Trait width per sequential device call when the (p, m) result must
    live on the HOST: the device holds only one (p, mh) output slab at a
    time."""
    if budget is None:
        budget = device_memory_budget()
    base = int(
        (bulkscan_static_bytes(n, p, 0, c, itemsize)
         + 2 * n * m * itemsize) * _STATIC_HEADROOM
    )
    per_trait = (
        bulkscan_chunk_bytes(n, p, 1, grid, c, itemsize)
        + int(n_outputs * p * itemsize * _STATIC_HEADROOM)
    )
    mh = int((budget - base) // per_trait)
    if mh < 256:
        raise ValueError(
            f"even one 256-trait host block overflows the "
            f"~{budget / 1e9:.1f} GB device budget at n={n}, p={p} — "
            "stream markers instead (bulkscan_streamed)."
        )
    return min((mh // 256) * 256, m)


def auto_marker_block(n: int, m: int, *, itemsize: int = 4,
                      n_outputs: int = 1, budget: int | None = None,
                      default: int = 32_768) -> int:
    """Marker-block width for the streamed engines: the device holds the
    trait-side residents plus, per block, the uploaded + rotated block
    (2 x (n, block)), ``n_outputs`` (block, m) output slabs, and kernel
    temporaries (~4 more (block, m)-scale live copies at the double-
    buffered pipeline's peak)."""
    if budget is None:
        budget = device_memory_budget()
    trait_side = itemsize * (n * n + 4 * n * m)
    per_marker = itemsize * (2 * 2 * n + (n_outputs + 4) * m)
    if budget - trait_side < per_marker * 1024:
        # even the marker-independent trait-side residents (plus one
        # minimal block) overflow: raise the same actionable error class
        # as auto_trait_chunk instead of letting the allocator OOM raw
        raise ValueError(
            f"bulkscan_streamed trait-side residents at n={n}, m={m} "
            f"need ~{trait_side / 1e9:.1f} GB against a "
            f"~{budget / 1e9:.1f} GB budget — no marker block fits. "
            "Chunk traits across calls (bulkscan host trait blocks, "
            "utils/memory.py::auto_host_block) or shard the traits axis "
            "over a device mesh (bulklmm_tpu.parallel)."
        )
    blk = int((budget - trait_side) // per_marker)
    blk = max(1024, min(blk, 1 << 20))
    # keep the familiar default when it fits — block size barely affects
    # throughput above ~16k, and stable shapes keep compile caches warm
    return default if blk >= default else (blk // 1024) * 1024
