"""bulklmm_tpu: accelerator linear-mixed-model genome-scan engine.

A from-scratch JAX/XLA framework with the full capability surface of
BulkLMM.jl (the reference implementation this project re-designs for
accelerators):
kinship computation, kinship eigendecomposition + trait/genotype rotation,
REML/ML variance-component estimation (vmapped grid + Brent), single-trait
scans under null and per-marker ("alt") VC assumptions with covariates,
heteroskedastic weights and prior regularization, eigen-rotated permutation
testing with family-wise LOD thresholds, and batched multi-trait bulk scans
(null-grid / null-exact / alt-grid) whose throughput core is a set of fused
correlation GEMMs. Multi-device scaling lives in ``bulklmm_tpu.parallel``.

Public API mapping to the reference exports (reference src/BulkLMM.jl:9-47):

  scan, bulkscan, bulkscan_null, bulkscan_null_grid, bulkscan_alt_grid,
  scan_perms_lite, calc_kinship (calcKinship), wls, wls_multivar,
  transform_rotation, get_thresholds, getLL, profile_LL,
  p2lod / lod2p / lod2log10p, read_bxd_pheno (readBXDpheno),
  read_geno_prob_exclude_complements (readGenoProb_ExcludeComplements).
"""

from . import io, parallel
from .analysis import (
    ProfileLL,
    Thresholds,
    bh_adjust,
    getLL,
    get_thresholds,
    get_thresholds_bulk,
    lod_fdr,
    profile_LL,
)
from .io import (
    read_bxd_geno,
    read_bxd_pheno,
    read_geno_prob,
    read_geno_prob_exclude_complements,
    read_gmap,
    read_helium_matrix,
    read_phenocovar,
    write_to_file,
)
from .models import (
    BulkPermResult,
    BulkScanResult,
    ScanResult,
    bulkscan,
    bulkscan_alt_grid,
    bulkscan_loco,
    bulkscan_null,
    bulkscan_null_grid,
    bulkscan_perms,
    bulkscan_perms_loco,
    bulkscan_perms_streamed,
    bulkscan_streamed,
    loco_kinship,
    scan,
    scan_loco,
    scan_perms_lite,
)
from .ops import (
    KinshipDecomposition,
    LowRankKinship,
    calc_kinship,
    decompose_kinship,
    fit_lmm,
    kinship_lowrank,
    kinship_lowrank_exact,
    kinship_lowrank_from_geno,
    gridbrent,
    lod2log10p,
    lod2p,
    make_weights,
    p2lod,
    r2lod,
    resid,
    rss,
    transform_permute,
    transform_reweight,
    transform_rotation,
    wls,
    wls_multivar,
)
from .utils import DEFAULT_PRECISION, PrecisionConfig, enable_x64

__version__ = "0.3.0"

__all__ = [
    "io",
    "parallel",
    "read_bxd_geno",
    "read_bxd_pheno",
    "read_geno_prob",
    "read_geno_prob_exclude_complements",
    "read_gmap",
    "read_helium_matrix",
    "read_phenocovar",
    "write_to_file",
    "ProfileLL",
    "Thresholds",
    "bh_adjust",
    "lod_fdr",
    "getLL",
    "get_thresholds",
    "get_thresholds_bulk",
    "profile_LL",
    "BulkScanResult",
    "BulkPermResult",
    "ScanResult",
    "bulkscan",
    "bulkscan_alt_grid",
    "bulkscan_null",
    "bulkscan_null_grid",
    "bulkscan_streamed",
    "bulkscan_loco",
    "bulkscan_perms",
    "bulkscan_perms_loco",
    "bulkscan_perms_streamed",
    "loco_kinship",
    "scan_loco",
    "scan",
    "scan_perms_lite",
    "calc_kinship",
    "LowRankKinship",
    "kinship_lowrank",
    "kinship_lowrank_exact",
    "kinship_lowrank_from_geno",
    "KinshipDecomposition",
    "decompose_kinship",
    "fit_lmm",
    "gridbrent",
    "lod2log10p",
    "lod2p",
    "make_weights",
    "p2lod",
    "r2lod",
    "resid",
    "rss",
    "transform_permute",
    "transform_reweight",
    "transform_rotation",
    "wls",
    "wls_multivar",
    "DEFAULT_PRECISION",
    "PrecisionConfig",
    "enable_x64",
    "__version__",
]
