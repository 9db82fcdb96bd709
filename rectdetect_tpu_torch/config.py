"""Pipeline configuration of the PyTorch port.

A field-for-field copy of `rectdetect_tpu.config.PipelineConfig` (same
names, same defaults), so a configuration carries across unchanged
(`convert.config_from_jax`).  The port reads only the fields of the poly
path; the others describe stages or TPU block geometry that the port does
not run yet, and stay so that the two dataclasses remain equal.

Switches the port drops because they only pick between output-equal
formulations to save TPU op costs (the port always runs the large
capacity): `strings_small_factor`, `arc_small_factor`,
`walk_prefilter_factor`, `walk_tail_*`, and the `pin_*` branch pins.
The capacities that can change output are honoured: `sparse_factor`,
`strings_sparse_factor`, `arc_sparse_factor`, `cycle_sparse_factor` and
`ls_cap_for`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # ---- edge front-end -------------------------------------------------
    blur_radius: int = 2          # reference iirblur r=2 (oclrect.c:248)
    color_exact: bool = False     # LUT colour path (not ported yet)
    # ---- connected component labeling -----------------------------------
    ccl_passes: int = 8
    ccl_jumps: int = 2
    bridge_gap2: bool = False     # accuracy extension (not ported yet)
    strength_rescue_rounds: int = 0
    # ---- TPU block geometry (unused by the port) ------------------------
    ccl_bh: int = 0
    pieces_bh: int = 16
    merge_bh: int = 192
    boundary_bh: int = 256
    grad_bh: int = 32
    thin_bh: int = 16
    morph_bh: int = 128
    quant_bh: int = 64
    bids_bh: int = 64
    blblur_block: int = 128
    blblur_fuse: int = 0
    labelpl_passes: int = 12
    labelpl_jumps: int = 2
    labelmerge_passes: int = 8
    labelmerge_jumps: int = 8
    # ---- arc numbering --------------------------------------------------
    number_doublings: int = 14    # walk reach 2^14 px
    walk_tail_switch: int = 3     # dropped by the port
    walk_tail_factor: int = 4     # dropped by the port
    walk_prefilter_factor: int = 24   # dropped by the port
    walk_tail_rounds2: int = 4    # dropped by the port
    walk_tail_factor2: int = 16   # dropped by the port
    # ---- polyline stage -------------------------------------------------
    mkpl_iters: int = 16          # N, oclpolyline.c:188
    # 1 selects the mkpl subdivision kernel (ops/hopper_mkpl.py) on a CUDA
    # frame; 0 the plain subdivision on either device
    mkpl_pallas: int = 1
    min_n_index: int = 4          # MINNINDEX, oclpolyline.cl:21
    min_edge_len: float = 1.0     # MINEDGELEN, oclpolyline.cl:20
    ls_capacity: int = 16384
    # ---- rect pipeline --------------------------------------------------
    strength_scale: float = 10000.0  # oclimgutil.cl:648
    strength_weak: int = 500
    strength_strong: int = 2500
    blblur_size: int = 4
    blblur_iters: int = 10
    quantize_levels: int = 24
    despeckle2_thre: int = 16
    minerror_rect: float = 4.0
    size_thre_rect: int = 20
    # ---- poly tool defaults ---------------------------------------------
    minerror_poly: float = 1.0    # poly.cpp:123
    size_thre_poly: int = 20      # poly.cpp:123
    strength_poly: int = 500      # poly.cpp:120
    # ---- sparse labeling capacities -------------------------------------
    sparse_factor: int = 3
    boundary_sparse_factor: int = 3
    rect_strings_small: int = 0
    rect_strength_dense: int = 1
    weak_ccl_round_cap: int = 48
    boundary_ccl_round_cap: int = 128
    boundary_tpu_sparse: bool = False
    boundary_comp: int = 1
    strings_sparse_factor: int = 4    # strings slot list: H*W // 4
    strings_small_factor: int = 10    # dropped by the port
    cycle_sparse_factor: int = 24     # cycle re-walk sub-list: H*W // 24
    arc_sparse_factor: int = 12       # arc slot list: H*W // 12
    arc_small_factor: int = 192       # dropped by the port
    region_run_factor: int = 16
    # ---- hypothesis / pose ----------------------------------------------
    probe_n: int = 3
    probe_dist: int = 2
    members_by_length: int = 1
    ls_min_len_polyline: float = 32.0
    short_ls_ratio: float = 0.05
    max_groups: int = 192
    max_group_segs: int = 48
    hull_max_vertices: int = 24
    hyp_pallas: int = 1
    hyp_gb: int = 8
    cg_iters: int = 12
    cg_line_search_iters: int = 10
    accept_value: float = 0.05
    aspect_limit: float = 12.0
    offset_ratio_limit: float = 100.0
    # ---- branch pinning (dropped by the port) ---------------------------
    pin_strings_branch: int = 0
    pin_arc_branch: int = 0
    pin_walk_tail: int = 0
    pin_region_runs: int = 0
    pin_walk_prefilter: int = 0
    pin_cycle_walk: int = 0
    pin_rect_strings: int = 0

    def ls_cap_for(self, iw: int, ih: int) -> int:
        """Arena capacity: min(config cap, reference's byte budget iw*ih*4*4/56)."""
        return int(min(self.ls_capacity, max(256, iw * ih * 16 // 56)))


DEFAULT_CONFIG = PipelineConfig()
