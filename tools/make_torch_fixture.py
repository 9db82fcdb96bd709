"""Write the 720p reference fixtures that chip_smoke.py holds the PyTorch
port against, from the JAX package run on the CPU on
bench.synth_frame(720, 1280, seed=0).

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py [poly|rect|hyp|frame] [out.npz]

Without arguments it writes all of them.

`poly`: the poly path with PipelineConfig(mkpl_pallas=0), into
tests/data/poly_720p_synth.npz, holding
  * packed0, edge_bin, strings and lsid: SHA-256 of their little-endian
    int32 bytes; edge_bin also bit-packed (np.packbits, row-major), so a
    mismatch can be counted pixel by pixel;
  * the strings map's foreground count;
  * the live segments (polyid != 0): integer fields and float endpoints;
  * count, and a JSON `meta` string saying how the reference was made.

The JAX CPU path labels the weak edges with a fixed-pass CCL.  If those
labels differ from ccl.label_components_converged on this frame, the
fixture is built from the converged labels instead (edge_frontend ->
label_components_converged -> calc_strength / filter_strength ->
polyline_execute) and `meta` says so.

`rect`: the rect path's edge labeling and region smoothing with the
default PipelineConfig (pipeline.rect.weak_strong_labels, then
regions.blblur over the weak edges and regions.quantize_despeckle), into
tests/data/rect_regions_720p_synth.npz, holding the SHA-256 of weak_lbl,
strong_lbl, blurred and despeck, the bit-packed weak_lbl > 0 and
strong_lbl > 0 maps and their counts, and `meta`.  The weak labels come
from ccl.label_components_converged where the fixed-pass labels differ
from it, as above.

`hyp`: the rect path from the frame to the hypotheses with the default
PipelineConfig (rect_tail's stages up to pipeline.rect._hypotheses), into
tests/data/rect_hyp_720p_synth.npz, holding the SHA-256 of the merge mask,
the region labels (seg), the boundary labels and lsid, the hypotheses
(segs, valid, status), their counts, and `meta`.  The weak/strong maps
come from converged labels where the fixed-pass ones change them (as
`rect`); the boundary labels are label_components_converged of the marked
boundary where the JAX CPU path's fixed-pass labels differ from it, with
the pixels beyond the boundary compaction's capacity dropped to -1, as
the JAX package's TPU path drops them (pallas_ccl._label_sparse).

`frame`: the rest of rect_frame, from the hypotheses to the RectResult,
with the default PipelineConfig and tan_aov = tan(36 degrees): the `hyp`
fixture's segs, valid and status through rect_geometry_tail's
quad.reduce_groups, pose.pose_estimate, looks_like_a_screen and the
result's sanitising, jitted, into tests/data/rect_frame_720p_synth.npz,
holding the RectResult (c2, c3, value, status, valid), the reduction's
corners and ok, and `meta`, which also says whether the interpreted
pallas_hyp.reduce_groups_pallas agrees with reduce_groups on ok and on
the corners to 1e-3.  It also writes tests/data/rect_frame_small.npz: the
two-quad 192x144 scene of tests/test_rect_pipeline.py (draw_scene) through
the `hyp` chain and the same tail, with the frame itself and its
hypotheses, so that a test can run the whole rect_frame on it without
compiling the JAX rect_frame.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

INT_FIELDS = ("start_index", "end_index", "left_ptr", "right_ptr",
              "start_count", "end_count", "polyid", "npix", "level")
FLOAT_FIELDS = ("sx", "sy", "ex", "ey")


def digest(a) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(a), dtype="<i4").tobytes()).hexdigest()


def bits(a) -> np.ndarray:
    return np.packbits(np.asarray(a).reshape(-1).astype(np.uint8))


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    makers = {"poly": make_poly, "rect": make_rect, "hyp": make_hyp,
              "frame": make_frame}
    which = argv[1:2] or list(makers)
    if which[0] not in makers:
        sys.exit(f"unknown fixture {which[0]!r}: one of {sorted(makers)}")
    out = argv[2] if len(argv) > 2 else None
    for name in which:
        makers[name](out or os.path.join(ROOT, "tests", "data",
                                         FIXTURES[name]))
    return 0


FIXTURES = {"poly": "poly_720p_synth.npz",
            "rect": "rect_regions_720p_synth.npz",
            "hyp": "rect_hyp_720p_synth.npz",
            "frame": "rect_frame_720p_synth.npz",
            "frame_small": "rect_frame_small.npz"}


def make_poly(out: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bench import synth_frame
    from rectdetect_tpu.config import PipelineConfig
    from rectdetect_tpu.ops import ccl, morphology, polyline
    from rectdetect_tpu.pipeline.frontend import edge_frontend
    from rectdetect_tpu.pipeline.poly import poly_frame

    h, w = 720, 1280
    cfg = PipelineConfig(mkpl_pallas=0)
    minerror, size_thre, strength = 1.0, 20, 500
    bgr = jnp.asarray(synth_frame(h, w, seed=0))

    fe = jax.jit(lambda b: edge_frontend(b, cfg))(bgr)
    fixed = jax.jit(lambda e: ccl.label_components_adaptive(
        e, 0, cfg.ccl_passes, cfg.ccl_jumps,
        small_cap=max(4096, h * w // 8), big_cap=max(4096, h * w // 2),
        round_cap=cfg.weak_ccl_round_cap, pieces_ok=True))(fe.edge_bin)
    conv = jax.jit(lambda e: ccl.label_components_converged(e, 0))(
        fe.edge_bin)
    n_label_diff = int((np.asarray(fixed) != np.asarray(conv)).sum())

    def filtered_edge(lbl):
        st = ccl.calc_strength(fe.edge_thin, lbl, cfg.strength_scale)
        return (ccl.filter_strength(lbl, st, strength) > 0).astype(jnp.int32)

    edge = jax.jit(filtered_edge)(conv)
    strings = jax.jit(lambda e: morphology.strings_chain(e, "poly_branch"))(
        edge)
    if n_label_diff == 0:
        how = ("pipeline.poly.poly_frame; its fixed-pass weak labels equal "
               "label_components_converged on this frame")
        arena, lsid = poly_frame(bgr, cfg, minerror, size_thre, strength)
    else:
        how = (f"converged labels: the fixed-pass weak labels differ from "
               f"label_components_converged at {n_label_diff} pixels, so "
               f"edge_frontend -> label_components_converged -> "
               f"calc_strength/filter_strength -> polyline_execute")
        arena, lsid = jax.jit(lambda e: polyline.polyline_execute(
            e, minerror, size_thre, cfg.ls_cap_for(w, h), cfg))(edge)

    a = {k: np.asarray(v) for k, v in arena._asdict().items()}
    live = np.nonzero(a["polyid"][:int(a["count"]) + 1])[0].astype(np.int32)
    edge_bin = np.asarray(fe.edge_bin)
    meta = {
        "frame": "bench.synth_frame(720, 1280, seed=0)",
        "config": "PipelineConfig(mkpl_pallas=0)",
        "args": {"minerror": minerror, "size_thre": size_thre,
                 "strength": strength},
        "reference": how,
        "jax": jax.__version__,
        "backend": jax.default_backend(),
    }
    data = {
        "meta": np.asarray(json.dumps(meta)),
        "shape": np.asarray([h, w], np.int32),
        "packed0_sha256": np.asarray(digest(fe.packed0)),
        "edge_bin_sha256": np.asarray(digest(edge_bin)),
        "edge_bin_bits": bits(edge_bin),
        "strings_sha256": np.asarray(digest(strings)),
        "strings_count": np.asarray(int((np.asarray(strings) != 0).sum())),
        "lsid_sha256": np.asarray(digest(lsid)),
        "count": np.asarray(int(a["count"]), np.int32),
        "seg_id": live,
    }
    for f in INT_FIELDS:
        data[f] = a[f][live].astype(np.int32)
    for f in FLOAT_FIELDS:
        data[f] = a[f][live].astype(np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **data)
    print(f"{out}: {len(live)} live segments, count {int(a['count'])}, "
          f"{os.path.getsize(out)} bytes; {how}")


def make_rect(out: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bench import synth_frame
    from rectdetect_tpu.config import PipelineConfig
    from rectdetect_tpu.ops import ccl, morphology, regions
    from rectdetect_tpu.pipeline.frontend import edge_frontend
    from rectdetect_tpu.pipeline.rect import weak_strong_labels

    h, w = 720, 1280
    cfg = PipelineConfig()
    sp = max(4096, h * w // cfg.sparse_factor)
    bgr = jnp.asarray(synth_frame(h, w, seed=0))
    fe = jax.jit(lambda b: edge_frontend(b, cfg))(bgr)
    weak, strong, _, _ = jax.jit(lambda eb, et: weak_strong_labels(
        eb, et, cfg))(fe.edge_bin, fe.edge_thin)

    def converged_pair(eb, et):
        s = morphology.strings_chain(eb, "rect", bridge2=cfg.bridge_gap2,
                                     bh=cfg.morph_bh)
        lbl = ccl.label_components_converged(s, 0)
        return ccl.strength_filter_pair_dense(
            et, lbl, sp, cfg.strength_weak, cfg.strength_strong,
            cfg.strength_scale)

    cweak, cstrong = jax.jit(converged_pair)(fe.edge_bin, fe.edge_thin)
    n_diff = int((np.asarray(weak) != np.asarray(cweak)).sum() +
                 (np.asarray(strong) != np.asarray(cstrong)).sum())
    if n_diff == 0:
        how = ("pipeline.rect.weak_strong_labels; its fixed-pass labels "
               "give the same maps as label_components_converged")
    else:
        how = (f"converged labels: the fixed-pass labels change the weak/"
               f"strong maps at {n_diff} pixels, so strings_chain('rect') -> "
               f"label_components_converged -> strength_filter_pair_dense")
        weak, strong = cweak, cstrong
    blurred = jax.jit(lambda p, wk: regions.blblur(
        p, (wk > 0).astype(jnp.int32), cfg.blblur_iters))(fe.packed0, weak)
    n = cfg.quantize_levels
    despeck = jax.jit(lambda b, e: regions.quantize_despeckle(
        b, e, n, n, n))(blurred, fe.edge_thin)
    meta = {
        "frame": "bench.synth_frame(720, 1280, seed=0)",
        "config": "PipelineConfig()",
        "stages": "weak_strong_labels -> blblur(weak > 0, blblur_iters) -> "
                  "quantize_despeckle(quantize_levels)",
        "reference": how,
        "jax": jax.__version__,
        "backend": jax.default_backend(),
    }
    data = {
        "meta": np.asarray(json.dumps(meta)),
        "shape": np.asarray([h, w], np.int32),
        "packed0_sha256": np.asarray(digest(fe.packed0)),
        "weak_lbl_sha256": np.asarray(digest(weak)),
        "strong_lbl_sha256": np.asarray(digest(strong)),
        "blurred_sha256": np.asarray(digest(blurred)),
        "despeck_sha256": np.asarray(digest(despeck)),
        "weak_bits": bits(np.asarray(weak) > 0),
        "strong_bits": bits(np.asarray(strong) > 0),
        "weak_count": np.asarray(int((np.asarray(weak) > 0).sum())),
        "strong_count": np.asarray(int((np.asarray(strong) > 0).sum())),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **data)
    print(f"{out}: weak {int(data['weak_count'])} px, strong "
          f"{int(data['strong_count'])} px, {os.path.getsize(out)} bytes; "
          f"{how}")


def _hyp_chain(bgr_np, cfg):
    """The rect path from a BGR frame to the hypotheses on the JAX package
    (rect_tail's stages up to pipeline.rect._hypotheses), with the
    converged labels where the JAX CPU path's fixed-pass ones differ.
    Returns a dict of the stage outputs and `reference`, the sentence that
    says which labels were used."""
    import jax
    import jax.numpy as jnp

    from rectdetect_tpu.ops import ccl, morphology, polyline, regions
    from rectdetect_tpu.ops.compact import compact_mask
    from rectdetect_tpu.pipeline.frontend import edge_frontend
    from rectdetect_tpu.pipeline.rect import _hypotheses, weak_strong_labels

    h, w = bgr_np.shape[:2]
    sp = max(4096, h * w // cfg.sparse_factor)
    spb = max(4096, h * w // cfg.boundary_sparse_factor)
    bgr = jnp.asarray(bgr_np)
    fe = jax.jit(lambda b: edge_frontend(b, cfg))(bgr)
    weak, strong, _, _ = jax.jit(lambda eb, et: weak_strong_labels(
        eb, et, cfg))(fe.edge_bin, fe.edge_thin)

    def converged_pair(eb, et):
        s = morphology.strings_chain(eb, "rect", bridge2=cfg.bridge_gap2,
                                     bh=cfg.morph_bh)
        lbl = ccl.label_components_converged(s, 0)
        return ccl.strength_filter_pair_dense(
            et, lbl, sp, cfg.strength_weak, cfg.strength_strong,
            cfg.strength_scale)

    cweak, cstrong = jax.jit(converged_pair)(fe.edge_bin, fe.edge_thin)
    n_edge = int(((np.asarray(weak) > 0) != (np.asarray(cweak) > 0)).sum() +
                 ((np.asarray(strong) > 0) !=
                  (np.asarray(cstrong) > 0)).sum())
    if n_edge:
        weak, strong = cweak, cstrong
    n = cfg.quantize_levels

    def regions_part(p0, et, wk, st):
        blurred = regions.blblur(p0, (wk > 0).astype(jnp.int32),
                                 cfg.blblur_iters)
        despeck = regions.quantize_despeckle(blurred, et, n, n, n)
        mask = regions.junction_merge_mask(st)
        seg = regions.label_merge(despeck, mask, st, cfg.labelmerge_passes,
                                  cfg.labelmerge_jumps)
        seg = regions.sizes_despeckle2(seg, cfg.despeckle2_thre,
                                       cfg.region_run_factor)
        bmark = regions.mark_boundary(seg)
        bcomp = compact_mask((bmark != -1).reshape(-1), spb)
        fixed = ccl.label_components_adaptive(
            bmark, -1, cfg.ccl_passes, cfg.ccl_jumps,
            small_cap=max(4096, h * w // 16), big_cap=spb,
            round_cap=cfg.boundary_ccl_round_cap, comp=bcomp)
        conv = ccl.label_components_converged(bmark, -1)
        kept = (bcomp.slot_of[:h * w] < spb).reshape(h, w)
        return mask, seg, fixed, jnp.where(kept, conv, -1), bcomp

    mask, seg, fixed, boundary, bcomp = jax.jit(regions_part)(
        fe.packed0, fe.edge_thin, weak, strong)
    n_bnd = int((np.asarray(fixed) != np.asarray(boundary)).sum())
    if n_bnd == 0:
        boundary = fixed
    arena, lsid, comp = jax.jit(lambda st: polyline.polyline_execute(
        (st > 0).astype(jnp.int32), cfg.minerror_rect, cfg.size_thre_rect,
        cfg.ls_cap_for(w, h), cfg, return_comp=True))(strong)
    segs, valid, status = _hypotheses(arena, lsid, boundary, w, h, cfg,
                                      comp=comp, bcomp=bcomp)
    edges = ("weak/strong maps from the fixed-pass labels, which give the "
             "same > 0 maps as label_components_converged" if n_edge == 0
             else f"weak/strong maps from label_components_converged: the "
                  f"fixed-pass labels change them at {n_edge} pixels")
    bnd = ("boundary labels from the JAX CPU path's fixed-pass CCL, equal "
           "to label_components_converged" if n_bnd == 0 else
           f"boundary labels from label_components_converged (the "
           f"fixed-pass CCL differs at {n_bnd} pixels)")
    n_fg = int((np.asarray(regions.mark_boundary(seg)) != -1).sum())
    return {"packed0": fe.packed0, "mask": mask, "seg": seg,
            "boundary": boundary, "lsid": lsid,
            "segs": np.asarray(segs).astype(np.float32),
            "valid": np.asarray(valid),
            "status": np.asarray(status).astype(np.int32),
            "boundary_count": n_fg,
            "reference": f"{edges}; {bnd}; {n_fg} boundary pixels against "
                         f"a compaction capacity of {spb}"}


HYP_STAGES = ("weak_strong_labels -> blblur -> quantize_despeckle -> "
              "junction_merge_mask -> label_merge -> sizes_despeckle2 "
              "-> mark_boundary -> boundary CCL -> polyline_execute"
              "(strong > 0, return_comp) -> _hypotheses")


def make_hyp(out: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")

    from bench import synth_frame
    from rectdetect_tpu.config import PipelineConfig

    h, w = 720, 1280
    cfg = PipelineConfig()
    c = _hyp_chain(synth_frame(h, w, seed=0), cfg)
    valid = c["valid"]
    meta = {
        "frame": "bench.synth_frame(720, 1280, seed=0)",
        "config": "PipelineConfig()",
        "stages": HYP_STAGES,
        "reference": c["reference"],
        "jax": jax.__version__,
        "backend": jax.default_backend(),
    }
    data = {
        "meta": np.asarray(json.dumps(meta)),
        "shape": np.asarray([h, w], np.int32),
        "packed0_sha256": np.asarray(digest(c["packed0"])),
        "mask_sha256": np.asarray(digest(c["mask"])),
        "seg_sha256": np.asarray(digest(c["seg"])),
        "boundary_sha256": np.asarray(digest(c["boundary"])),
        "lsid_sha256": np.asarray(digest(c["lsid"])),
        "segs": c["segs"],
        "valid": valid,
        "status": c["status"],
        "mask_count": np.asarray(int(np.asarray(c["mask"]).sum())),
        "boundary_count": np.asarray(c["boundary_count"]),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **data)
    print(f"{out}: {int(valid.sum())} valid members in "
          f"{int(valid.any(1).sum())} groups, {os.path.getsize(out)} bytes; "
          f"{meta['reference']}")


# the rect tools' horizontal angle of view, 72 degrees (rect.cpp:84)
TAN_AOV = math.tan(math.radians(72.0) / 2)
# tests/test_rect_pipeline.py::test_rect_frame_detects_quads's scene
SMALL_QUADS = [[(20, 20), (84, 26), (78, 74), (26, 66)],
               [(110, 40), (170, 50), (160, 120), (116, 106)]]


def _geometry_tail(segs, valid, status, iw, ih, cfg):
    """pipeline.rect.rect_geometry_tail after _hypotheses, jitted as there
    (tan_aov a float32 argument): quad.reduce_groups, pose.pose_estimate,
    looks_like_a_screen and the result's sanitising.  Returns numpy
    arrays: corners, ok (the reduction), c2, c3, value, status, valid."""
    import jax
    import jax.numpy as jnp

    from rectdetect_tpu.geometry import pose, quad

    @jax.jit
    def tail(s, v, st, tan_aov):
        corners, ok = quad.reduce_groups(s, v, cfg.hull_max_vertices)
        c2, c3, val = pose.pose_estimate(corners, iw, ih, tan_aov,
                                         cfg.cg_iters,
                                         cfg.cg_line_search_iters)
        screen = pose.looks_like_a_screen(c2, c3, val, cfg.accept_value,
                                          cfg.aspect_limit,
                                          cfg.offset_ratio_limit)
        st = st | jnp.where(screen, 1, 0)
        okv = ok & jnp.isfinite(val)
        val = jnp.where(okv, val, jnp.inf)
        c2 = jnp.where(okv[:, None, None], jnp.nan_to_num(c2), 0.0)
        c3 = jnp.where(okv[:, None, None], jnp.nan_to_num(c3), 0.0)
        return corners, ok, c2, c3, val, st, okv

    out = tail(jnp.asarray(segs), jnp.asarray(valid), jnp.asarray(status),
               TAN_AOV)
    return dict(zip(("corners", "ok", "c2", "c3", "value", "status",
                     "valid"), map(np.asarray, out)))


def _frame_data(bgr_desc, res, meta_extra):
    meta = {"frame": bgr_desc, "config": "PipelineConfig()",
            "tan_aov": "tan(radians(72) / 2)"}
    meta.update(meta_extra)
    return meta, {
        "c2": res["c2"].astype(np.float32),
        "c3": res["c3"].astype(np.float32),
        "value": res["value"].astype(np.float32),
        "status": res["status"].astype(np.int32),
        "valid": res["valid"].astype(bool),
        "corners": res["corners"].astype(np.float32),
        "ok": res["ok"].astype(bool),
    }


def make_frame(out: str) -> None:
    """Both rect_frame fixtures: `out` (720p) and rect_frame_small.npz in
    the same directory."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from rectdetect_tpu.config import PipelineConfig
    from rectdetect_tpu.ops.pallas_hyp import reduce_groups_pallas

    cfg = PipelineConfig()
    hx = np.load(os.path.join(ROOT, "tests", "data", FIXTURES["hyp"]))
    h, w = (int(v) for v in hx["shape"])
    res = _geometry_tail(hx["segs"], hx["valid"], hx["status"], w, h, cfg)
    pc, pok = reduce_groups_pallas(jnp.asarray(hx["segs"]),
                                   jnp.asarray(hx["valid"]),
                                   cfg.hull_max_vertices, gb=cfg.hyp_gb,
                                   interpret=True)
    pc, pok = np.asarray(pc), np.asarray(pok)
    both = pok & res["ok"]
    pallas = {"ok_equal": bool((pok == res["ok"]).all()),
              "corners_max_diff_where_ok": float(
                  np.abs(pc[both] - res["corners"][both]).max()
                  if both.any() else 0.0),
              "ok_groups": int(pok.sum())}
    pallas["corners_within_1e-3"] = \
        pallas["corners_max_diff_where_ok"] <= 1e-3
    meta, data = _frame_data(
        "bench.synth_frame(720, 1280, seed=0)", res,
        {"reference": "the hypotheses of " + FIXTURES["hyp"] + " (segs, "
                      "valid, status) through rect_geometry_tail's "
                      "quad.reduce_groups -> pose.pose_estimate -> "
                      "looks_like_a_screen -> sanitising, jitted",
         "pallas_interpret": pallas,
         "jax": jax.__version__, "backend": jax.default_backend()})
    data["meta"] = np.asarray(json.dumps(meta))
    data["shape"] = np.asarray([h, w], np.int32)
    np.savez_compressed(out, **data)
    print(f"{out}: {int(data['valid'].sum())} valid, "
          f"{int((data['status'] & 1).sum())} screens, "
          f"{os.path.getsize(out)} bytes; pallas {pallas}")

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_rect_pipeline import draw_scene
    bgr = np.asarray(draw_scene(SMALL_QUADS))
    sh, sw = bgr.shape[:2]
    c = _hyp_chain(bgr, cfg)
    res = _geometry_tail(c["segs"], c["valid"], c["status"], sw, sh, cfg)
    meta, data = _frame_data(
        "tests/test_rect_pipeline.py draw_scene(two quads of "
        "test_rect_frame_detects_quads), 192x144", res,
        {"stages": HYP_STAGES + " -> quad.reduce_groups -> "
                   "pose.pose_estimate -> looks_like_a_screen -> sanitising",
         "reference": c["reference"], "quads": SMALL_QUADS,
         "jax": jax.__version__, "backend": jax.default_backend()})
    data.update(meta=np.asarray(json.dumps(meta)),
                shape=np.asarray([sh, sw], np.int32), bgr=bgr,
                hyp_segs=c["segs"], hyp_valid=c["valid"],
                hyp_status=c["status"])
    small = os.path.join(os.path.dirname(os.path.abspath(out)),
                         FIXTURES["frame_small"])
    np.savez_compressed(small, **data)
    print(f"{small}: {int(data['valid'].sum())} valid, "
          f"{int((data['status'] & 1).sum())} screens, "
          f"{os.path.getsize(small)} bytes; {c['reference']}")


if __name__ == "__main__":
    sys.exit(main())
