"""Write the 720p reference fixtures that chip_smoke.py holds the PyTorch
port against, from the JAX package run on the CPU on
bench.synth_frame(720, 1280, seed=0).

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py [poly|rect|hyp|frame|calib|gaps] [out.npz]
    JAX_PLATFORMS=cpu python -O tools/make_torch_fixture.py photos [out.npz]

Without arguments it writes all of them (under -O, for `photos`).

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

`calib`: the capacity calibration of that 192x144 scene, into
tests/data/calib_small.npz: runtime.calibrate._densities (the densities
the port measures), calibrate's kept capacities (plan in a temporary
directory), plan_fits for the default and the calibrated config, and the
SHA-256 of rect_stage_images' nine maps (edge_thin also as an array).

`photos`: the 25 photographs of docs/photo_corpus, each calibrated on
itself, then the rect path at the calibrated config through `_hyp_chain`
and `_geometry_tail`, into tests/data/photo_corpus.npz (make_photos).
The calibration's densities come from the JAX package's dense path,
whose weak labels, boundary labels and arcs come from fixed-pass CCLs;
each is checked against its converged form (`_label_checks`), and where
the boundary labels differ, the group count comes from the converged
labels, the substitution the other fixtures make.

`gaps`: the windows around each pixel where the port's edge_bin differs
from the JAX package's on the photographs (make_gaps), so that a test can
trace each one to an XLA:CPU ulp gap without JAX.

`tiles`: the width-tiled path (dist/tile.py) on small frames, with the
JAX package on 4 forced host devices (set before JAX is imported), into
tests/data/tiles.npz (make_tiles):

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py tiles

`streams`: the stream axis (batched rect_frames, dist/stream.py) on
8 frames of 48x64, with the JAX package on 8 forced host devices, into
tests/data/streams.npz (make_streams):

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py streams

`batch_tail`: the rect path's dense tail stages under jax.vmap on two
stacks, the four 48x64 frames of streams.npz and two 144x200 frames,
into tests/data/batch_tail.npz (make_batch_tail, about a minute):

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py batch_tail

`tile_walk`: the polyline stage's arc walk and subdivision by slot range
under shard_map (axis_name="tile") over 2, 3 and 4 of 4 forced host
devices, on three strings maps, into tests/data/tile_walk.npz
(make_tile_walk):

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py tile_walk
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
              "frame": make_frame, "calib": make_calib,
              "photos": make_photos, "gaps": make_gaps,
              "extended": make_extended, "photos_ext": make_photos_ext,
              "tiles": make_tiles, "streams": make_streams,
              "batch_tail": make_batch_tail, "tile_walk": make_tile_walk}
    which = argv[1:2] or list(makers)
    if which[0] not in makers:
        sys.exit(f"unknown fixture {which[0]!r}: one of {sorted(makers)}")
    forced = {"tiles": TILE_DEVICES, "streams": STREAM_DEVICES,
              "tile_walk": TILE_DEVICES}
    if which[0] in forced:
        # the sharded paths' shard_map needs this many devices; XLA reads
        # the flag when JAX starts
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{forced[which[0]]}").strip()
    out = argv[2] if len(argv) > 2 else None
    for name in which:
        makers[name](out or os.path.join(ROOT, "tests", "data",
                                         FIXTURES[name]))
    return 0


FIXTURES = {"poly": "poly_720p_synth.npz",
            "rect": "rect_regions_720p_synth.npz",
            "hyp": "rect_hyp_720p_synth.npz",
            "frame": "rect_frame_720p_synth.npz",
            "frame_small": "rect_frame_small.npz",
            "calib": "calib_small.npz",
            "photos": "photo_corpus.npz",
            "gaps": "photo_gaps.npz",
            "extended": "extended.npz",
            "photos_ext": "photo_corpus_ext.npz",
            "tiles": "tiles.npz",
            "streams": "streams.npz",
            "batch_tail": "batch_tail.npz",
            "tile_walk": "tile_walk.npz"}


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


def _weak_strong(fe, cfg):
    """The JAX package's weak/strong edge maps of a frame's front end, as
    rect_tail makes them: the dense strength pair, or with
    strength_rescue_rounds the staged form (calc_strength /
    filter_strength over the strings' slot list, rescue_filtered after
    each filter).  Where the fixed-pass labels give other > 0 maps than
    label_components_converged, the maps from the converged labels.
    Returns (weak, strong, the pixels where the two differ)."""
    import jax
    import jax.numpy as jnp

    from rectdetect_tpu.ops import ccl, morphology
    from rectdetect_tpu.ops.compact import compact_mask
    from rectdetect_tpu.pipeline.rect import weak_strong_labels

    h, w = fe.edge_bin.shape
    sp = max(4096, h * w // cfg.sparse_factor)
    rounds = cfg.strength_rescue_rounds

    def staged(lbl, s):
        scomp = compact_mask((s != 0).reshape(-1), sp)
        st = ccl.calc_strength(fe.edge_thin, lbl, cfg.strength_scale,
                               comp=scomp)
        wk = ccl.rescue_filtered(lbl, ccl.filter_strength(
            lbl, st, cfg.strength_weak, comp=scomp), rounds)
        sg = ccl.rescue_filtered(wk, ccl.filter_strength(
            wk, st, cfg.strength_strong, comp=scomp), rounds)
        return wk, sg

    def fixed_pair(eb, et):
        wk, sg, st, scomp = weak_strong_labels(eb, et, cfg)
        if sg is None:                  # the staged form, as rect_tail
            sg = ccl.rescue_filtered(wk, ccl.filter_strength(
                wk, st, cfg.strength_strong, comp=scomp), rounds)
        return wk, sg

    def converged_pair(eb, et):
        s = morphology.strings_chain(eb, "rect", bridge2=cfg.bridge_gap2,
                                     bh=cfg.morph_bh)
        lbl = ccl.label_components_converged(s, 0)
        if rounds:
            return staged(lbl, s)
        return ccl.strength_filter_pair_dense(
            et, lbl, sp, cfg.strength_weak, cfg.strength_strong,
            cfg.strength_scale)

    weak, strong = jax.jit(fixed_pair)(fe.edge_bin, fe.edge_thin)
    cweak, cstrong = jax.jit(converged_pair)(fe.edge_bin, fe.edge_thin)
    n_edge = int(((np.asarray(weak) > 0) != (np.asarray(cweak) > 0)).sum() +
                 ((np.asarray(strong) > 0) !=
                  (np.asarray(cstrong) > 0)).sum())
    if n_edge:
        return cweak, cstrong, n_edge
    return weak, strong, 0


def _hyp_chain(bgr_np, cfg):
    """The rect path from a BGR frame to the hypotheses on the JAX package
    (rect_tail's stages up to pipeline.rect._hypotheses), with the
    converged labels where the JAX CPU path's fixed-pass ones differ.
    Returns a dict of the stage outputs and `reference`, the sentence that
    says which labels were used."""
    import jax
    import jax.numpy as jnp

    from rectdetect_tpu.ops import ccl, polyline, regions
    from rectdetect_tpu.ops.compact import compact_mask
    from rectdetect_tpu.pipeline.frontend import edge_frontend
    from rectdetect_tpu.pipeline.rect import _hypotheses

    h, w = bgr_np.shape[:2]
    spb = max(4096, h * w // cfg.boundary_sparse_factor)
    bgr = jnp.asarray(bgr_np)
    fe = jax.jit(lambda b: edge_frontend(b, cfg))(bgr)
    weak, strong, n_edge = _weak_strong(fe, cfg)
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
    return {"packed0": fe.packed0, "edge_bin": fe.edge_bin, "weak": weak,
            "strong": strong, "mask": mask, "seg": seg,
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


# the densities the port measures, in the order the fixtures keep them,
# and the capacities it keeps (rectdetect_tpu_torch/runtime/calibrate.py)
DENSITY_NAMES = ("rect_d", "strings_d", "boundary_d", "arcs_d", "n_arcs",
                 "cyc_d", "groups")
KEPT = ("sparse_factor", "strings_sparse_factor", "boundary_sparse_factor",
        "arc_sparse_factor", "cycle_sparse_factor", "ls_capacity",
        "max_groups")
STAGE_NAMES = ("edge_thin", "weak_labels", "blblur", "despeckled",
               "strong_labels", "merge_mask", "regions", "boundary", "lsid")
PHOTO_STAGES = ("packed0", "edge_bin", "weak", "strong", "mask", "seg",
                "boundary", "lsid")


def _label_checks(bgr, cfg):
    """On the JAX package's dense calibration path (rect_stage_images with
    sparse_factor=0, what calibrate._densities measures): the pixels where
    the fixed-pass weak labels and boundary labels differ from
    label_components_converged, the pixels where the dense polyline's
    lsid differs from the slot-space polyline's with every slot list at
    one slot a pixel (whose arc walk needs no CCL), and the boundary
    components of the converged boundary labels."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from rectdetect_tpu.ops import ccl, morphology, polyline, regions
    from rectdetect_tpu.pipeline import rect as prect
    from rectdetect_tpu.pipeline.frontend import edge_frontend

    h, w = bgr.shape[:2]
    dense = dataclasses.replace(cfg, sparse_factor=0)
    one = dataclasses.replace(
        cfg, sparse_factor=1, strings_sparse_factor=1,
        boundary_sparse_factor=1, arc_sparse_factor=1,
        cycle_sparse_factor=1, strings_small_factor=1, arc_small_factor=1)

    @jax.jit
    def f(b):
        st = prect.rect_stage_images(b, dense)
        fe = edge_frontend(b, dense)
        s = morphology.strings_chain(fe.edge_bin, "rect",
                                     bridge2=cfg.bridge_gap2)
        fixed = ccl.label_components(s, 0, cfg.ccl_passes, cfg.ccl_jumps)
        conv = ccl.label_components_converged(s, 0)
        bconv = ccl.label_components_converged(
            regions.mark_boundary(st["regions"]), -1)
        strong_bin = (st["strong_labels"] > 0).astype(jnp.int32)
        _, lsid1 = polyline.polyline_execute(
            strong_bin, cfg.minerror_rect, cfg.size_thre_rect,
            cfg.ls_cap_for(w, h), one)
        flat = bconv.reshape(-1)
        roots = (flat == jnp.arange(h * w, dtype=flat.dtype)) & (flat >= 0)
        return (jnp.sum(fixed != conv), jnp.sum(st["boundary"] != bconv),
                jnp.sum(st["lsid"] != lsid1), jnp.sum(roots))

    n_weak, n_bnd, n_lsid, groups = (int(v) for v in f(jnp.asarray(bgr)))
    if n_weak or n_lsid:
        sys.exit(f"the dense calibration path's weak labels ({n_weak} px) or "
                 f"lsid ({n_lsid} px) differ from their converged forms: "
                 f"this generator substitutes only the boundary labels")
    return {"weak_fixed_vs_converged": n_weak,
            "boundary_fixed_vs_converged": n_bnd,
            "lsid_dense_vs_slot_space": n_lsid, "groups_converged": groups}


def _jax_calibrate(bgr, cfg, checks):
    """The JAX package's calibrate on one frame, with the plan in a
    temporary directory; returns (calibrated config, the 7 densities the
    port measures).  Where the dense path's fixed-pass boundary labels
    differ from the converged ones, calibrate's own arithmetic runs again
    on its densities with the group count of the converged labels."""
    import tempfile

    import jax.numpy as jnp

    from rectdetect_tpu.runtime import calibrate as cal

    orig = cal._densities
    seen = {}

    def spy(frames, c):
        seen["d"] = orig(frames, c)
        return seen["d"]

    def fixed(frames, c):
        d = seen["d"]
        return d[:8] + (checks["groups_converged"],) + d[9:]

    with tempfile.TemporaryDirectory() as td:
        cal._densities = spy
        try:
            new = cal.calibrate([jnp.asarray(bgr)], cfg,
                                plan_path=os.path.join(td, "plan.txt"))
            if checks["boundary_fixed_vs_converged"]:
                cal._densities = fixed
                new = cal.calibrate([jnp.asarray(bgr)], cfg,
                                    plan_path=os.path.join(td, "plan.txt"))
        finally:
            cal._densities = orig
    d = seen["d"]
    groups = (checks["groups_converged"]
              if checks["boundary_fixed_vs_converged"] else d[8])
    return new, (d[1], d[2], d[3], d[4], d[5], d[6], groups)


def make_calib(out: str) -> None:
    """The calibration of the 192x144 scene of rect_frame_small.npz on the
    JAX package: calibrate._densities, calibrate's capacities (plan in a
    temporary directory), plan_fits for DEFAULT_CONFIG and for the
    calibrated config, and the SHA-256 of rect_stage_images' nine maps
    with DEFAULT_CONFIG."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from rectdetect_tpu.config import PipelineConfig
    from rectdetect_tpu.ops import ccl, regions
    from rectdetect_tpu.ops.compact import compact_mask
    from rectdetect_tpu.pipeline.rect import rect_stage_images
    from rectdetect_tpu.runtime.calibrate import plan_fits

    cfg = PipelineConfig()
    bgr = np.load(os.path.join(ROOT, "tests", "data",
                               FIXTURES["frame_small"]))["bgr"]
    h, w = bgr.shape[:2]
    checks = _label_checks(bgr, cfg)
    new, dens = _jax_calibrate(bgr, cfg, checks)
    fits = [bool(plan_fits(c, bgr)) for c in (cfg, new)]
    st = {k: np.asarray(v) for k, v in
          rect_stage_images(jnp.asarray(bgr), cfg).items()}
    # the stage images' own fixed-pass labels against the converged ones,
    # the boundary with the boundary compaction's drop applied
    spb = max(4096, h * w // cfg.boundary_sparse_factor)
    bmark = regions.mark_boundary(jnp.asarray(st["regions"]))
    bcomp = compact_mask((bmark != -1).reshape(-1), spb)
    kept = np.asarray(bcomp.slot_of[:h * w] < spb).reshape(h, w)
    bconv = np.where(kept, np.asarray(
        ccl.label_components_converged(bmark, -1)), -1)
    n_bnd = int((bconv != st["boundary"]).sum())
    if checks["weak_fixed_vs_converged"] or n_bnd:
        sys.exit("the 192x144 scene's stage images differ from their "
                 "converged forms")
    meta = {
        "frame": "rect_frame_small.npz bgr, 192x144",
        "config": "PipelineConfig()",
        "densities": "rectdetect_tpu.runtime.calibrate._densities, as "
                     "calibrate measured them, in the order of "
                     "`density_names`",
        "capacities": "calibrate([frame]) with the plan in a temporary "
                      "directory: the fields of `kept`",
        "plan_fits": "plan_fits(PipelineConfig(), frame), plan_fits("
                     "calibrated, frame)",
        "stages": "rect_stage_images(frame, PipelineConfig()): SHA-256 of "
                  "each map's little-endian int32 (edge_thin and blblur: "
                  "float32 bits and packed Lab, as int32); edge_thin "
                  "itself too",
        "labels": checks,
        "stage_labels": "the stage images' fixed-pass weak and boundary "
                        "labels equal label_components_converged (the "
                        "boundary after the boundary compaction's drop)",
        "jax": jax.__version__, "backend": jax.default_backend(),
    }
    data = {
        "meta": np.asarray(json.dumps(meta)),
        "shape": np.asarray([h, w], np.int32),
        "density_names": np.asarray(DENSITY_NAMES),
        "densities": np.asarray(dens, np.float64),
        "kept": np.asarray(KEPT),
        "capacities": np.asarray([getattr(new, k) for k in KEPT], np.int64),
        "plan_fits": np.asarray(fits),
        "stage_names": np.asarray(STAGE_NAMES),
        "stage_sha256": np.asarray([
            digest(st[k].view(np.int32) if st[k].dtype == np.float32
                   else st[k]) for k in STAGE_NAMES]),
        # the one float map, for a comparison within a tolerance where its
        # bits differ (the XLA:CPU rsqrt of the edge vector)
        "edge_thin": st["edge_thin"].astype(np.float32),
    }
    np.savez_compressed(out, **data)
    print(f"{out}: densities {dict(zip(DENSITY_NAMES, dens))}, capacities "
          f"{dict(zip(KEPT, data['capacities'].tolist()))}, plan_fits "
          f"{fits}, {os.path.getsize(out)} bytes")


# the seed-66 shallow-slope scene of tests/test_accuracy_fixes.py
SEED66 = ("tests/test_property.random_scene(66) at 448x336 (the scene of "
          "tests/test_accuracy_fixes.py::"
          "test_shallow_slope_quad_detected_end_to_end)")
EXT_RADII = (1, 3, 7, 31, 40)
EXT_SIGMAS = (2.0, 5.0)
EXT_SEEDS = (0, 7, 2 ** 63 + 5)


def _seed66():
    """The seed-66 scene: (BGR uint8 448x336, its ground-truth quads)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_property as tp
    old = tp.W, tp.H
    tp.W, tp.H = 448, 336
    try:
        frame, quads = tp.random_scene(66)
    finally:
        tp.W, tp.H = old
    return (np.asarray(frame).astype(np.uint8),
            np.asarray(quads, np.float32))


def _poly_arena(bgr_np, cfg, minerror=1.0, size_thre=20, strength=500):
    """The JAX poly path on a frame: pipeline.poly.poly_frame where its
    fixed-pass weak labels equal label_components_converged, else the
    same stages from the converged labels.  Returns (the live segments
    as a dict of arrays, lsid, the sentence that says which)."""
    import jax
    import jax.numpy as jnp

    from rectdetect_tpu.ops import ccl, polyline
    from rectdetect_tpu.pipeline.frontend import edge_frontend
    from rectdetect_tpu.pipeline.poly import poly_frame

    h, w = bgr_np.shape[:2]
    bgr = jnp.asarray(bgr_np)
    fe = jax.jit(lambda b: edge_frontend(b, cfg))(bgr)
    fixed = jax.jit(lambda e: ccl.label_components_adaptive(
        e, 0, cfg.ccl_passes, cfg.ccl_jumps,
        small_cap=max(4096, h * w // 8), big_cap=max(4096, h * w // 2),
        round_cap=cfg.weak_ccl_round_cap, pieces_ok=True))(fe.edge_bin)
    conv = jax.jit(lambda e: ccl.label_components_converged(e, 0))(
        fe.edge_bin)
    n_diff = int((np.asarray(fixed) != np.asarray(conv)).sum())
    if n_diff == 0:
        how = ("pipeline.poly.poly_frame; its fixed-pass weak labels equal "
               "label_components_converged")
        arena, lsid = poly_frame(bgr, cfg, minerror, size_thre, strength)
    else:
        how = (f"converged labels: the fixed-pass weak labels differ from "
               f"label_components_converged at {n_diff} pixels, so "
               f"edge_frontend -> label_components_converged -> "
               f"calc_strength/filter_strength/rescue_filtered -> "
               f"polyline_execute")

        def edge_of(lbl):
            st = ccl.calc_strength(fe.edge_thin, lbl, cfg.strength_scale)
            f = ccl.filter_strength(lbl, st, strength)
            if cfg.strength_rescue_rounds:
                f = ccl.rescue_filtered(lbl, f, cfg.strength_rescue_rounds)
            return (f > 0).astype(jnp.int32)

        arena, lsid = jax.jit(lambda l: polyline.polyline_execute(
            edge_of(l), minerror, size_thre, cfg.ls_cap_for(w, h), cfg))(
                conv)
    a = {k: np.asarray(v) for k, v in arena._asdict().items()}
    live = np.nonzero(a["polyid"][:int(a["count"]) + 1])[0].astype(np.int32)
    segs = {"count": np.asarray(int(a["count"]), np.int32), "seg_id": live}
    for f in INT_FIELDS:
        segs[f] = a[f][live].astype(np.int32)
    for f in FLOAT_FIELDS:
        segs[f] = a[f][live].astype(np.float32)
    return segs, np.asarray(lsid), how


def _rect_rows(bgr_np, cfg):
    """The JAX rect path on a frame (_hyp_chain, _geometry_tail): the
    valid rows of the RectResult, c2 and status at them, the slot count,
    the chain's stage maps and which labels it used."""
    h, w = bgr_np.shape[:2]
    c = _hyp_chain(bgr_np, cfg)
    res = _geometry_tail(c["segs"], c["valid"], c["status"], w, h, cfg)
    rows = np.nonzero(res["valid"])[0].astype(np.int32)
    return {"rows": rows, "c2": res["c2"][rows].astype(np.float32),
            "status": res["status"][rows].astype(np.int32),
            "n_slots": np.asarray(res["valid"].shape[0], np.int32)}, c


def _quad_err(c2, g):
    """Mean corner distance of c2 (4,2) to g (4,2) under the best cyclic
    or reflected alignment (tests/test_accuracy_fixes.py)."""
    best = np.inf
    for s0 in range(4):
        for f in (1, -1):
            idx = [(s0 + f * k) % 4 for k in range(4)]
            best = min(best, float(np.linalg.norm(c2 - g[idx], axis=1)
                                   .mean()))
    return best


def _unit_cases(data):
    """The unit inputs and outputs of `extended`, into data."""
    import hashlib

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_accuracy_fixes import _shallow_staircase

    from rectdetect_tpu.core import color
    from rectdetect_tpu.ops import blur, ccl, morphology, regions
    from rectdetect_tpu.ops import rand as jrand
    from rectdetect_tpu.ops.compact import compact_mask

    # K3 with bridge2: the staircase, the wide hole and the junction
    # flank, and random maps (the pallas parity map of
    # test_pallas_morph_bridge2_parity, and signed maps at 3 densities)
    wide = np.zeros((16, 40), np.int32)
    wide[8, 3:10] = 1
    wide[8, 13:20] = 1
    junction = np.zeros((16, 40), np.int32)
    junction[8, 3:10] = 1
    junction[7, 9] = 1
    junction[9, 9] = 1
    junction[8, 12:20] = 1
    r = np.random.default_rng(6)
    maps = {"staircase": _shallow_staircase(), "wide": wide,
            "junction": junction,
            "random70x48": (r.random((70, 48)) < 0.25).astype(np.int32)}
    for i, d in enumerate((0.1, 0.3, 0.6)):
        r = np.random.default_rng(60 + i)
        vals = r.choice(np.array([-1, 1, 2], np.int32), size=(37, 53))
        maps[f"signed37x53_{d}"] = np.where(r.random((37, 53)) < d, vals,
                                            0).astype(np.int32)
    data["k3_names"] = np.asarray(list(maps))
    for k, m in maps.items():
        data[f"k3/{k}/in"] = m
        data[f"k3/{k}/connect2"] = np.asarray(jax.jit(
            morphology.simple_connect2)(jnp.asarray(m)))
        for v in ("rect", "poly_branch"):
            for b2 in (False, True):
                data[f"k3/{k}/{v}/{int(b2)}"] = np.asarray(jax.jit(
                    lambda e: morphology.strings_chain(e, v, bridge2=b2))(
                        jnp.asarray(m)))

    # rescue_filtered: the piece-label sliver and an isolated component
    # (test_rescue_filtered_repairs_piece_slivers), and a random case
    pre = np.zeros((12, 32), np.int32)
    pre[6, 2:30] = np.arange(2, 30)
    pre[2, 5:8] = 7
    filt = pre.copy()
    filt[6, 10:12] = -1
    filt[2, 5:8] = -1
    r = np.random.default_rng(4)
    pre_r = np.where(r.random((30, 40)) < 0.3,
                     r.integers(1, 900, (30, 40)), 0).astype(np.int32)
    filt_r = np.where(r.random((30, 40)) < 0.5, pre_r, -1).astype(np.int32)
    filt_r = np.where(pre_r > 0, filt_r, -1)
    for k, (a, b) in {"sliver": (pre, filt), "random": (pre_r,
                                                        filt_r)}.items():
        data[f"rescue/{k}/pre"] = a
        data[f"rescue/{k}/filtered"] = b
        data[f"rescue/{k}/out"] = np.asarray(ccl.rescue_filtered(
            jnp.asarray(a), jnp.asarray(b), 3))

    # the compacted strength pair past its capacity: labels of a random
    # edge map, a slot list holding 60% of the labelled pixels
    r = np.random.default_rng(5)
    edge = (r.random((48, 64)) < 0.35).astype(np.int32)
    lbl = np.asarray(ccl.label_components_converged(jnp.asarray(edge), 0))
    thin = np.where(edge > 0, r.random((48, 64)) * 0.5, 0).astype(
        np.float32)
    cap = int((lbl > 0).sum() * 0.6)

    def comp_pair(l, t):
        comp = compact_mask((l > 0).reshape(-1), cap)
        st = ccl.calc_strength(t, l, 10000.0, comp=comp)
        wk = ccl.filter_strength(l, st, 600, comp=comp)
        sg = ccl.filter_strength(wk, st, 1500, comp=comp)
        return st, wk, sg, ccl.rescue_filtered(l, wk, 3)

    st, wk, sg, rs = map(np.asarray, jax.jit(comp_pair)(
        jnp.asarray(lbl), jnp.asarray(thin)))
    data.update({"strength/label": lbl, "strength/edge": thin,
                 "strength/cap": np.asarray(cap),
                 "strength/thresholds": np.asarray([600, 1500]),
                 "strength/st": st, "strength/weak": wk,
                 "strength/strong": sg, "strength/weak_rescued": rs})

    # the blur: taps for r in 0..40, a 37x53 image at EXT_RADII, the
    # recursive blur at EXT_SIGMAS
    taps = [np.asarray(blur.gaussian_taps(k)) for k in range(41)]
    data["taps"] = np.concatenate(taps)
    data["taps_len"] = np.asarray([len(t) for t in taps], np.int32)
    img = np.random.default_rng(3).random((37, 53)).astype(np.float32)
    data["blur/in"] = img
    for k in EXT_RADII:
        data[f"blur/{k}"] = np.asarray(jax.jit(
            lambda x: blur.gaussian_blur(x, k))(jnp.asarray(img)))
    for sg_ in EXT_SIGMAS:
        data[f"blur_iir/{sg_}"] = np.asarray(jax.jit(
            lambda x: blur.gaussian_blur_iir(x, sg_))(jnp.asarray(img)))

    # the exact colour path: SHA-256 of the packed int32 of every colour,
    # colour i = (b, g, r) = (i & 255, (i >> 8) & 255, i >> 16), in order;
    # and labf_to_bgr(exact=True) of a sample's packed Lab
    h = hashlib.sha256()
    conv = jax.jit(color.bgr_to_packed_exact)
    for part in range(16):
        i = np.arange(part << 20, (part + 1) << 20, dtype=np.int64)
        bgr = np.stack([i & 255, (i >> 8) & 255, i >> 16], -1).astype(
            np.uint8).reshape(1024, 1024, 3)
        h.update(np.ascontiguousarray(np.asarray(conv(jnp.asarray(bgr))),
                                      dtype="<i4").tobytes())
    data["packed_exact_sha256"] = np.asarray(h.hexdigest())
    sample = np.random.default_rng(8).integers(0, 256, (24, 32, 3),
                                               dtype=np.uint8)
    packed = np.asarray(conv(jnp.asarray(sample)))
    data["color/bgr"] = sample
    data["color/packed"] = packed
    data["color/labf_to_bgr_exact"] = np.asarray(jax.jit(
        lambda p: color.labf_to_bgr(color.unpack_labf(p), exact=True))(
            jnp.asarray(packed)))

    # color_reassign on random colours and labels (-1 keeps its colour)
    r = np.random.default_rng(9)
    cp = r.integers(0, 2 ** 31, (40, 60)).astype(np.int32)
    cl = (r.integers(0, 7, (40, 60)) * 100 +
          r.integers(-1, 1, (40, 60))).astype(np.int32)
    data["reassign/packed"] = cp
    data["reassign/label"] = cl
    data["reassign/out"] = np.asarray(jax.jit(regions.color_reassign)(
        jnp.asarray(cp), jnp.asarray(cl)))

    # rand_field at a few seeds: the SHA-256 of 4096 values, the first 16
    data["rand/seeds"] = np.asarray([str(k) for k in EXT_SEEDS])
    for k in EXT_SEEDS:
        v = np.asarray(jrand.rand_field(4096, k))
        data[f"rand/{k}/sha256"] = np.asarray(digest(v))
        data[f"rand/{k}/head"] = v[:16]


def _ext_calibration(data):
    """The calibration of the 192x144 scene of rect_frame_small.npz from
    EXTENDED_CONFIG, as make_calib makes it from PipelineConfig()."""
    from rectdetect_tpu.config import EXTENDED_CONFIG
    from rectdetect_tpu.runtime.calibrate import plan_fits

    cfg = EXTENDED_CONFIG
    bgr = np.load(os.path.join(ROOT, "tests", "data",
                               FIXTURES["frame_small"]))["bgr"]
    checks = _label_checks(bgr, cfg)
    new, dens = _jax_calibrate(bgr, cfg, checks)
    data["calib/densities"] = np.asarray(dens, np.float64)
    data["calib/capacities"] = np.asarray([getattr(new, k) for k in KEPT],
                                          np.int64)
    data["calib/plan_fits"] = np.asarray([bool(plan_fits(c, bgr))
                                          for c in (cfg, new)])
    return checks


def make_extended(out: str) -> None:
    """EXTENDED_CONFIG (bridge_gap2, strength_rescue_rounds=3) and the
    other off-default capabilities on the JAX package, into
    tests/data/extended.npz (make_extended's sections below)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bench import synth_frame
    from rectdetect_tpu.config import DEFAULT_CONFIG, EXTENDED_CONFIG
    from rectdetect_tpu.pipeline.rect import live_rects, rect_frame
    from rectdetect_tpu_torch import parity

    cfg = EXTENDED_CONFIG
    data, meta = {}, {"config": "EXTENDED_CONFIG", "tan_aov":
                      "tan(radians(72) / 2)", "jax": jax.__version__,
                      "backend": jax.default_backend()}

    # the seed-66 scene: the rect path's valid rows and the poly arena;
    # rect_frame itself under both configs, against the chain and the
    # ground truth
    bgr, quads = _seed66()
    rows, c = _rect_rows(bgr, cfg)
    data.update({"s66/bgr": bgr, "s66/quads": quads})
    data.update({f"s66/{k}": v for k, v in rows.items()})
    for k in ("weak", "strong"):
        data[f"s66/{k}_sha256"] = np.asarray(digest(c[k]))
    segs, lsid, how_p = _poly_arena(bgr, cfg)
    data.update({f"s66/poly/{k}": v for k, v in segs.items()})
    data["s66/poly/lsid_sha256"] = np.asarray(digest(lsid))
    valid = np.zeros(int(rows["n_slots"]), bool)
    valid[rows["rows"]] = True
    c2 = np.zeros((int(rows["n_slots"]), 4, 2), np.float32)
    c2[rows["rows"]] = rows["c2"]
    chain_sets = parity.accepted_corner_sets(c2, valid)
    rf = {}
    for name, cf in (("EXTENDED_CONFIG", cfg),
                     ("DEFAULT_CONFIG", DEFAULT_CONFIG)):
        res = rect_frame(jnp.asarray(bgr), TAN_AOV, cf)
        dets = live_rects(res)
        sets = parity.accepted_corner_sets(np.asarray(res.c2),
                                           np.asarray(res.valid))
        rf[name] = {
            "best_err_per_quad": [min((_quad_err(np.asarray(d["c2"]), g)
                                       for d in dets), default=None)
                                  for g in quads],
            "corner_sets_vs_chain": dict(zip(
                ("matched", "rect_frame_only", "chain_only"),
                parity.match_sets(sets, chain_sets)))}
    meta["s66"] = {"frame": SEED66, "rect": c["reference"],
                   "poly": how_p, "rect_frame": rf,
                   "corner_sets": len(chain_sets)}

    # bench.synth_frame at 720p: rect_frame's valid rows, the stage maps'
    # digests and the weak/strong maps, the poly arena
    bgr = synth_frame(720, 1280, seed=0)
    rows, c = _rect_rows(bgr, cfg)
    data.update({f"s720/{k}": v for k, v in rows.items()})
    for k in ("packed0", "edge_bin", "weak", "strong", "mask", "seg",
              "boundary", "lsid"):
        data[f"s720/{k}_sha256"] = np.asarray(digest(c[k]))
    for k in ("weak", "strong"):
        data[f"s720/{k}_bits"] = bits(np.asarray(c[k]) > 0)
    segs, lsid, how_p = _poly_arena(bgr, cfg)
    data.update({f"s720/poly/{k}": v for k, v in segs.items()})
    data["s720/poly/lsid_sha256"] = np.asarray(digest(lsid))
    meta["s720"] = {"frame": "bench.synth_frame(720, 1280, seed=0)",
                    "rect": c["reference"], "poly": how_p}

    _unit_cases(data)
    meta["calib"] = _ext_calibration(data)
    meta["units"] = (
        "k3: simple_connect2 and strings_chain (rect, poly_branch; bridge2 "
        "0/1) of each map, jitted XLA; rescue: rescue_filtered(pre, "
        "filtered, 3); strength: calc_strength / filter_strength (600, "
        "then 1500 on the weak map) over compact_mask(label > 0, cap) and "
        "rescue_filtered of the weak map; taps: gaussian_taps(r), r = "
        "0..40, concatenated; blur: jitted gaussian_blur(in, r) and "
        "gaussian_blur_iir(in, sigma); packed_exact_sha256: "
        "bgr_to_packed_exact of every colour, (b, g, r) = (i & 255, "
        "(i >> 8) & 255, i >> 16) for i in order, int32 little-endian; "
        "color: labf_to_bgr(unpack_labf(packed), exact=True); reassign: "
        "color_reassign(packed, label); rand: SHA-256 and the first 16 values "
        "of rand_field(4096, seed); "
        "calib: calibrate._densities and the kept capacities of "
        "calibrate([rect_frame_small bgr], EXTENDED_CONFIG), plan_fits of "
        "EXTENDED_CONFIG and of the calibrated config")
    data["meta"] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **data)
    print(f"{out}: {os.path.getsize(out)} bytes; {json.dumps(meta)}")


PHOTO_DIR = os.path.join("docs", "photo_corpus")


def _photo_row(path, extended=False):
    """One photo of the corpus: the JAX package's calibrate, then the rect
    path at the calibrated config through _hyp_chain and _geometry_tail,
    from DEFAULT_CONFIG or, extended, from EXTENDED_CONFIG."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from PIL import Image

    from rectdetect_tpu.config import EXTENDED_CONFIG, PipelineConfig

    cfg = EXTENDED_CONFIG if extended else PipelineConfig()
    bgr = np.ascontiguousarray(
        np.asarray(Image.open(path).convert("RGB"))[..., ::-1])
    h, w = bgr.shape[:2]
    checks = _label_checks(bgr, cfg)
    new, dens = _jax_calibrate(bgr, cfg, checks)
    c = _hyp_chain(bgr, new)
    res = _geometry_tail(c["segs"], c["valid"], c["status"], w, h, new)
    rows = np.nonzero(res["valid"])[0].astype(np.int32)
    return {"name": os.path.basename(path), "shape": (h, w),
            "densities": dens,
            "capacities": [getattr(new, k) for k in KEPT],
            "labels": checks, "reference": c["reference"],
            "groups_filled": int(c["valid"].any(1).sum()),
            "rows": rows, "c2": res["c2"][rows].astype(np.float32),
            "status": res["status"][rows].astype(np.int32),
            "n_slots": int(res["valid"].shape[0]),
            "stage_sha256": [digest(c[k]) for k in PHOTO_STAGES],
            "edge_bin_bits": bits(c["edge_bin"])}


def make_photos(out: str, extended: bool = False) -> None:
    """The 25 photographs of docs/photo_corpus at 448x336, each calibrated
    on itself by the JAX package, into tests/data/photo_corpus.npz (or,
    extended, from EXTENDED_CONFIG into tests/data/photo_corpus_ext.npz):
    per photo (key prefix `<stem>/`) the densities and kept capacities,
    the valid rows of rect_frame's RectResult under the calibrated config
    (c2 and status at them, `rows` their slots out of `n_slots`), the
    SHA-256 of its stage maps (`stage_names`) and its bit-packed edge_bin.
    The photos are read in parallel (PHOTO_PROCS processes, default 4).

    The JAX package's first_k_members asserts n_groups < 2**11
    (reduce_ls.py:286), though its calibrate may choose max_groups = 2048
    (calibrate.py:173-174) and the u32 key it packs (g << 20 | 20 weight
    bits, all ones the sentinel) holds group ids up to 4094.  So a photo
    that calibrates to 2048 groups fails in the JAX rect path unless
    Python runs with assert statements off: run this maker as
    `python -O`, which the worker processes inherit; it refuses to run
    otherwise."""
    if __debug__:
        sys.exit("run the photos fixtures with python -O (see make_photos)")
    import functools
    import multiprocessing as mp

    import jax

    paths = sorted(os.path.join(ROOT, PHOTO_DIR, f)
                   for f in os.listdir(os.path.join(ROOT, PHOTO_DIR))
                   if f.endswith(".png"))
    procs = int(os.environ.get("PHOTO_PROCS", "4"))
    with mp.get_context("spawn").Pool(procs) as pool:
        rows = pool.map(functools.partial(_photo_row, extended=extended),
                        paths, chunksize=1)
    base = "EXTENDED_CONFIG" if extended else "PipelineConfig()"
    meta = {
        "photos": f"{PHOTO_DIR}/*.png, read with Pillow, RGB -> BGR",
        "config": f"{base}, then calibrate([photo], {base}) on each photo "
                  "(plan in a temporary directory)",
        "densities": "rectdetect_tpu.runtime.calibrate._densities, as "
                     "calibrate measured them (`density_names`); where the "
                     "dense path's fixed-pass boundary labels differ from "
                     "label_components_converged, the group count comes "
                     "from the converged labels and calibrate's arithmetic "
                     "runs again on it",
        "rect_frame": HYP_STAGES + " -> quad.reduce_groups -> "
                      "pose.pose_estimate -> looks_like_a_screen -> "
                      "sanitising, at the calibrated config, tan_aov = "
                      "tan(radians(72) / 2)",
        "labels": {r["name"]: r["labels"] for r in rows},
        "reference": {r["name"]: r["reference"] for r in rows},
        "asserts": "off (python -O): the JAX rect path's "
                   "reduce_ls.py:286 assert refuses the max_groups = 2048 "
                   "its calibrate chooses; no other assert on the path "
                   "fails",
        "jax": jax.__version__,
    }
    data = {"meta": np.asarray(json.dumps(meta)),
            "names": np.asarray([r["name"] for r in rows]),
            "density_names": np.asarray(DENSITY_NAMES),
            "kept": np.asarray(KEPT),
            "stage_names": np.asarray(PHOTO_STAGES)}
    for r in rows:
        p = r["name"][:-4] + "/"
        data[p + "shape"] = np.asarray(r["shape"], np.int32)
        data[p + "densities"] = np.asarray(r["densities"], np.float64)
        data[p + "capacities"] = np.asarray(r["capacities"], np.int64)
        data[p + "n_slots"] = np.asarray(r["n_slots"], np.int32)
        data[p + "groups_filled"] = np.asarray(r["groups_filled"], np.int32)
        for k in ("rows", "c2", "status", "edge_bin_bits"):
            data[p + k] = r[k]
        data[p + "stage_sha256"] = np.asarray(r["stage_sha256"])
    np.savez_compressed(out, **data)
    for r in rows:
        print(f"{r['name']}: capacities "
              f"{dict(zip(KEPT, r['capacities']))}, groups "
              f"{r['densities'][-1]}, {len(r['rows'])} valid; "
              f"{r['labels']}")
    print(f"{out}: {len(rows)} photos, {os.path.getsize(out)} bytes")


def make_photos_ext(out: str) -> None:
    """make_photos from EXTENDED_CONFIG, into
    tests/data/photo_corpus_ext.npz."""
    make_photos(out, extended=True)


GAP_HALF = 16


def make_gaps(out: str) -> None:
    """Where the port's edge_bin differs from the JAX package's on the
    photographs, the windows that show why, into
    tests/data/photo_gaps.npz: for each differing pixel, a window of up
    to 33x33 pixels around it (clipped to the image; `corner` holds its
    top-left corner and the image's height and width) of the JAX front
    end's packed0, blurred Lab (labb) and edge_thin, and the port's own
    packed0 there."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from PIL import Image

    from rectdetect_tpu.config import PipelineConfig
    from rectdetect_tpu.pipeline.frontend import edge_frontend
    from rectdetect_tpu_torch.pipeline.frontend import (
        edge_frontend as port_frontend)

    cfg = PipelineConfig()
    front = jax.jit(lambda b: edge_frontend(b, cfg))
    data, rows = {}, []
    names = sorted(f[:-4] for f in os.listdir(os.path.join(ROOT, PHOTO_DIR))
                   if f.endswith(".png"))
    for name in names:
        bgr = np.ascontiguousarray(np.asarray(Image.open(os.path.join(
            ROOT, PHOTO_DIR, name + ".png")).convert("RGB"))[..., ::-1])
        h, w = bgr.shape[:2]
        fe = front(jnp.asarray(bgr))
        pe = port_frontend(torch.from_numpy(bgr))
        eb = np.asarray(fe.edge_bin)
        for y, x in np.argwhere(eb != pe.edge_bin.numpy()):
            y0, x0 = max(0, y - GAP_HALF), max(0, x - GAP_HALF)
            y1, x1 = min(h, y + GAP_HALF + 1), min(w, x + GAP_HALF + 1)
            k = f"{name}/{y}_{x}/"
            win = (slice(y0, y1), slice(x0, x1))
            data[k + "corner"] = np.asarray([y0, x0, h, w], np.int32)
            data[k + "packed0"] = np.asarray(fe.packed0)[win]
            data[k + "port_packed0"] = pe.packed0.numpy()[win]
            data[k + "labb"] = np.asarray(fe.labb)[win]
            data[k + "edge_thin"] = np.asarray(fe.edge_thin)[win]
            rows.append(f"{name} ({y}, {x})")
    meta = {"photos": f"{PHOTO_DIR}/*.png", "pixels": rows,
            "reference": "jax.jit(edge_frontend) with PipelineConfig()",
            "port": "rectdetect_tpu_torch.pipeline.frontend.edge_frontend "
                    "on the CPU",
            "jax": jax.__version__}
    data["meta"] = np.asarray(json.dumps(meta))
    np.savez_compressed(out, **data)
    print(f"{out}: {len(rows)} pixels {rows}, {os.path.getsize(out)} bytes")


TILE_DEVICES = 4
# the tiled cases: (name, frame height, width, scene seed, tiles, front-end
# halo); "multihop" has 16-wide tiles, narrower than blblur's 56-column halo
TILE_CASES = (("t4", 48, 128, 7, 4, 16), ("t2", 48, 128, 7, 2, 16),
              ("multihop", 40, 64, 11, 4, 12))
# the offset forms' cases: (x0, w_total) of a 40 x 70 map; 0/None is the
# whole frame, -12 a left tile's halo, 19 and 37 odd interior columns, 53
# a right tile (53 + 70 = w_total)
OFFSETS = ((0, None), (-12, 90), (19, 101), (37, 141), (53, 123))
TILE_CFG = dict(max_groups=16)
TILE_TAN = math.tan(math.radians(72.0) / 2)


def _offset_inputs(seed: int = 5):
    """The offset forms' inputs, (40, 70) each, from a numpy seed."""
    r = np.random.default_rng(seed)
    h, w = 40, 70
    edge = (r.random((h, w)) < 0.3).astype(np.int32)
    packed = ((r.integers(0, 1024, (h, w)) << 22)
              | (r.integers(0, 1024, (h, w)) << 12)
              | r.integers(0, 4096, (h, w))).astype(np.int32)
    blur_edge = (r.random((h, w)) < 0.2).astype(np.int32)
    lbl = np.where(r.random((h, w)) < 0.25, r.integers(1, 50, (h, w)),
                   np.where(r.random((h, w)) < 0.5, -1, 0)).astype(np.int32)
    colours = r.integers(0, 3, (h // 4, w // 5)).repeat(4, 0).repeat(5, 1)
    colours = np.where(r.random((h, w)) < 0.05, 3, colours).astype(np.int32)
    mask = (r.random((h, w)) < 0.1).astype(np.int32)
    return dict(edge=edge, packed=packed, blur_edge=blur_edge, lbl=lbl,
                colours=colours, mask=mask)


def _snake(h: int, w: int) -> np.ndarray:
    """A boustrophedon: full rows joined by alternating end columns, one
    component crossing every seam about h / 2 times
    (tests/test_tile_tail.py)."""
    pix = np.zeros((h, w), np.int32)
    for r_, y in enumerate(range(2, h - 2, 2)):
        pix[y, 1:w - 1] = 1
        col = w - 2 if r_ % 2 == 0 else 1
        if y + 2 < h - 2:
            pix[y + 1, col] = 1
    return pix


def _result_arrays(prefix, res, data):
    for f in ("c2", "c3", "value", "status", "valid"):
        data[f"{prefix}/{f}"] = np.asarray(getattr(res, f))


def make_tiles(out: str) -> None:
    """The JAX package's width-tiled path under shard_map on TILE_DEVICES
    forced host devices, jitted, into tests/data/tiles.npz:
      * offset/*: strings_chain (rect, poly_branch; bridge2 0/1), blblur
        (3 and 10 rounds), junction_merge_mask and label_merge of
        _offset_inputs at each of OFFSETS;
      * <case>/*, for each of TILE_CASES: the frame (bench.synth_frame),
        the single-chip front end (packed0, edge_thin, edge_bin) and the
        tiled one (edge_frontend_tiled), ccl_tiled of the tiled strings,
        every tiled tail stage from the single-chip front-end products
        (tests/test_tile_tail.py's sequence), rect_tail_tiled on them,
        rect_step_tiled and (t4) poly_step_tiled and
        rect_step_tiled_gather on the frame;
      * snake/*: the boustrophedon through ccl_tiled (a binary map) and
        label_merge_tiled (two colours);
      * meta: the frames, seeds, tiles, halos, config and, per CCL output,
        whether the JAX CPU path's fixed-pass labels equal
        label_components_converged."""
    import functools

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bench import synth_frame
    from rectdetect_tpu.config import PipelineConfig
    from rectdetect_tpu.dist import mesh as dmesh
    from rectdetect_tpu.dist import tile as dtile
    from rectdetect_tpu.ops import ccl, morphology, regions
    from rectdetect_tpu.pipeline.frontend import edge_frontend

    if len(jax.devices()) < TILE_DEVICES:
        sys.exit(f"needs {TILE_DEVICES} host devices, JAX has "
                 f"{len(jax.devices())}: run `tiles` in a process of its "
                 "own")
    cfg = PipelineConfig(**TILE_CFG)
    data, meta = {}, {"config": f"PipelineConfig(**{TILE_CFG})",
                      "tan_aov": "tan(radians(72) / 2)",
                      "devices": TILE_DEVICES, "jax": jax.__version__,
                      "cases": {}, "converged": {}}

    # the offset forms
    inp = _offset_inputs()
    data.update({f"offset/in/{k}": v for k, v in inp.items()})
    for j, (x0, wt) in enumerate(OFFSETS):
        o = dict(x0=x0, w_total=wt)
        for v in ("rect", "poly_branch"):
            for b2 in (0, 1):
                data[f"offset/{j}/strings/{v}/{b2}"] = np.asarray(jax.jit(
                    lambda e: morphology.strings_chain(
                        e, v, bridge2=bool(b2), **o))(inp["edge"]))
        for iters in (3, 10):
            data[f"offset/{j}/blblur/{iters}"] = np.asarray(jax.jit(
                lambda p, e: regions.blblur(p, e, iters, **o))(
                    inp["packed"], inp["blur_edge"]))
        data[f"offset/{j}/merge_mask"] = np.asarray(jax.jit(
            lambda s_: regions.junction_merge_mask(s_, **o))(inp["lbl"]))
        data[f"offset/{j}/label_merge"] = np.asarray(jax.jit(
            lambda p, m, e: regions.label_merge(p, m, e, **o))(
                inp["colours"], inp["mask"], inp["lbl"]))
    meta["offsets"] = [list(o) for o in OFFSETS]

    tail_keys = ("strings", "glabel", "weak", "blurred", "despeck", "strong",
                 "mask", "seg", "bmark", "boundary")

    def conv_flag(name, lbl, pix, bgc):
        want = jax.jit(lambda p: ccl.label_components_converged(p, bgc))(pix)
        meta["converged"][name] = bool(
            (np.asarray(lbl) == np.asarray(want)).all())

    for name, h, w, seed, nt, halo in TILE_CASES:
        m = dmesh.make_mesh(1, nt)
        bgr = synth_frame(h, w, seed=seed)
        data[f"{name}/bgr"] = bgr
        fe = jax.jit(lambda b: edge_frontend(b, cfg))(jnp.asarray(bgr))
        for k in ("packed0", "edge_thin", "edge_bin"):
            data[f"{name}/{k}"] = np.asarray(getattr(fe, k))

        @functools.partial(shard_map, mesh=m,
                           in_specs=P(None, "tile", None),
                           out_specs=(P(None, "tile"), P(None, "tile")),
                           check_vma=False)
        def front(t):
            return dtile.edge_frontend_tiled(t, halo, cfg)

        et_t, eb_t = jax.jit(front)(jnp.asarray(bgr))
        data[f"{name}/tiled_edge_thin"] = np.asarray(et_t)
        data[f"{name}/tiled_edge_bin"] = np.asarray(eb_t)

        @functools.partial(
            shard_map, mesh=m, in_specs=(P(None, "tile"),) * 3,
            out_specs={k: P(None, "tile") for k in tail_keys},
            check_vma=False)
        def tail(pk, et, eb):
            s_ = dtile.strings_chain_tiled(eb, "rect",
                                           bridge2=cfg.bridge_gap2)
            glabel = dtile.ccl_tiled(s_, 0, cfg=cfg)
            st = dtile.calc_strength_tiled(et, glabel, cfg.strength_scale)
            weak = dtile.filter_strength_tiled(glabel, st, cfg.strength_weak)
            blurred = dtile.blblur_tiled(pk, (weak > 0).astype(jnp.int32),
                                         cfg.blblur_iters)
            despeck = dtile.quantize_despeckle_tiled(blurred, et, cfg)
            strong = dtile.filter_strength_tiled(weak, st,
                                                 cfg.strength_strong)
            mask = dtile.junction_merge_mask_tiled(strong)
            seg = dtile.label_merge_tiled(despeck, mask, strong, cfg)
            sizes = dtile.label_sizes_tiled(seg)
            seg2 = dtile.despeckle2_tiled(seg, sizes, cfg.despeckle2_thre)
            bmark = dtile.mark_boundary_tiled(seg2)
            boundary = dtile.ccl_tiled(bmark, -1, cfg=cfg)
            return dict(strings=s_, glabel=glabel, weak=weak,
                        blurred=blurred, despeck=despeck, strong=strong,
                        mask=mask, seg=seg2, bmark=bmark, boundary=boundary)

        maps = jax.jit(tail)(fe.packed0, fe.edge_thin, fe.edge_bin)
        for k in tail_keys:
            data[f"{name}/tail/{k}"] = np.asarray(maps[k])
        conv_flag(f"{name}/glabel", maps["glabel"], maps["strings"], 0)
        conv_flag(f"{name}/boundary", maps["boundary"], maps["bmark"], -1)

        @functools.partial(shard_map, mesh=m,
                           in_specs=(P(None, "tile"),) * 3, out_specs=P(),
                           check_vma=False)
        def rtail(pk, et, eb):
            return dtile.rect_tail_tiled(pk, et, eb, TILE_TAN, cfg)

        _result_arrays(f"{name}/rect_tail", jax.jit(rtail)(
            fe.packed0, fe.edge_thin, fe.edge_bin), data)

        @functools.partial(shard_map, mesh=m,
                           in_specs=P(None, "tile", None), out_specs=P(),
                           check_vma=False)
        def rstep(t):
            return dtile.rect_step_tiled(t, TILE_TAN, halo, cfg)

        _result_arrays(f"{name}/rect_step", jax.jit(rstep)(
            jnp.asarray(bgr)), data)
        if name == "t4":
            @functools.partial(shard_map, mesh=m,
                               in_specs=P(None, "tile", None),
                               out_specs=P(), check_vma=False)
            def gstep(t):
                return dtile.rect_step_tiled_gather(t, TILE_TAN, halo, cfg)

            _result_arrays(f"{name}/rect_gather", jax.jit(gstep)(
                jnp.asarray(bgr)), data)

            @functools.partial(shard_map, mesh=m,
                               in_specs=P(None, "tile", None),
                               out_specs=P(), check_vma=False)
            def pstep(t):
                return dtile.poly_step_tiled(t, cfg, halo=halo)

            arena, lsid = jax.jit(pstep)(jnp.asarray(bgr))
            a = {k: np.asarray(v) for k, v in arena._asdict().items()}
            for k, v in a.items():
                data[f"{name}/poly/{k}"] = v
            data[f"{name}/poly/lsid"] = np.asarray(lsid)
        meta["cases"][name] = {
            "frame": f"bench.synth_frame({h}, {w}, seed={seed})",
            "tiles": nt, "front_halo": halo, "strings_halo": 12,
            "blblur_halo": 5 * cfg.blblur_iters + 6, "merge_mask_halo": 12,
            "tiled_front_end_differs_from_single_chip": {
                "edge_thin": int((np.asarray(et_t)
                                  != np.asarray(fe.edge_thin)).sum()),
                "edge_bin": int((np.asarray(eb_t)
                                 != np.asarray(fe.edge_bin)).sum())}}

    # the boustrophedon through ccl_tiled and label_merge_tiled
    h, w = 40, 64
    m = dmesh.make_mesh(1, TILE_DEVICES)
    pix = _snake(h, w)
    packed = np.where(pix > 0, 9, 7).astype(np.int32)
    zeros = np.zeros((h, w), np.int32)
    data["snake/pix"] = pix

    @functools.partial(shard_map, mesh=m, in_specs=(P(None, "tile"),) * 3,
                       out_specs=(P(None, "tile"), P(None, "tile")),
                       check_vma=False)
    def snake(p, pk, z):
        return (dtile.ccl_tiled(p, 0, cfg=cfg),
                dtile.label_merge_tiled(pk, z, z, cfg))

    lbl, seg = jax.jit(snake)(pix, packed, zeros)
    data["snake/ccl"] = np.asarray(lbl)
    data["snake/label_merge"] = np.asarray(seg)
    conv_flag("snake/ccl", lbl, pix, 0)
    meta["snake"] = {"frame": f"{h}x{w} boustrophedon (_snake)",
                     "tiles": TILE_DEVICES,
                     "label_merge_colours": "9 on the snake, 7 elsewhere; "
                                            "no mask, no edges"}
    data["meta"] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **data)
    print(f"{out}: {os.path.getsize(out)} bytes; {json.dumps(meta)}")


STREAM_DEVICES = 8
# the stream cases: 8 frames of tests/conftest.py's synth_scene (seeds
# 0-7, the frames of tests/test_dist.py:69-82), the first 4 batched, all 8
# sharded over a (4, 1) mesh
STREAM_FRAMES = 8
STREAM_BATCH = 4
STREAM_HW = (48, 64)
STREAM_CFG = dict(max_groups=16)


def make_streams(out: str) -> None:
    """The JAX package's stream axis on STREAM_DEVICES forced host devices,
    jitted, into tests/data/streams.npz:
      * frames: synth_scene(48, 64, seed=s), s = 0..7;
      * fe/*: edge_frontend under vmap on the first 4 frames (packed0,
        edge_thin, edge_bin) and edgevec of its blurred L plane (vec);
      * batch/*: rect_frames on the first 4 frames;
      * sharded/*: rect_frames_sharded on all 8 over a (4, 1) mesh;
      * poly/*: poly_frames_sharded on all 8 over the same mesh (arena
        fields and lsid, defaults minerror 1, size_thre 20, strength 500);
      * single/<i>/*, single_poly/<i>/*: rect_frame and poly_frame of each
        frame alone;
      * meta: the config, and per frame whether the batched and sharded
        results equal the per-frame ones (valid, status and lsid equal,
        c2, value and the arena's endpoints within 1e-4), and the pixels
        (frame, y, x) where a component of that vec exceeds 1 in
        magnitude: XLA:CPU's rsqrt is not correctly rounded, and there K2's
        sample offset can cross its clamp (ops/thin.py)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from rectdetect_tpu.config import PipelineConfig
    from rectdetect_tpu.dist.mesh import make_mesh
    from rectdetect_tpu.dist.stream import (poly_frames_sharded,
                                            rect_frames_sharded)
    from rectdetect_tpu.ops import gradient
    from rectdetect_tpu.pipeline.frontend import edge_frontend
    from rectdetect_tpu.pipeline.poly import poly_frame
    from rectdetect_tpu.pipeline.rect import rect_frame, rect_frames
    from tests.conftest import synth_scene

    if len(jax.devices()) < STREAM_DEVICES:
        sys.exit(f"needs {STREAM_DEVICES} host devices, JAX has "
                 f"{len(jax.devices())}: run `streams` in a process of its "
                 "own")
    cfg = PipelineConfig(**STREAM_CFG)
    h, w = STREAM_HW
    frames = np.stack([synth_scene(h=h, w=w, seed=s)
                       for s in range(STREAM_FRAMES)])
    data = {"frames": frames}
    meta = {"config": f"PipelineConfig(**{STREAM_CFG})",
            "tan_aov": "tan(radians(72) / 2)",
            "frames": f"tests/conftest.py synth_scene({h}, {w}, seed=s), "
                      f"s = 0..{STREAM_FRAMES - 1}",
            "batch": STREAM_BATCH, "mesh": [4, 1],
            "devices": STREAM_DEVICES, "jax": jax.__version__,
            "poly_args": {"minerror": 1.0, "size_thre": 20,
                          "strength": 500}}
    tan = TILE_TAN
    fb = jnp.asarray(frames[:STREAM_BATCH])
    fe = jax.jit(jax.vmap(lambda f: edge_frontend(f, cfg)))(fb)
    for k in ("packed0", "edge_thin", "edge_bin"):
        data[f"fe/{k}"] = np.asarray(getattr(fe, k))
    vec = np.asarray(jax.jit(jax.vmap(
        lambda f: gradient.edgevec(edge_frontend(f, cfg).labb[..., 0])))(fb))
    data["fe/vec"] = vec
    meta["jax_vec_above_one"] = [
        [int(v) for v in p] for p in np.argwhere(np.abs(vec).max(-1) > 1.0)]
    _result_arrays("batch", rect_frames(fb, tan, cfg), data)
    mesh = make_mesh(4, 1)
    _result_arrays("sharded", rect_frames_sharded(jnp.asarray(frames), tan,
                                                  mesh, cfg), data)
    arena, lsid = poly_frames_sharded(jnp.asarray(frames), mesh, cfg)
    for k, v in arena._asdict().items():
        data[f"poly/{k}"] = np.asarray(v)
    data["poly/lsid"] = np.asarray(lsid)

    def same_rect(prefix, i, single):
        v = data[f"{prefix}/valid"][i]
        return bool(
            (v == single["valid"]).all()
            and (data[f"{prefix}/status"][i] == single["status"]).all()
            and np.allclose(data[f"{prefix}/c2"][i][v], single["c2"][v],
                            rtol=0, atol=1e-4)
            and np.allclose(data[f"{prefix}/value"][i][v],
                            single["value"][v], rtol=0, atol=1e-4))

    meta["per_frame"] = []
    for i in range(STREAM_FRAMES):
        f = jnp.asarray(frames[i])
        res = rect_frame(f, tan, cfg)
        single = {k: np.asarray(getattr(res, k))
                  for k in ("c2", "c3", "value", "status", "valid")}
        for k, v in single.items():
            data[f"single/{i}/{k}"] = v
        a1, l1 = poly_frame(f, cfg)
        a1 = {k: np.asarray(v) for k, v in a1._asdict().items()}
        for k, v in a1.items():
            data[f"single_poly/{i}/{k}"] = v
        data[f"single_poly/{i}/lsid"] = np.asarray(l1)
        poly_same = bool((np.asarray(l1) == data["poly/lsid"][i]).all())
        for k, v in a1.items():
            got = data[f"poly/{k}"][i]
            poly_same &= bool(np.allclose(got, v, rtol=0, atol=1e-4)
                              if v.dtype.kind == "f" else (got == v).all())
        row = {"frame": i,
               "batch_equals_single": same_rect("batch", i, single)
               if i < STREAM_BATCH else None,
               "sharded_equals_single": same_rect("sharded", i, single),
               "poly_sharded_equals_single": poly_same,
               "valid": int(single["valid"].sum())}
        meta["per_frame"].append(row)
    data["meta"] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **data)
    print(f"{out}: {os.path.getsize(out)} bytes; {json.dumps(meta)}")


# the batch_tail fixture's second stack: frames (count, height, width) of
# synth_scene from these seeds; a width that is no multiple of 32, and
# frames that cross the kernels' tiles both ways
BATCH_TAIL_WIDE = (2, 144, 200)
BATCH_TAIL_SEEDS = (21, 22)


def make_batch_tail(out: str) -> None:
    """The JAX package's dense tail stages of the rect path (rect_tail's
    stages that rect_frames vmaps) under jax.vmap, jitted, into
    tests/data/batch_tail.npz, for two stacks: `s48`, the first
    STREAM_BATCH frames of tests/data/streams.npz (its fe/* maps), and
    `s144`, synth_scene(144, 200, seed) for BATCH_TAIL_SEEDS through the
    vmapped edge_frontend.  Per stack (leading frame axis):
      * packed0, edge_thin, edge_bin: the front end's maps;
      * strings: morphology.strings_chain(edge_bin, "rect");
      * weak, strong: the weak/strong labels, frame by frame as
        `_hyp_chain` makes them (the converged labels where the fixed-pass
        ones change the > 0 maps);
      * blurred, despeck, mask, seg0 (label_merge), seg
        (sizes_despeckle2): `_hyp_chain`'s regions_part under vmap;
    and for `s48` also strings_bridge2, the strings of EXTENDED_CONFIG's
    bridge_gap2.  The config is the streams fixture's."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from rectdetect_tpu.config import EXTENDED_CONFIG, PipelineConfig
    from rectdetect_tpu.ops import morphology, regions
    from rectdetect_tpu.pipeline.frontend import EdgeFrontend, edge_frontend
    from tests.conftest import synth_scene

    cfg = PipelineConfig(**STREAM_CFG)
    n = cfg.quantize_levels
    streams = np.load(os.path.join(ROOT, "tests", "data", "streams.npz"))
    count, h, w = BATCH_TAIL_WIDE
    wide = np.stack([synth_scene(h=h, w=w, seed=s)
                     for s in BATCH_TAIL_SEEDS[:count]])
    fe_w = jax.jit(jax.vmap(lambda f: edge_frontend(f, cfg)))(
        jnp.asarray(wide))
    stacks = {
        "s48": {k: streams[f"fe/{k}"]
                for k in ("packed0", "edge_thin", "edge_bin")},
        "s144": {k: np.asarray(getattr(fe_w, k))
                 for k in ("packed0", "edge_thin", "edge_bin")}}

    def strings(eb, bridge2):
        return morphology.strings_chain(eb, "rect", bridge2=bridge2,
                                        bh=cfg.morph_bh)

    def regions_part(p0, et, wk, st):
        blurred = regions.blblur(p0, (wk > 0).astype(jnp.int32),
                                 cfg.blblur_iters)
        despeck = regions.quantize_despeckle(blurred, et, n, n, n)
        mask = regions.junction_merge_mask(st)
        seg0 = regions.label_merge(despeck, mask, st, cfg.labelmerge_passes,
                                   cfg.labelmerge_jumps)
        seg = regions.sizes_despeckle2(seg0, cfg.despeckle2_thre,
                                       cfg.region_run_factor)
        return blurred, despeck, mask, seg0, seg

    data = {}
    meta = {"config": f"PipelineConfig(**{STREAM_CFG})",
            "s48": "tests/data/streams.npz fe/* (frames 0..3)",
            "s144": f"tests/conftest.py synth_scene({h}, {w}, seed) for "
                    f"seeds {list(BATCH_TAIL_SEEDS[:count])}, "
                    "edge_frontend under vmap",
            "jax": jax.__version__, "edge_labels_converged": {}}
    for name, st in stacks.items():
        eb = jnp.asarray(st["edge_bin"])
        st["strings"] = np.asarray(jax.jit(jax.vmap(
            lambda e: strings(e, cfg.bridge_gap2)))(eb))
        weak, strong = [], []
        for i in range(eb.shape[0]):
            fe = EdgeFrontend(jnp.asarray(st["packed0"][i]), None,
                              jnp.asarray(st["edge_thin"][i]), eb[i])
            wk, sg, n_edge = _weak_strong(fe, cfg)
            weak.append(np.asarray(wk))
            strong.append(np.asarray(sg))
            meta["edge_labels_converged"][f"{name}/{i}"] = n_edge
        st["weak"], st["strong"] = np.stack(weak), np.stack(strong)
        outs = jax.jit(jax.vmap(regions_part))(
            jnp.asarray(st["packed0"]), jnp.asarray(st["edge_thin"]),
            jnp.asarray(st["weak"]), jnp.asarray(st["strong"]))
        for k, v in zip(("blurred", "despeck", "mask", "seg0", "seg"), outs):
            st[k] = np.asarray(v)
        for k, v in st.items():
            data[f"{name}/{k}"] = v
    data["s48/strings_bridge2"] = np.asarray(jax.jit(jax.vmap(
        lambda e: strings(e, EXTENDED_CONFIG.bridge_gap2)))(
            jnp.asarray(stacks["s48"]["edge_bin"])))
    meta["strings_bridge2"] = ("s48 strings with EXTENDED_CONFIG's "
                               f"bridge_gap2={EXTENDED_CONFIG.bridge_gap2}")
    meta["counts"] = {k: int((v > 0).sum()) for k, v in data.items()
                      if k.endswith(("strings", "strings_bridge2", "weak",
                                     "strong", "mask"))}
    data["meta"] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **data)
    print(f"{out}: {os.path.getsize(out)} bytes; {json.dumps(meta)}")


# the sharded polyline stage's cases: (name, height, width); "t4" is the
# tiled fixture's t4 frame, "snake" a boustrophedon whose one chain is
# longer than any tile's range of walk states (and fits the slot list), "rings" closed rings and
# open strokes, so that the cycle re-walk and the cycle roots matter
WALK_CASES = (("t4", 48, 128), ("snake", 64, 160), ("rings", 64, 96))
WALK_TILES = (2, 3, 4)
# the subdivision's slot list: the arc slots at a capacity just above
# their count, so that every tile's slot range holds live slots and the
# last range is short for 3 and 4 tiles
WALK_SLACK = 5


def _snake_path(h: int, w: int) -> np.ndarray:
    """A boustrophedon that is one simple path: rows 3 apart, each end
    joined to the next row's by two pixels in the column beyond it, so that
    every pixel but the two ends has exactly two 8-neighbours."""
    pix = np.zeros((h, w), np.int32)
    rows = list(range(2, h - 3, 3))
    for r_, y in enumerate(rows):
        pix[y, 5:w - 5] = 1
        if r_ + 1 < len(rows):
            pix[y + 1:y + 3, w - 5 if r_ % 2 == 0 else 4] = 1
    return pix


def _rings(h: int, w: int) -> np.ndarray:
    """Closed rings (rectangle outlines, a diamond) and open strokes."""
    pix = np.zeros((h, w), np.int32)
    for y0, x0, y1, x1 in ((4, 4, 20, 30), (8, 40, 40, 70), (30, 6, 56, 24),
                           (46, 50, 58, 88)):
        pix[y0, x0:x1 + 1] = pix[y1, x0:x1 + 1] = 1
        pix[y0:y1 + 1, x0] = pix[y0:y1 + 1, x1] = 1
    cy, cx, r = 24, 84, 8
    for k in range(-r, r + 1):
        pix[cy + k, cx + (r - abs(k))] = pix[cy + k, cx - (r - abs(k))] = 1
    pix[60, 2:40] = 1
    for k in range(20):
        pix[42 + k // 2, 30 + k] = 1
    return pix


def make_tile_walk(out: str) -> None:
    """The JAX package's arc walk (chain.arc_chain_sparse) and XLA
    subdivision (polyline.mkpl_subdivide with comp) with
    axis_name="tile" under shard_map over WALK_TILES of TILE_DEVICES
    forced host devices, jitted, into tests/data/tile_walk.npz:
      * <case>/strings: strings_chain(..., "poly_branch") of the t4
        frame's edge_bin, of _snake and of _rings;
      * <case>/walk/<tiles>/<field>: the walk's six outputs over the
        strings' compaction (cap max(4096, H*W // strings_sparse_factor),
        default number_doublings, cyc_cap and the cycle re-walk always
        run);
      * <case>/mkpl_in/*: the subdivision's inputs as the sparse polyline
        tail makes them from the unsharded walk (arc size filter
        size_thre 20, dense relabel), over a compaction of the arc slots
        at their count + WALK_SLACK: the dense and number images, the
        slot list and the mkpl_init arena at the frame's ls_cap_for;
      * <case>/mkpl/<tiles>/<field>, lsid: the arena and lsid after
        mkpl_iters rounds at minerror 1.0; for t4 also at an arena cap of
        count + 3 (`mkpl_ovf`), which overflows;
      * meta."""
    import functools

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bench import synth_frame
    from rectdetect_tpu.config import PipelineConfig
    from rectdetect_tpu.dist import mesh as dmesh
    from rectdetect_tpu.ops import chain, morphology, polyline
    from rectdetect_tpu.ops.compact import compact_mask, compact_subset
    from rectdetect_tpu.pipeline.frontend import edge_frontend

    if len(jax.devices()) < TILE_DEVICES:
        sys.exit(f"needs {TILE_DEVICES} host devices, JAX has "
                 f"{len(jax.devices())}: run `tile_walk` in a process of "
                 "its own")
    cfg = PipelineConfig()
    size_thre, minerror = 20, 1.0
    fields = ("number_s", "head_s", "live", "cyc", "chainlen_s", "arcmin_s")
    data, meta = {}, {"config": "PipelineConfig()", "jax": jax.__version__,
                      "devices": TILE_DEVICES, "tiles": list(WALK_TILES),
                      "size_thre": size_thre, "minerror": minerror,
                      "cases": {}}
    for name, h, w in WALK_CASES:
        n = h * w
        if name == "t4":
            fe = jax.jit(lambda b: edge_frontend(b, cfg))(
                jnp.asarray(synth_frame(h, w, seed=7)))
            src = fe.edge_bin
        else:
            src = jnp.asarray(_snake_path(h, w) if name == "snake"
                              else _rings(h, w))
        strings = np.asarray(jax.jit(lambda e: morphology.strings_chain(
            e, "poly_branch"))(src))
        data[f"{name}/strings"] = strings
        sp = max(4096, n // cfg.strings_sparse_factor)
        cyc_cap = max(1024, n // cfg.cycle_sparse_factor)

        def walk(s, axis_name=None):
            comp = compact_mask((s != 0).reshape(-1), sp)
            return chain.arc_chain_sparse(s, comp, cfg.number_doublings,
                                          cyc_cap, axis_name, cyc_pin=2)

        whole = [np.asarray(x) for x in jax.jit(walk)(jnp.asarray(strings))]
        for nt in WALK_TILES:
            m = dmesh.make_mesh(1, nt)
            got = jax.jit(shard_map(functools.partial(walk, axis_name="tile"),
                                    mesh=m, in_specs=P(), out_specs=P(),
                                    check_vma=False))(jnp.asarray(strings))
            for f, v, v1 in zip(fields, got, whole):
                v = np.asarray(v)
                assert (v == v1).all(), (name, nt, f)
                data[f"{name}/walk/{nt}/{f}"] = v

        # the subdivision's inputs from the unsharded walk
        number_w, _, live_w, cyc_w, chainlen_w, arcmin_w = whole
        comp0 = compact_mask(jnp.asarray(strings != 0).reshape(-1), sp)
        Sw = comp0.cap
        p_w = np.clip(np.asarray(comp0.idx), 0, n - 1)
        slot_of = np.asarray(comp0.slot_of)
        keep = live_w & (number_w > 0) & (chainlen_w > size_thre)
        root_slot = slot_of[np.clip(arcmin_w, 0, n)]
        keep &= root_slot < Sw
        rank = np.cumsum(keep & (p_w == arcmin_w))
        dense_w = np.where(keep, rank[np.clip(root_slot, 0, Sw - 1)], 0)
        n_arc = int((dense_w > 0).sum())
        cap_m = n_arc + WALK_SLACK
        comp_m = compact_subset(comp0, jnp.asarray(dense_w > 0), cap_m)
        tgt = np.where(dense_w > 0, p_w, n)
        dense = np.zeros(n + 1, np.int32)
        number = np.zeros(n + 1, np.int32)
        dense[tgt] = dense_w
        number[tgt] = number_w
        dense = jnp.asarray(dense[:n].reshape(h, w))
        number = jnp.asarray(number[:n].reshape(h, w))
        ls_cap = cfg.ls_cap_for(w, h)
        arena0 = jax.jit(lambda d, nb, c: polyline.mkpl_init(
            d, nb, ls_cap, c))(dense, number, comp_m)
        count0 = int(arena0.count)
        data[f"{name}/mkpl_in/dense"] = np.asarray(dense)
        data[f"{name}/mkpl_in/number"] = np.asarray(number)
        data[f"{name}/mkpl_in/idx"] = np.asarray(comp_m.idx)
        for k, v in arena0._asdict().items():
            data[f"{name}/mkpl_in/{k}"] = np.asarray(v)
        caps = {"mkpl": ls_cap}
        if name == "t4":
            caps["mkpl_ovf"] = count0 + 3
        rec = {"frame": ("bench.synth_frame(48, 128, seed=7) edge_bin"
                         if name == "t4" else
                         f"{'_snake_path' if name == 'snake' else '_rings'}"
                         f"({h}, {w})"),
               "strings_cap": sp, "cyc_cap": cyc_cap,
               "cycle_slots": int(cyc_w.sum()),
               "walk_states_per_tile": {nt: -(-2 * sp // nt)
                                        for nt in WALK_TILES},
               "longest_chain": int(chainlen_w.max()),
               "arc_slots": n_arc, "mkpl_slots": cap_m, "count0": count0,
               "caps": caps}
        for key, cap in caps.items():
            a_in = arena0
            if cap != ls_cap:
                a_in = type(arena0)(**{
                    k: (v if k == "count" else v[:cap])
                    for k, v in arena0._asdict().items()})

            def sub(a, d, nb, c, axis_name=None):
                return polyline.mkpl_subdivide(a, d, nb, minerror,
                                               cfg.mkpl_iters, c, axis_name)

            a1, l1 = jax.jit(sub)(a_in, dense, number, comp_m)
            for nt in WALK_TILES:
                m = dmesh.make_mesh(1, nt)
                a2, l2 = jax.jit(shard_map(
                    functools.partial(sub, axis_name="tile"), mesh=m,
                    in_specs=P(), out_specs=P(), check_vma=False))(
                        a_in, dense, number, comp_m)
                assert (np.asarray(l2) == np.asarray(l1)).all(), (name, nt)
                for k, v in a2._asdict().items():
                    data[f"{name}/{key}/{nt}/{k}"] = np.asarray(v)
                data[f"{name}/{key}/{nt}/lsid"] = np.asarray(l2)
            rec[f"{key}_count"] = int(a1.count)
            rec[f"{key}_overflows"] = bool(int(a1.count) >= cap - 1)
        meta["cases"][name] = rec
    data["meta"] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **data)
    print(f"{out}: {os.path.getsize(out)} bytes; {json.dumps(meta)}")


if __name__ == "__main__":
    sys.exit(main())
