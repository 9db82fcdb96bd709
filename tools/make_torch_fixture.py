"""Write the 720p reference fixtures that chip_smoke.py holds the PyTorch
port against, from the JAX package run on the CPU on
bench.synth_frame(720, 1280, seed=0).

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py [poly|rect] [out.npz]

Without arguments it writes both.

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
"""

from __future__ import annotations

import hashlib
import json
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
    which = argv[1:2] or ["poly", "rect"]
    if which[0] not in ("poly", "rect"):
        sys.exit(f"unknown fixture {which[0]!r}: poly or rect")
    out = argv[2] if len(argv) > 2 else None
    for name in which:
        (make_poly if name == "poly" else make_rect)(
            out or os.path.join(ROOT, "tests", "data",
                                FIXTURES[name]))
    return 0


FIXTURES = {"poly": "poly_720p_synth.npz",
            "rect": "rect_regions_720p_synth.npz"}


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


if __name__ == "__main__":
    sys.exit(main())
