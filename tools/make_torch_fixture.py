"""Write the 720p reference fixture that chip_smoke.py holds the PyTorch
port against: the JAX package's poly path on bench.synth_frame(720, 1280,
seed=0), run on the CPU with PipelineConfig(mkpl_pallas=0).

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py [out.npz]

Default output: tests/data/poly_720p_synth.npz, holding
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


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    out = argv[1] if len(argv) > 1 else os.path.join(
        ROOT, "tests", "data", "poly_720p_synth.npz")

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
        "edge_bin_bits": np.packbits(edge_bin.reshape(-1).astype(np.uint8)),
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
