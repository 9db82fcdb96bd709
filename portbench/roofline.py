"""The yardstick of the port's kernels: the H100's peaks and, for each C
entry point of the port's kernel library, the bytes and operations a call
needs, worked out from the arguments it is launched with.

Bytes count each input read once and each output written once at the
call's shapes (the counts of the port's own kernel check, frozen here);
where the work depends on data the arguments do not show, only what they
do show is counted, so every bound stays a lower bound of the call's time:
mkpl's arena and slot list are read only at the live slots, which no
argument gives, so mkpl counts nothing.  A call's bound time is the larger
of bytes over the memory rate and operations over the float32 rate.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s outside the
# tensor cores (it gives no int32 rate; int32 runs no faster, so integer
# work counted at this rate stays a lower bound)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# float operations of one evaluation of the pose objective, and what a jet
# with one seed direction adds (csrc/pose.cu quad_value: 185 on floats)
POSE_VALUE_OPS = 185
POSE_JET_OPS_PER_DIR = 2 * (POSE_VALUE_OPS - 4)


def _pix(h, w, b=1):
    return h * w * b


def _pose_ops(g, cg_iters, ls_iters):
    """A lower bound on the pose kernel's float operations for g groups:
    per (group, mode) the gradient jets, one line-search jet per step and
    the value at each search's last candidate."""
    n_jet4 = cg_iters + 1
    n_jet1 = cg_iters * ls_iters
    return 2 * g * (n_jet4 * (POSE_VALUE_OPS + 4 * POSE_JET_OPS_PER_DIR)
                    + n_jet1 * (POSE_VALUE_OPS + POSE_JET_OPS_PER_DIR)
                    + cg_iters * POSE_VALUE_OPS)


# entry point -> args (as passed to the library, the stream left out) ->
# (bytes, operations)
ENTRIES = {
    # labb (B,H,W,3) f32 in; em (B,H,W) f32 and vec (B,H,W,2) f32 out
    "rd_edge_front": lambda a: (24 * _pix(a[3], a[4], a[5]), 0),
    # em, vec in; edge_thin out
    "rd_thin": lambda a: (16 * _pix(a[3], a[4], a[5]), 0),
    # int32 map in and out
    "rd_strings_chain": lambda a: (8 * _pix(a[2], a[3], a[4]), 0),
    "rd_label_components": lambda a: (8 * _pix(a[2], a[3]), 0),
    "rd_merge_mask": lambda a: (8 * _pix(a[2], a[3], a[4]), 0),
    "rd_despeckle2": lambda a: (8 * _pix(a[3], a[4], a[5]), 0),
    # packed Lab and the edge map in, packed Lab out
    "rd_blblur": lambda a: (12 * _pix(a[5], a[6], a[7]), 0),
    "rd_quant_despeckle": lambda a: (12 * _pix(a[3], a[4], a[5]), 0),
    # packed Lab, mask and edge labels in, labels out
    "rd_label_merge": lambda a: (16 * _pix(a[4], a[5], a[6]), 0),
    # boundary in, four id maps out
    "rd_distinct_bids": lambda a: (20 * _pix(a[2], a[3]), 0),
    # key and value in, scan out, s rows
    "rd_seg_scan": lambda a: (12 * a[4], 0),
    "rd_seg_total": lambda a: (12 * a[4], 0),
    # segs (G,K,2,2) f32 and valid (G,K) in; corners (G,4,2) and ok out
    "rd_hyp": lambda a: (a[4] * a[5] * 17 + a[4] * 33, 0),
    # corners (G,4,2) in; c2 (G,4,2), c3 (G,4,3), value (G,) out
    "rd_pose": lambda a: (116 * a[4], _pose_ops(a[4], a[8], a[9])),
    "rd_mkpl": lambda a: (0, 0),
    "rd_mkpl_setup": lambda a: (0, 0),
    "rd_mkpl_keys": lambda a: (0, 0),
    "rd_mkpl_splits": lambda a: (0, 0),
}

# the port's kernels as the device trace names them: csrc/*.cu's
# __global__ functions, all in anonymous namespaces
KERNELS = frozenset((
    "edge_front_kernel", "thin_kernel", "chain_kernel", "tile_kernel",
    "seam_kernel", "flatten_kernel", "mkpl_kernel", "mkpl_setup_kernel",
    "mkpl_keys_kernel", "mkpl_splits_kernel", "seg_total_kernel",
    "carry_kernel", "fix_kernel", "blblur_arms", "blblur_fused",
    "quant_despeckle_kernel", "merge_mask_kernel", "despeckle2_kernel",
    "distinct_bids_kernel", "hyp_kernel", "pose_kernel"))


def kernel_base(name: str) -> str:
    """A device trace's kernel name without return type, namespaces,
    template and parameter lists: "(anonymous namespace)::tile_kernel(int
    const*, ...)" -> "tile_kernel"."""
    s = name.replace("(anonymous namespace)", "anon")
    cut = min((i for i in (s.find("<"), s.find("(")) if i >= 0),
              default=len(s))
    return s[:cut].split("::")[-1].split(" ")[-1] or "(unnamed)"


def is_port_kernel(name: str) -> bool:
    return "anonymous namespace" in name and kernel_base(name) in KERNELS


def bound_seconds(entry: str, args) -> float:
    """The least time of one call of `entry` with these arguments; 0 for an
    entry point the yardstick does not know."""
    f = ENTRIES.get(entry)
    if f is None:
        return 0.0
    nbytes, ops = f(args)
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
