"""Build and bind the port's CUDA kernels.

All sources under rectdetect_tpu_torch/csrc/ compile with nvcc, one
process per source and all at once, and link into one shared library with
a plain C interface, loaded with ctypes.  The build
happens at the first kernel launch, into build/rectdetect_tpu_torch/<hash>/
at the root of the checkout (the hash covers the sources and the flags), so
a fresh checkout builds everything it needs and a rebuilt source never
loads a stale library.  Where that directory cannot be written, as in an
installed copy, the build raises and names it.

The library is built and loaded once, under a lock, and every counter
below changes under a lock: the per-device worker threads of
dist/stream.py launch kernels from several threads of one process.

`--fmad=false` stops nvcc from fusing multiply-adds of its own accord: the
kernels fuse exactly where the jitted JAX reference does, with explicit
fmaf (ops/fp.py).  The default -prec-div/-prec-sqrt keep division and sqrt
correctly rounded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "rectdetect_tpu_torch"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "--fmad=false", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
NVCC_FLAGS = COMPILE_FLAGS + LINK_FLAGS

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types (pointers, ints, float, stream)
SIGNATURES = {
    "rd_edge_front": (_P, _P, _P, _I, _I, _I, _P),
    "rd_thin": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    "rd_strings_chain": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "rd_label_components": (_P, _P, _I, _I, _I, _P),
    "rd_mkpl": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "rd_mkpl_setup": (_P,) * 8 + (_I,) * 9 + (_P,),
    "rd_mkpl_keys": (_P,) * 8 + (_I,) * 9 + (_P,),
    "rd_mkpl_splits": (_P,) * 8 + (_I,) * 9 + (_P,),
    "rd_seg_scan": (_P, _P, _P, _P, _I, _I, _I, _P),
    "rd_seg_total": (_P, _P, _P, _P, _I, _I, _P),
    "rd_blblur": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "rd_quant_despeckle": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "rd_merge_mask": (_P, _P, _I, _I, _I, _I, _I, _P),
    "rd_label_merge": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "rd_despeckle2": (_P, _P, _P, _I, _I, _I, _I, _P),
    "rd_distinct_bids": (_P, _P, _I, _I, _P),
    "rd_hyp": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    "rd_pose": (_P, _P, _P, _P, _I, _F, _F, _F, _I, _I, _P),
}
# entry points that launch nothing: name -> (argument types, result type)
QUERIES = {
    "rd_launch_count": ((), ctypes.c_longlong),
    "rd_mkpl_scratch_words": ((_I, _I), ctypes.c_int),
    "rd_seg_scan_scratch_words": ((_I,), ctypes.c_int),
    "rd_seg_total_scratch_words": ((_I,), ctypes.c_int),
}

_lib = None
build_seconds = None
# nvcc's report per source of the last verbose build (-Xptxas=-v: each
# kernel's registers, shared memory and spills)
ptxas_log: dict[str, str] = {}
# kernel launches per entry point as the wrappers state them (the
# `kernels` argument of launch); chip_smoke.py holds their sum equal to
# the library's own count, launch_count()
expected_kernels: dict[str, int] = {}
# the build and the load (reentrant: lib() builds under it)
_lib_lock = threading.RLock()
# expected_kernels and the wrappers' module counters (count)
_count_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "librectdetect_kernels.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library path."""
    with _lib_lock:
        return _build(verbose)


def _build(verbose: bool) -> Path:
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise RuntimeError(f"cannot create the kernel build directory "
                           f"{out.parent}: {e}") from e
    if not os.access(out.parent, os.W_OK):
        raise RuntimeError(f"the kernel build directory {out.parent} is not "
                           "writable; run the port from a writable checkout")
    # object names unique to this process and thread: other processes may
    # build the same directory at once
    tag = f"{os.getpid()}.{threading.get_ident()}"
    nvcc = _nvcc()
    extra = ["-Xptxas=-v"] if verbose else []
    t0 = time.perf_counter()
    # one nvcc per source, all at once, then one link
    objs, procs = [], []
    for src in sources():
        obj = out.parent / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *extra, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for src, proc in zip(sources(), procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name} ({proc.returncode}):\n{err}")
        elif verbose and err:
            ptxas_log[src.name] = err
            print(f"{src.name}:\n{err}")
    tmp = out.with_suffix(f".{tag}.tmp")
    if not errors:
        res = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            errors.append(f"link ({res.returncode}):\n{res.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            for name, (args, res) in QUERIES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(args)
                fn.restype = res
            _lib = handle
    return _lib


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on one CUDA device, False if every tensor is
    on the CPU; anything else raises (no silent host fallback)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors on unsupported devices: "
                     f"{sorted(str(t.device) for t in tensors)}")


def check(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless t is a contiguous CUDA tensor of this dtype and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


# the largest frame count of a batch-form launch (gridDim.z)
MAX_FRAMES = 65535


def frames(lead: tuple, name: str) -> int:
    """The frame count of a batch-form kernel's input with leading shape
    `lead`: () for one frame, (B,) for B frames, 1 <= B <= MAX_FRAMES."""
    if lead == ():
        return 1
    if len(lead) != 1 or not 1 <= lead[0] <= MAX_FRAMES:
        raise ValueError(f"{name}: expected one frame or a leading axis of "
                         f"1..{MAX_FRAMES} frames, got {lead}")
    return lead[0]


def frame_stack(t: torch.Tensor, name: str, dtype) -> tuple:
    """(lead, b, h, w) of a batch-form kernel's (H,W) or (B,H,W) map,
    checked as check() does: lead is () or (B,), b the frame count."""
    if t.dim() < 2:
        raise ValueError(f"{name}: expected an (H,W) or (B,H,W) map, got "
                         f"{tuple(t.shape)}")
    lead = tuple(t.shape[:-2])
    h, w = t.shape[-2:]
    b = frames(lead, name)
    check(t, name, dtype, (*lead, h, w))
    return lead, b, h, w


def frame_columns(b: int, x0: int, w_total, w: int) -> tuple[int, int]:
    """(x0, the frame's width) of a kernel's offset form; the offset form
    takes one frame (the width-tiled path), so b > 1 refuses an offset."""
    if b > 1 and (x0 != 0 or w_total is not None):
        raise ValueError("x0 and w_total are the width-tiled path's offset "
                         f"form, which takes one frame, not {b}")
    return int(x0), w if w_total is None else int(w_total)


def launch(name: str, device: torch.device, *args, kernels: int = 1) -> None:
    """Call C entry point `name` on `device`'s current stream; raise on a
    nonzero cudaError_t.  `kernels`: the launches the entry makes for these
    arguments, added to expected_kernels."""
    fn = getattr(lib(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    with _count_lock:
        expected_kernels[name] = expected_kernels.get(name, 0) + kernels


def count(namespace: dict, name: str) -> None:
    """Add one to the counter `name` of a wrapper module (its globals()),
    under the counters' lock."""
    with _count_lock:
        namespace[name] += 1


def launch_count() -> int:
    """Kernels launched by the library so far, by its own counter (every
    entry point counts each kernel it launches)."""
    return lib().rd_launch_count()
