"""Build and bind the port's CUDA kernels.

All sources under rectdetect_tpu_torch/csrc/ compile with nvcc, one
process per source and all at once, and link into one shared library with
a plain C interface, loaded with ctypes.  The build
happens at the first kernel launch, into build/rectdetect_tpu_torch/<hash>/
at the root of the checkout (the hash covers the sources and the flags), so
a fresh checkout builds everything it needs and a rebuilt source never
loads a stale library.  Where that directory cannot be written, as in an
installed copy, the build raises and names it.

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
    "rd_edge_front": (_P, _P, _P, _I, _I, _P),
    "rd_thin": (_P, _P, _P, _I, _I, _I, _F, _P),
    "rd_strings_chain": (_P, _P, _P, _P, _I, _I, _I, _P),
    "rd_label_components": (_P, _P, _P, _I, _I, _I, _P),
    "rd_mkpl": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "rd_seg_scan": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "rd_blblur": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "rd_quant_despeckle": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "rd_merge_mask": (_P, _P, _I, _I, _P),
    "rd_label_merge": (_P, _P, _P, _P, _I, _I, _P),
    "rd_despeckle2": (_P, _P, _P, _I, _I, _I, _P),
    "rd_distinct_bids": (_P, _P, _I, _I, _P),
    "rd_hyp": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    "rd_pose": (_P, _P, _P, _P, _I, _F, _F, _F, _I, _I, _P),
}

_lib = None
build_seconds = None
# nvcc's report per source of the last verbose build (-Xptxas=-v: each
# kernel's registers, shared memory and spills)
ptxas_log: dict[str, str] = {}


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
    tag = os.getpid()
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
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
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


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point `name` on `device`'s current stream; raise on a
    nonzero cudaError_t."""
    fn = getattr(lib(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
