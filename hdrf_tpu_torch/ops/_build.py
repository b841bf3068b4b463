"""Build and bind the port's CUDA kernels (``csrc/*.cu``): the counterpart
of the native library's build and load in hdrf_tpu/native/__init__.py:34-45
(``make`` at first use, then ``ctypes.CDLL``).

Each source compiles with ``nvcc`` for ``sm_90a`` into an object file, all
started together, and the objects link into one shared library with a
plain C interface, ``build/hdrf_tpu_torch/libhdrf_kernels.so`` at the
repository root, bound with ctypes (pointers and the stream as
``c_void_p``).  The build runs at first use and again whenever a source is
newer than the library; it never runs at import, so the CPU tests import
every module without ``nvcc``.  Every C entry point enqueues on the stream
it is given, allocates nothing, and returns ``cudaGetLastError()``;
``launch`` calls one with its tensors' device current, so a kernel runs
on whichever card its inputs lie on.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hdrf_tpu_torch"
SO = BUILD_DIR / "libhdrf_kernels.so"
BUILD_LOG = BUILD_DIR / "nvcc.log"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I64, _I32, _U32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                        ctypes.c_uint32)
# C entry points: name -> argtypes (all return int = cudaError_t).
_SIGNATURES = {
    # data, n_pad, n, mask, min, words, bitmap, stream
    "hdrf_cdc_scan": [_P, _I64, _I64, _U32, _I64, _P, _P, _P],
    # bitmap, nbm, n, min, max, b_small, table, ols, olb, cap, seg_width,
    # scratch, stream
    "hdrf_cdc_select": [_P, _I64, _I64, _I64, _I64, _I32, _P, _P, _P, _I64,
                        _I64, _P, _P],
    # data, n_pad, words, stream
    "hdrf_be_image": [_P, _I64, _P, _P],
    # local, halo, m, base, mask, words, count, stream
    "hdrf_cdc_shard_scan": [_P, _P, _I64, _I64, _U32, _P, _P, _P],
    # words, nw, offs, lens, L, W, out, stream
    "hdrf_gather_pad": [_P, _I64, _P, _P, _I64, _I32, _P, _P],
    # words, nw, offs, L, W, bytes, out, stream
    "hdrf_gather_raw": [_P, _I64, _P, _I64, _I32, _I32, _P, _P],
    # per lane table (two): msgs, L, W, nblocks, order, out; then the
    # unit counter, stream
    "hdrf_sha256": [_P, _I64, _I32, _P, _P, _P] * 2 + [_P, _P],
    # x, y, z, iters, out, cycles, stream
    "hdrf_sha_chain_probe": [_U32, _U32, _U32, _I32, _P, _P, _P],
    # vals, t, e, stride, out, scratch, stream
    "hdrf_match_deltas": [_P, _I64, _I64, _I32, _P, _P, _P],
    # key, v0, v1, n_val, t, e, E, unsigned, pad_key, pad_v0, pad_v1,
    # key_out, v0_out, v1_out, key_scr, v0_scr, v1_scr, stream
    "hdrf_sort_rows": [_P, _P, _P, _I32, _I64, _I64, _I64, _I32, _U32, _U32,
                       _U32, _P, _P, _P, _P, _P, _P, _P],
    # in, in_stride, k, out, out_stride, nrows, L, coef (host), stream
    "hdrf_rs_apply": [_P, _I64, _I32, _P, _I64, _I32, _I64, _P, _P],
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    return str(cand) if cand.exists() else None


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def build() -> Path:
    """Compile every source in parallel, then link; returns the library
    path.  Raises with nvcc's output on a compile error."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *ARCH, "-std=c++17", "-O3", "-Xptxas", "-v",
             "-Xcompiler", "-fPIC", "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for src, p in zip(_sources(), procs):
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode:
            failed.append(src.name)
    BUILD_LOG.write_text("".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(logs))
    tmp = SO.with_name(f"{SO.name}.{tag}.tmp")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, SO)  # atomic: a concurrent loader never sees half a file
    return SO


def _stale() -> bool:
    if not SO.exists():
        return True
    built = SO.stat().st_mtime
    return any(s.stat().st_mtime > built for s in _sources())


def library() -> ctypes.CDLL:
    """The bound kernel library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(str(SO))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_handle(device) -> int:
    """Raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, device, *args, what: str) -> None:
    """Call the C entry point ``name`` with ``args`` and PyTorch's current
    stream on ``device``, that device current (a launch goes to the
    current device's context); raise on a CUDA error."""
    import torch

    fn = getattr(library(), name)
    with torch.cuda.device(device):
        check(fn(*args, stream_handle(device)), what)
