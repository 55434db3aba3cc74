"""Build the CUDA sources of ``xfmamba_tpu_torch/csrc`` and bind them.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with ``ctypes``.  The build runs at
first use, into ``xfmamba_tpu_torch/_build/`` (listed in ``.gitignore``),
under a name keyed on a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.

Every C entry point returns ``cudaGetLastError()``; `check` turns a non-zero
status into an exception.  Pointers and the stream are ``c_void_p``: the
stream is ``torch.cuda.current_stream().cuda_stream``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# name -> argtypes of the C entry points that return an int: a cudaError_t
# (xfm_vss_block_v1_grid: a block count, or a negated cudaError_t;
# xfm_fusion_scan_smem: bytes of shared memory)
_SIGNATURES = {
    "xfm_gemm": [_P] * 6 + [_LL, _I, _I] + [_LL] * 5 + [_I] * 6 + [_P],
    "xfm_gemm_tc": [_P] * 6 + [_LL, _I, _I] + [_LL] * 6 + [_I] * 10 + [_P],
    "xfm_layer_norm": [_P, _P, _P, _P, _LL, _I, _I, _I, ctypes.c_float, _P],
    "xfm_dwconv3_silu": [_P] * 5 + [_I] * 5 + [_P],
    "xfm_selective_scan": [_P] * 11 + [_I] * 15 + [_P],
    "xfm_layer_norm_bwd": [_P] * 7 + [_LL, _I, _I, ctypes.c_float, _P],
    "xfm_dwconv3_silu_bwd": [_P] * 8 + [_I] * 5 + [_P],
    "xfm_selective_scan_bwd": [_P] * 18 + [_I] * 17 + [_P],
    "xfm_ss2d_n1_fwd": [_P] * 9 + [_I] * 15 + [_P],
    "xfm_ss2d_n1_bwd": [_P] * 18 + [_I] * 14 + [_P],
    "xfm_ss2d_n1_fwd_v1": [_P] * 9 + [_I] * 12 + [_P],
    "xfm_ss2d_n1_bwd_v1": [_P] * 16 + [_I] * 13 + [_P],
    "xfm_grouped_scan_fwd": [_P] * 9 + [_I] * 9 + [_P],
    "xfm_grouped_scan_bwd": [_P] * 20 + [_I] * 9 + [_P],
    "xfm_grouped_scan_fwd_v1": [_P] * 9 + [_I] * 8 + [_P],
    "xfm_grouped_scan_bwd_v1": [_P] * 17 + [_I] * 8 + [_P],
    "xfm_ssd_chunk_state": [_P] * 7 + [_I] * 8 + [_P],
    "xfm_ssd_state_pass": [_P] * 4 + [_LL, _I, _I, _I, _P],
    "xfm_ssd_chunk_scan": [_P] * 9 + [_I] * 7 + [_P],
    "xfm_ssd_chunk_grads": [_P] * 17 + [_I] * 7 + [_P],
    "xfm_ssd_fwd_serial": [_P] * 11 + [_I] * 7 + [_P],
    "xfm_ssd_bwd_serial": [_P] * 18 + [_I] * 7 + [_P],
    "xfm_scan_two_level": [_P] * 11 + [_I] * 17 + [_P],
    "xfm_fused_cross_scan": [_P] * 9 + [_I] * 7 + [_P],
    "xfm_nk_scan_v4": [_P] * 9 + [_I] * 8 + [_P],
    "xfm_nk_scan_v3": [_P] * 9 + [_I] * 11 + [_P],
    "xfm_ln_act": [_P] * 4 + [_LL, _I, _I, ctypes.c_float, _I, _P],
    "xfm_seg_ln_fwd": [_P] * 4 + [_LL, _I, _I, _I, ctypes.c_float, _I, _P],
    "xfm_seg_ln_bwd": [_P] * 7 + [_LL, _I, _I, _I, _I, ctypes.c_float, _I, _P],
    "xfm_vss_block_v1": [_P] * 23 + [_I] * 9 + [_P],
    "xfm_vss_block_v1_grid": [_I],
    "xfm_nk_scan_adjoint": [_P] * 20 + [_I] * 10 + [_P],
    "xfm_fusion_scan": [_P] * 11 + [_I] * 13 + [_P] * 3,
    "xfm_fusion_scan_smem": [_I] * 8,
}
# entry points that return something other than a cudaError_t
_RESTYPES = {"xfm_vss_block_v1_workspace": ([_LL] + [_I] * 5, ctypes.c_longlong)}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels of xfmamba_tpu_torch "
                           "need the CUDA toolkit (nvcc on PATH or /usr/local/cuda)")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC_DIR.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"libxfm_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the sources unless a library for them exists already.

    Returns the library's path and the compiler's output (``-Xptxas -v``:
    registers, shared memory and spills of each kernel)."""
    so = library_path()
    log = so.with_suffix(".log")
    if so.exists():
        return so, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    tmp = so.with_name(f"{tag}.so.tmp")
    try:
        for cmd, proc, out in zip(cmds, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
        link = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(link)}):\n{proc.stdout}{proc.stderr}")
        text = "".join(outs) + proc.stdout + proc.stderr
        log.write_text(text)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so, text


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, (argtypes, restype) in _RESTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.xfm_error_string.argtypes = [ctypes.c_int]
    lib.xfm_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = library().xfm_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
