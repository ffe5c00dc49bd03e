"""Build ``csrc/*.cu`` with nvcc into plain-C shared libraries, load them with ctypes.

Each source compiles at first use into ``_build/lib<stem>-<hash>.so`` (the
hash covers the source, the shared ``csrc/*.cuh`` headers and the flags, so
an edit rebuilds).  All sources
start compiling together, one nvcc process each.  A failed build raises with
nvcc's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures of every entry point, by source stem (restype is int:
#: the cudaError_t of the launches)
SIGNATURES = {
    "blocks": {
        "iek_light53_block": [_P] * 12 + [_I] * 4 + [_F, _F, _P],
        "iek_light_block": [_P] * 7 + [_I] * 4 + [_F, _P],
        "iek_light53_block_bf16": [_P] * 12 + [_I] * 4 + [_F, _F, _P],
        "iek_light_block_bf16": [_P] * 7 + [_I] * 4 + [_F, _P],
    },
    "int8_blocks": {
        "iek_light53_int8": [_P] * 17 + [_I] * 5 + [_F, _F, _P],
        "iek_light_int8": [_P] * 10 + [_I] * 5 + [_F, _P],
        "iek_light53_int8_dynamic": [_P] * 19 + [_I] * 9 + [_F, _F, _P],
        "iek_light_int8_dynamic": [_P] * 11 + [_I] * 9 + [_F, _P],
        "iek_light53_int8_xla_dyn": [_P] * 19 + [_I] * 5 + [_F, _F, _P],
        "iek_light53_int8_xla_dyn_step": [_I] + [_P] * 19 + [_I] * 9 + [_F, _F, _P],
    },
    "int8_conv": {
        "iek_int8_conv3x": [_P, _I, _P, _P, _I] + [_P] * 5 + [_I] + [_P] * 4 + [_I] * 9 + [_F, _P],
        "iek_light53_int8_xla": [_P] * 17 + [_I] * 5 + [_F, _F, _P],
        "iek_light_int8_xla": [_P] * 10 + [_I] * 5 + [_F, _P],
        "iek_light53_int8_xla_upq": [_P] * 19 + [_I] * 6 + [_F, _F, _P],
    },
    "upsample": {
        "iek_upsample_phase_tf1": [_P, _P] + [_I] * 6 + [_P, _P],
        "iek_upsample_quant_tf1": [_P, _P] + [_I] * 5 + [_P, _P, _P],
    },
    "tower": {
        "iek_light53_chain": [_P] * 13 + [_I] * 5 + [_F, _F, _P],
        "iek_light_chain": [_P] * 8 + [_I] * 5 + [_F, _P],
        "iek_light53_chain_bf16": [_P] * 13 + [_I] * 5 + [_F, _F, _P],
        "iek_light_chain_bf16": [_P] * 8 + [_I] * 5 + [_F, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register and spill report), by stem
build_log: dict[str, str] = {}


def nvcc_path() -> str:
    """The nvcc binary: ``$CUDA_HOME/bin``, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc") if home else "",
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of image_enhance_keras_tpu_torch cannot be built"
    )


def _target(stem: str) -> str:
    """The library's path; its hash covers the source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [os.path.join(CSRC, f"{stem}.cu"), *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` not yet built, in parallel; stem -> .so path."""
    stems = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(CSRC, "*.cu")))
    todo = {s: _target(s) for s in stems}
    pending = {s: t for s, t in todo.items() if not os.path.exists(t)}
    if pending:
        nvcc = nvcc_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for s, t in pending.items():
            tmp = f"{t}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{s}.cu")]
            procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for s, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            build_log[s] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed on csrc/{s}.cu (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, pending[s])
        if failed:
            raise RuntimeError("\n".join(failed))
    return todo


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` with its argtypes declared."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(build_all()[stem])
            for name, argtypes in SIGNATURES[stem].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.iek_error_string.argtypes = [ctypes.c_int]
            lib.iek_error_string.restype = ctypes.c_char_p
            _libs[stem] = lib
        return lib


def check_aligned(*tensors) -> None:
    """What only real device memory can show: the kernels take 16-byte
    aligned tensors (None, an absent optional tensor, passes)."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the CUDA kernels take 16-byte aligned tensors")


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.iek_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {code} ({msg})")
