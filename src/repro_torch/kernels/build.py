"""Build and load the port's Hopper kernels.

Each ``csrc/*.cu`` file has a plain C interface.  At the first CUDA use,
``nvcc`` compiles every source into its own shared library under
``build/repro_torch_kernels/`` at the repository root (all compilers started
together), and ``ctypes`` loads them.  Nothing is built when a module is
imported: the CPU tests import every module of the port.

Libraries are named by a hash of their sources, the shared headers and the
flags, so an edited source or header rebuilds and an unchanged one is
reused.  A missing ``nvcc`` or a
failed build raises; there is no fallback.
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
from typing import Dict, List, Optional, Tuple

__all__ = ["library", "build_all", "build_report", "BUILD_DIR", "CSRC",
           "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int

# library -> (source, {symbol: (restype, argtypes)})
_KERNELS: Dict[str, Tuple[str, Dict[str, Tuple[object, List[object]]]]] = {
    "cache_combine": ("cache_combine.cu", {
        "cache_combine_f32": (_I, [_P, _P, _P, _P, _P, _I64, _I64, _P]),
        "cache_combine_bf16": (_I, [_P, _P, _P, _P, _P, _I64, _I64, _P]),
        "cache_combine_pipelined_f32": (_I, [_P, _P, _P, _P, _P, _I64, _I64,
                                             _I, _P]),
        "cache_combine_pipelined_bf16": (_I, [_P, _P, _P, _P, _P, _I64,
                                              _I64, _I, _P]),
        "cache_combine_legacy_f32": (_I, [_P, _P, _P, _P, _P, _I64, _I64,
                                          _P]),
        "cache_combine_legacy_bf16": (_I, [_P, _P, _P, _P, _P, _I64, _I64,
                                           _P]),
        "cache_combine_error_string": (ctypes.c_char_p, [_I]),
    }),
    "cache_update": ("cache_update.cu", {
        "cache_update_f32": (_I, [_P, _P, _P, _I64, _I64, _P]),
        "cache_update_bf16": (_I, [_P, _P, _P, _I64, _I64, _P]),
        "cache_update_pipelined_f32": (_I, [_P, _P, _P, _I64, _I64, _I64,
                                            _I, _P]),
        "cache_update_pipelined_bf16": (_I, [_P, _P, _P, _I64, _I64, _I64,
                                             _I, _P]),
        "cache_update_error_string": (ctypes.c_char_p, [_I]),
    }),
    "fused_update": ("fused_update.cu", {
        "fused_update_f32": (_I, [_P] * 8 + [_I64, _I64, _I64, _I, _P]),
        "fused_update_error_string": (ctypes.c_char_p, [_I]),
    }),
    "flash_attention": ("flash_attention.cu", {
        "flash_attention_f32": (_I, [_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                     _I, _I64, _P]),
        "flash_attention_bf16": (_I, [_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                      _I, _I64, _P]),
        "flash_attention_error_string": (ctypes.c_char_p, [_I]),
    }),
    "segment_sum": ("segment_sum.cu", {
        "segment_sum_f32": (_I, [_P, _P, _P, _I64, _I64, _I, _P]),
        "segment_sum_bf16": (_I, [_P, _P, _P, _I64, _I64, _I, _P]),
        "segment_sum_error_string": (ctypes.c_char_p, [_I]),
    }),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_report: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, "
                           "/usr/local/cuda and PATH): the port's CUDA "
                           "kernels cannot be built")
    return found


def _target(name: str) -> Path:
    src, _ = _KERNELS[name]
    h = hashlib.sha256()
    for part in (CSRC / src, *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for sym, (restype, argtypes) in _KERNELS[name][1].items():
        fn = getattr(lib, sym)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel, one ``nvcc`` per source) whatever is not built
    yet, load every library, and return them by name."""
    with _lock:
        if len(_libs) == len(_KERNELS):
            return dict(_libs)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs: Dict[str, Tuple[subprocess.Popen, Path, Path]] = {}
        nvcc: Optional[str] = None
        for name, (src, _) in _KERNELS.items():
            out = _target(name)
            if out.exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        logs: Dict[str, str] = {}
        failed: List[str] = []
        for name, (proc, tmp, out) in procs.items():
            text, _ = proc.communicate()
            logs[name] = text
            if proc.returncode != 0:
                failed.append(f"{name} (exit {proc.returncode}):\n{text}")
                continue
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(text)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in _KERNELS:
            _libs[name] = _bind(name, _target(name))
        _report.update(seconds=time.perf_counter() - t0,
                       compiled=sorted(procs), nvcc=nvcc, logs=logs,
                       build_dir=str(BUILD_DIR))
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building everything on first use)."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]


def build_report() -> Dict[str, object]:
    """What the last ``build_all`` did: seconds, which sources it compiled,
    and each compiler's output (``-Xptxas -v``: registers, shared memory,
    spills per kernel)."""
    with _lock:
        return dict(_report)
