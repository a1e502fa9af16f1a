"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface; the `csrc/*.cuh`
headers hold device code that several sources share. At first use it is
compiled with nvcc for sm_90a into a shared library under
`alignq_tpu_torch/_kernels_build/` (listed in .gitignore) and loaded with
ctypes. A build failure raises; nothing falls back. `build_all()` starts
one nvcc per source at once, so the sources build in parallel.

Every C entry point returns `cudaGetLastError()` after its launch;
`check()` raises if that is not 0. `launches` counts each kernel launch by
kernel name; the wrappers increment it where they launch, and nowhere else.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("qmatmul", "qmatmul_sm90", "qmatmul_sm90n", "qmatmul_sm90p", "quantize", "stage_kernel",
           "stage_kernel_sm90", "dwconv", "stem_sm90", "dwconv_sm90", "bn_table_sm90", "digit_sm90", "first_conv_sm90",
           "cdf_quant_sm90")

launches: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    """The library's path, keyed by the source, every shared header
    (csrc/*.cuh, which a source may include) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.name.encode() + h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source not yet built, all nvcc processes at
    once; return each one's compiler report (-Xptxas -v)."""
    reports: Dict[str, str] = {}
    with _lock:
        pending = []
        for name in names:
            if name in _libs or _target(name).exists():
                continue
            pending.append((name, *_start(name)))
        for name, proc, tmp, out in pending:
            log, _ = proc.communicate()
            reports[name] = log
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, out)
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def on_device(device):
    """The context a launch on `device` needs: none where it is the
    current device already (a device switch costs microseconds a launch)."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
