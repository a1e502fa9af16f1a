"""ctypes binding of the native C++ augmentation kernel, native/augment.cpp
(port of alignq_tpu/data/native_augment.py).

The port builds the source where it lies, with g++ and native/Makefile's
flags, into its own build directory (alignq_tpu_torch/_kernels_build/,
named by a hash of the source and the flags), never into native/. A build
happens only through an explicit call (`build()`: chip_smoke.py, the
training CLI's --native_augment) and a failed one raises. As in the JAX
package, `augment_normalize` and `normalize_only` take the library where
it exists (at `library`, which must then exist, or in the build
directory); otherwise numpy's path (data/augment.py), with the same draws
from the loader's RandomState (crop offsets oy, ox, then flips). The
registry takes the library only where its caller passes one
(data/registry.py get_data's native_library), so a build left behind
changes no later run's batches. The
native kernel folds /255 into its scale, one f32 multiply-add an element:
x * (1 / (255 std)) + (-mean / std) where numpy computes (x / 255 - mean) /
std, so its values differ from numpy's in the last few bits.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from alignq_tpu_torch.data import augment

SOURCE = Path(__file__).resolve().parents[2] / "native" / "augment.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_kernels_build"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall")  # native/Makefile
LDFLAGS = ("-shared", "-pthread")

_LIBS: Dict[str, ctypes.CDLL] = {}


@functools.lru_cache(maxsize=None)
def _tag() -> str:
    return hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS + LDFLAGS).encode()).hexdigest()[:16]


def library_path(out_dir=None) -> Path:
    """Where the library of this source and these flags is built."""
    return Path(out_dir or BUILD_DIR) / f"libaugment_{_tag()}.so"


def build(out_dir=None) -> Path:
    """Compile native/augment.cpp into out_dir (default the port's build
    directory) unless built there already; returns the library's path.
    Raises where g++ is missing or the compile fails."""
    out = library_path(out_dir)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native augment library cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, *LDFLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(library=None) -> Optional[ctypes.CDLL]:
    """The built library: at `library`, which must exist (else
    FileNotFoundError), or where None, the build directory's, or None
    where it has not been built."""
    path = Path(library) if library is not None else library_path()
    key = str(path)
    if key in _LIBS:
        return _LIBS[key]
    if not path.is_file():
        if library is not None:
            raise FileNotFoundError(f"no native augment library at {path}")
        return None
    lib = ctypes.CDLL(key)
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c_int = ctypes.c_int
    lib.augment_batch.argtypes = [u8p, f32p, c_int, c_int, c_int, c_int, i32p, i32p, u8p, f32p, f32p, c_int, c_int]
    lib.augment_batch.restype = None
    lib.normalize_batch.argtypes = [u8p, f32p, c_int, c_int, c_int, c_int, f32p, f32p, c_int]
    lib.normalize_batch.restype = None
    _LIBS[key] = lib
    return lib


def available(library=None) -> bool:
    """True where the library (at `library`, default the build
    directory's) has been built."""
    return Path(library if library is not None else library_path()).is_file()


def augment_normalize(x: np.ndarray, rng: np.random.RandomState, mean: np.ndarray, std: np.ndarray, pad: int = 4,
                      num_threads: int = 8, library=None) -> np.ndarray:
    """Fused crop+flip+normalize, uint8 NHWC -> float32 NHWC; numpy's path
    where no library is given and none is built."""
    lib = load(library)
    if lib is None:
        return augment.augment_normalize(x, rng, mean, std, pad)
    n, h, w, c = x.shape
    oy = rng.randint(0, 2 * pad + 1, n).astype(np.int32)
    ox = rng.randint(0, 2 * pad + 1, n).astype(np.int32)
    flip = (rng.rand(n) < 0.5).astype(np.uint8)
    out = np.empty((n, h, w, c), np.float32)
    lib.augment_batch(np.ascontiguousarray(x), out, n, h, w, c, oy, ox, flip, np.ascontiguousarray(mean, np.float32),
                      np.ascontiguousarray(std, np.float32), pad, num_threads)
    return out


def normalize_only(x: np.ndarray, mean: np.ndarray, std: np.ndarray, num_threads: int = 8,
                   library=None) -> np.ndarray:
    """(x / 255 - mean) / std, uint8 NHWC -> float32 NHWC; numpy's where
    no library is given and none is built."""
    lib = load(library)
    if lib is None:
        return augment.normalize(x, mean, std)
    n, h, w, c = x.shape
    out = np.empty((n, h, w, c), np.float32)
    lib.normalize_batch(np.ascontiguousarray(x), out, n, h, w, c, np.ascontiguousarray(mean, np.float32),
                        np.ascontiguousarray(std, np.float32), num_threads)
    return out
