"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes` — no PyTorch
headers, so a build takes seconds. Builds happen at first use, never at
import: the CPU test suite imports every module on a host with no
``nvcc``. Libraries land in ``_build/`` inside the package (listed in
``.gitignore``), named by a digest of their sources and flags, so an
edited source rebuilds and an unchanged one loads the existing library.
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
from typing import Dict, Iterable, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# library name -> its .cu source; every library also depends on the
# shared headers.
SOURCES: Dict[str, str] = {
    "fused_mlp": "fused_mlp.cu",
    "fused_mlp_bwd": "fused_mlp_bwd.cu",
    "fused_mlp_core": "fused_mlp_core.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "scan_scores": "scan_scores.cu",
}
_HEADERS = ("vit_common.cuh", "hopper.cuh", "mlp_common.cuh", "mlp_fwd.cuh",
            "mlp_bwd.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build seconds (0.0 when reused), "log": nvcc output}
BUILD_LOG: Dict[str, dict] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``,
    or ``nvcc`` on ``PATH``; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from csrc/ at first use")
    return found


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for the current sources and flags."""
    h = hashlib.sha256()
    for part in (SOURCES[name],) + _HEADERS:
        h.update(part.encode())
        h.update((CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the libraries that are missing, one ``nvcc`` per source,
    all started together; returns ``{name: {"seconds", "log", "path"}}``.
    Raises RuntimeError with the compiler output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if path.is_file():
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "log": "",
                                        "path": str(path)})
            continue
        tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, path)
    failures = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- nvcc {SOURCES[name]} (exit "
                            f"{proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, path)
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log,
                           "path": str(path)}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return {n: BUILD_LOG[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.is_file():
                build([name])
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib


def check_aligned(*tensors, align: int = 16) -> None:
    """Raise unless every tensor starts on an ``align``-byte boundary,
    whatever its dtype (the MLP kernels read bf16 operands through TMA and
    f32 operands with 16-byte vector loads)."""
    if any(t.data_ptr() % align for t in tensors):
        raise ValueError(f"kernel operands must be {align}-byte aligned")


def check_tma(*tensors) -> None:
    """Raise unless every tensor is 16-byte aligned when they are bf16: the
    bf16 kernels read their operands through TMA, which takes no other
    alignment (the f32 SIMT flash kernels take any)."""
    if tensors[0].dtype == torch.bfloat16:
        check_aligned(*tensors)


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaError_t); the "
                           "launch was refused or failed")
