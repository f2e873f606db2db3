"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  Libraries land in ``_build/`` beside this file (listed in
``.gitignore``), named by a hash of the source and flags, so an edited
source never loads a stale library.  Builds happen at first use, or all
at once through :func:`build` (one ``nvcc`` per source, started together).
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

__all__ = ["SOURCES", "build", "load", "function", "check", "stream",
           "require_cuda"]

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v"]

# source stem -> extra nvcc flags.  The epilogue kernels compile without FMA
# contraction: a fused multiply-add inside TwoSum changes its rounding.
SOURCES: Dict[str, list] = {
    "split_fused": ["--fmad=false"],
    "group_gemm": [],
    "scale_accum": ["--fmad=false"],
    "flash_attention": [],
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], Callable] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(_ARCH + _COMMON + SOURCES[name]).encode()
    digest = hashlib.sha256(src + b"\0" + flags).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None,
          verbose: bool = False) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` each, all started together.  Returns ``{name: seconds}`` for
    the ones compiled; raises with the compiler's output on failure."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.monotonic()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_ARCH, *_COMMON, *SOURCES[name], "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        seconds[name] = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
        if verbose:
            print(f"[build] {name}.cu in {seconds[name]:.1f}s\n{log}",
                  flush=True)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib


def function(lib: str, name: str, argtypes: List) -> Callable:
    """The C entry ``name`` of ``csrc/<lib>.cu`` with its argument types set
    (``c_void_p`` for every pointer and the stream: a bare Python int
    would be passed as a 32-bit int and cut the pointer)."""
    fn = _FNS.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(lib, name)] = fn
    return fn


def check(err: int, kernel: str) -> None:
    """Raise on the ``cudaGetLastError()`` code a C entry returned."""
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a raw handle (through
    PyTorch's raw-stream query where the build has it: a launch wrapper
    pays this on every call)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, kernel: str) -> None:
    """A wrapper's plain version serves CPU tensors only; anything else must
    be a CUDA tensor, for the kernel."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{kernel} runs on cuda (kernel) or cpu (plain "
                           f"version), not {t.device}")
