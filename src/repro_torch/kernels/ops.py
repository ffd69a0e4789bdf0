"""Build and load of the CUDA kernel library, the public kernel wrappers,
and a launch counter per kernel.

Device contract
---------------
A wrapper launches its CUDA kernel for a tensor on a CUDA device and runs
the plain PyTorch version (``kernels.ref``) only for a tensor on the CPU,
which is how the CPU tests reach the same call sites.  It never falls back
from one to the other: a CUDA tensor the kernel does not take (dtype,
shape, layout) raises, and so does a tensor on any other device.

Build
-----
Each ``csrc/*.cu`` file has a plain C entry point.  At first use every
source is compiled by its own ``nvcc`` process, all started together, for
``sm_90a`` into ``build/repro_torch/<hash>/`` at the repository root, where
``<hash>`` covers the sources and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  ``ctypes`` loads the results.

Counters
--------
``launch_counts()`` reports how many times each wrapper launched its CUDA
kernel; the plain-version path does not count.  ``chip_smoke.py`` resets
them before it drives the main path and reads them after.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

from . import mla_attention, moe_gmm, rmsnorm as rmsnorm_kernel
from .mla_attention import flash_attention_cuda
from .moe_gmm import gmm_cuda
from .ref import flash_attention_ref, gmm_ref, rmsnorm_ref
from .rmsnorm import rmsnorm_cuda

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# wrapper name -> module holding the kernel's SOURCE, SYMBOL and ARGTYPES
KERNELS = {"rmsnorm": rmsnorm_kernel, "flash_attention": mla_attention,
           "gmm": moe_gmm}

_libs: Dict[str, ctypes.CDLL] = {}
_launches: Dict[str, int] = {name: 0 for name in KERNELS}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels in "
                       f"{CSRC} need the CUDA toolkit to build")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for mod in KERNELS.values():
        h.update(mod.SOURCE.encode())
        h.update((CSRC / mod.SOURCE).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_kernels() -> Dict[str, str]:
    """Compile every kernel source not yet built, one ``nvcc`` each, all in
    parallel.  Returns each compiler's output (ptxas register and
    shared-memory report) by kernel name; empty for one already built."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs, logs = {}, {}
    for name, mod in KERNELS.items():
        lib = out_dir / f"lib{Path(mod.SOURCE).stem}.so"
        if lib.exists():
            logs[name] = ""
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / mod.SOURCE)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_kernels()
        out_dir = build_dir()
        for kname, mod in KERNELS.items():
            lib = ctypes.CDLL(str(out_dir / f"lib{Path(mod.SOURCE).stem}.so"))
            fn = getattr(lib, mod.SYMBOL)
            fn.argtypes = mod.ARGTYPES
            fn.restype = ctypes.c_int
            _libs[kname] = lib
    return _libs[name]


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel and no plain version for device "
                     f"{t.device}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            gemma_style: bool = False) -> torch.Tensor:
    if not _on_cuda(x, "rmsnorm"):
        return rmsnorm_ref(x, scale, eps=eps, gemma_style=gemma_style)
    with torch.cuda.device(x.device):
        out = rmsnorm_cuda(_library("rmsnorm"), x, scale, eps=eps,
                           gemma_style=gemma_style)
    _launches["rmsnorm"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True) -> torch.Tensor:
    if not _on_cuda(q, "flash_attention"):
        return flash_attention_ref(q, k, v, scale=scale, causal=causal)
    with torch.cuda.device(q.device):
        out = flash_attention_cuda(_library("flash_attention"), q, k, v,
                                   scale=scale, causal=causal)
    _launches["flash_attention"] += 1
    return out


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, expert_map: torch.Tensor, *,
        block_m: int = 128) -> torch.Tensor:
    if not _on_cuda(lhs, "gmm"):
        return gmm_ref(lhs, rhs, expert_map, block_m=block_m)
    with torch.cuda.device(lhs.device):
        out = gmm_cuda(_library("gmm"), lhs, rhs, expert_map, block_m=block_m)
    _launches["gmm"] += 1
    return out


__all__ = ["rmsnorm", "flash_attention", "gmm", "build_kernels",
           "launch_counts", "reset_launch_counts"]
