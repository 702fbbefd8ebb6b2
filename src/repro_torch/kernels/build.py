"""Build the hand-written CUDA kernels in ``csrc/`` on first use.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``_build/lib<name>-<hash>.so``, loaded with ctypes.  The hash
covers the source, every ``csrc/*.cuh`` header and the compiler flags, so
an edited source is rebuilt and an unchanged one is reused.  ``build_all``
starts one ``nvcc`` per source, all at once, and waits for every one.

Nothing here runs at import time: the CPU tests import the kernel modules
on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Compile every named source (default: all of ``csrc/*.cu``) whose
    library is missing, one ``nvcc`` each, in parallel.  Returns the
    library paths; raises with the compiler's output if one fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{out[n].stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {n}.cu exited {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, out[n])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The compiler's output (ptxas register and shared-memory lines) from
    the build of ``name``, or "" if it was built by an earlier process."""
    p = BUILD_DIR / f"{library_path(name).stem}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library; an
    observer (``repro_torch.obs``) counts each first load in the process
    (``kernel_builds``)."""
    lib = _LOADED.get(name)
    if lib is None:
        from repro_torch import obs as _obs
        _ob = _obs.get()
        if _ob.enabled:       # process-global cache: 0 in warm processes
            _ob.count("kernel_builds")
        path = build_all([name])[name]
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
