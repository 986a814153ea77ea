"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` (Hopper)
into its own shared library with a plain C interface, loaded with
``ctypes``.  The sources build in parallel, one ``nvcc`` each, all
started together.  Libraries land in ``build/repro_torch_kernels/`` at
the repo root (``.gitignore`` lists ``build/``), named with a hash of
their source and of the shared headers (``csrc/*.cuh``), so an edited
kernel rebuilds and an unchanged one is reused.  ``nvcc`` runs with
``-Xptxas -v``: ``BUILD_LOGS`` keeps each fresh build's registers, shared
memory and spills per kernel, and ``sass_counts`` counts instructions in a
built library's SASS (``cuobjdump -sass``), e.g. the tensor-core ``HMMA``.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("flash_decode", "flash_attention", "flash_attention_bwd",
           "paged_decode", "quant_matmul", "quant_matmul_batched",
           "streamed_matmul")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}
BUILD_LOGS: Dict[str, str] = {}


def _tool(name: str) -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / name)] if home else []
    cands += [shutil.which(name) or "", f"/usr/local/cuda/bin/{name}"]
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError(f"{name} not found: set CUDA_HOME or put it on PATH "
                       f"to build the repro_torch CUDA kernels")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # the shared tile bodies
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every kernel whose library is missing, all in parallel;
    returns ``{name: library path}``.  Raises with nvcc's output if a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in KERNELS}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _tool("nvcc")
    t0 = time.perf_counter()
    procs = {}
    for name, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, p)
    errors = []
    for name, (proc, tmp, p) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, p)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def is_built(name: str) -> bool:
    """Whether kernel ``name``'s library for the current sources exists,
    so that ``library`` loads it without building."""
    return _lib_path(name).exists()


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for kernel ``name``, building every
    kernel on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            for n, p in build_all().items():
                _LIBS.setdefault(n, ctypes.CDLL(str(p)))
            lib = _LIBS[name]
        return lib


def sass_counts(name: str, opcodes: Iterable[str]) -> Dict[str, int]:
    """How many instructions of each opcode (``HMMA``, ``HGMMA``, ...) the
    built library of kernel ``name`` holds, from ``cuobjdump -sass``."""
    path = build_all()[name]
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def ptxas_summary(name: str) -> str:
    """One line from the ``-Xptxas -v`` report of kernel ``name``'s fresh
    build: its kernels, their register range and their spill bytes."""
    log = BUILD_LOGS.get(name, "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    if not regs:
        return f"{name}: no ptxas report (library reused)"
    spills = []   # (bytes, kernel) of each kernel that spills
    for block in log.split("Compiling entry function '")[1:]:
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      block)
        if m and int(m[1]) + int(m[2]):
            spills.append((int(m[1]) + int(m[2]), block.split("'", 1)[0]))
    line = (f"{name}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
            f"spill bytes (stores + loads) {sum(b for b, _ in spills)}")
    if spills:
        names = _demangle([k for _, k in spills])
        line += "; spilling: " + ", ".join(
            f"{n} {b} B" for (b, _), n in zip(spills, names))
    return line


def _demangle(names):
    """Kernel names without their parameter lists, demangled by
    ``cu++filt`` (mangled where it is missing)."""
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return list(names)
    if len(out) != len(names):
        return list(names)
    # "void k<(int)64, float>(float const*, ...)": cut at the parameters
    return [n[:n.find(">(") + 1] if ">(" in n else n for n in out]
