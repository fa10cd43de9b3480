"""Build the package's CUDA sources into shared libraries.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use with ``nvcc`` for ``sm_90a`` into ``sprs_tpu_torch/_build/``
(listed in ``.gitignore``), under a name that carries a hash of the
source and of the shared headers (``csrc/*.cuh``, on the include path),
so an edited source or header is rebuilt and a stale library never
loads.  ``launch.py`` loads the libraries and binds their entries.
Nothing here runs at import time.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler=-fPIC",
    "-Xptxas=-v",
)

SOURCES = ("dia_spmv", "dia_spmm", "bsr_spmm", "ell_spmv", "sort_rows", "csr_spmv", "krylov")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output: ptxas register and spill counts


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def headers() -> bytes:
    """The shared headers' text, in name order: part of every source's
    hash, since any source may include them."""
    return b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))


def nvcc_command(source: Path, out: Path) -> list:
    return [_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", str(out), str(source)]


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes() + headers()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, BuildInfo]:
    """Compile every named source that is not built yet, one ``nvcc``
    per source, all started together.  Raises RuntimeError on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = BuildInfo(name, path, 0.0, "")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(CSRC_DIR / f"{name}.cu", tmp)
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, path, tmp, proc, time.perf_counter()))
    for name, path, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, path)
        out[name] = BuildInfo(name, path, seconds, log)
    return out


def ptxas_report(log: str) -> List[Tuple[str, int, int, int]]:
    """(kernel, registers, spill store bytes, spill load bytes) for each
    kernel instantiation in nvcc's ``-Xptxas=-v`` output, the names
    demangled by ``cu++filt`` where the toolkit has it."""
    spills, regs, current = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) or re.search(
            r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            spills[current] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            regs[current] = int(m.group(1))
    names = list(regs)
    shown = names
    filt = Path(_nvcc()).with_name("cu++filt") if names else None
    if filt is not None and filt.exists():
        out = subprocess.run([str(filt)], input="\n".join(names), capture_output=True, text=True).stdout
        shown = out.splitlines() if len(out.splitlines()) == len(names) else names
    return [(show, regs[n], *spills.get(n, (0, 0))) for n, show in zip(names, shown)]
