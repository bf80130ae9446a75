"""Build helper shared by the port's CUDA kernels.

Each kernel source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``<checkout>/build/kernels/<hash of source + flags>/``, and loaded
with ``ctypes``.  Nothing is compiled when a module is imported, and a
failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: per source, the registers and spills ptxas reported for each kernel in
#: this process's build: {source: {kernel: (registers, spill stores, spill
#: loads)}} (empty for a library that was already built)
RESOURCES: Dict[str, Dict[str, Tuple[int, int, int]]] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def local_headers(path: Path, seen=None) -> list:
    """The headers under ``csrc/`` that ``path`` includes with quotes,
    directly or through another such header, in first-seen order."""
    seen = [] if seen is None else seen
    for name in _INCLUDE.findall(path.read_bytes()):
        header = path.parent / name.decode()
        if header.exists() and header not in seen:
            seen.append(header)
            local_headers(header, seen)
    return seen


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` lands: a hash of the source,
    every local header it includes and the flags, so that an edited header
    builds a new library instead of loading a stale one."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes())
    for header in local_headers(src):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{src.stem}.so"


def compile_library(source: str) -> Tuple[Path, float]:
    """Compile ``csrc/<source>`` unless its library exists; returns the
    library's path and the seconds nvcc took (0.0 when already built)."""
    so = library_path(source)
    if so.exists():
        return so, 0.0
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    t0 = time.perf_counter()
    res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
                         capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {source}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees a partial file
    RESOURCES[source] = ptxas_resources(res.stdout + res.stderr)
    return so, seconds


def _demangle(sym: str) -> str:
    """``_ZN<ns><name>I<args>E...`` -> ``name<0,1>`` (enough for the
    kernels here: a nested name, bool or int template arguments, e.g.
    ``Lb1E`` -> 1 and ``Li4E`` -> 4)."""
    pos = 3 if sym.startswith("_ZN") else 2
    name = sym
    while pos < len(sym) and sym[pos].isdigit():
        m = re.match(r"\d+", sym[pos:])
        n = int(m.group(0))
        pos += len(m.group(0))
        name = sym[pos:pos + n]
        pos += n
    args = re.match(r"I((?:L[bij]n?\d+E)+)E", sym[pos:])
    if args:
        vals = re.findall(r"L[bij](n?)(\d+)E", args.group(1))
        name += "<" + ",".join(("-" if neg else "") + v for neg, v in vals) + ">"
    return name


def ptxas_resources(log: str) -> Dict[str, Tuple[int, int, int]]:
    """Registers and spill stores/loads of each kernel in ``ptxas -v``'s log."""
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _demangle(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spills)
            name, spills = None, (0, 0)
    return out


def compile_all(sources) -> Dict[str, float]:
    """Compile several sources at once, one nvcc process each; returns the
    nvcc seconds of each.  Raises if any build fails."""
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        futures = {s: pool.submit(compile_library, s) for s in sources}
        return {s: f.result()[1] for s, f in futures.items()}


def load(source: str, signatures: Dict[str, list]) -> Tuple[ctypes.CDLL, float]:
    """Build (once per hash) and load ``csrc/<source>``; every entry point
    in ``signatures`` gets its ctypes argtypes and an int return (the CUDA
    error code).  Returns the library and the seconds nvcc took."""
    so, seconds = compile_library(source)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, seconds
