"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each source compiles on first use into ``<repo>/build/repro_torch/`` as a
shared library with a plain C interface, named by a hash of the source, the
headers beside it (``csrc/*.cuh``) and the compiler flags, so an edited
source or header is rebuilt and an unchanged one is loaded from the build
directory.  There is no fallback: without ``nvcc``
the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME, /usr/local/cuda): the "
        "CUDA kernels of repro_torch are built from source at first use and "
        "need the CUDA toolkit")


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built."""
    out = library_path(source)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)                 # atomic: concurrent builds agree
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; cached per process.
    Builds of different sources may run in parallel threads."""
    with _LOCK:
        lib = _LOADED.get(source)
    if lib is None:
        path = build(source)
        with _LOCK:
            lib = _LOADED.setdefault(source, ctypes.CDLL(str(path)))
    return lib


def load_all(sources: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Load several sources, with one ``nvcc`` per source, all started
    together (a source named twice is built once)."""
    sources = list(dict.fromkeys(sources))
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        return dict(zip(sources, pool.map(load, sources)))


def resource_usage(source: str) -> list:
    """What ptxas reports for each kernel of ``csrc/<source>``: dicts of
    ``kernel``, ``registers``, ``spill_stores`` and ``spill_loads`` (bytes).
    Compiles once more with ``-Xptxas -v`` into a temporary file, so the
    build directory and the loaded library are untouched."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(Path(tmp) / "probe.so"), str(CSRC / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    kernels, cur = [], None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            kernels.append(cur)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    demangle = shutil.which("cu++filt") or str(Path(find_nvcc()).parent / "cu++filt")
    if Path(demangle).is_file():
        names = subprocess.run([demangle], input="\n".join(k["kernel"] for k in kernels),
                               capture_output=True, text=True).stdout.splitlines()
        for k, name in zip(kernels, names):
            k["kernel"] = name
    return kernels


if __name__ == "__main__":
    # python -m repro_torch.kernels._build [source.cu ...]: registers and
    # spill bytes of every kernel, as ptxas reports them (default: all).
    for src in sys.argv[1:] or sorted(p.name for p in CSRC.glob("*.cu")):
        for k in resource_usage(src):
            print(f"{src}: {k['registers']} registers, {k['spill_stores']} B "
                  f"spill stores, {k['spill_loads']} B spill loads: {k['kernel']}")
