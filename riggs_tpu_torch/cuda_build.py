"""Build and load the port's CUDA sources (no ``riggs_tpu`` counterpart).

Each source in ``csrc/`` is compiled on first use with nvcc for sm_90a into
``.torch_ext/`` beside the package, one shared library per source version
(keyed by a hash of the source and of any preprocessor defines, which
make a build of their own), with ptxas's report beside it (``.log``), and
loaded through ctypes with a plain C interface. ``build_all`` starts one
nvcc per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".torch_ext"


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels build with the CUDA toolkit")
    return path


def lib_path(src: Path, stem: str, defines: tuple[str, ...] = ()) -> Path:
    """Where the build of ``src``'s current version (with ``-D`` each of ``defines``) lives."""
    key = src.read_bytes() + "".join(f"\0-D{d}" for d in defines).encode()
    return BUILD_DIR / f"{stem}_{hashlib.sha256(key).hexdigest()[:12]}.so"


def build(src: Path, lib: Path, defines: tuple[str, ...] = ()):
    """Compile ``src`` for sm_90a (with ``-D`` each of ``defines``) into
    ``lib``, with ptxas's report beside it (``.log``)."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC", *(f"-D{d}" for d in defines), "-o", str(tmp), str(src),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} ({res.returncode}):\n{res.stderr}")
    lib.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)


def load(src: Path, stem: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The build of ``src`` with ``defines`` (made now if missing), loaded."""
    lib = lib_path(src, stem, defines)
    if not lib.exists():
        build(src, lib, defines)
    return ctypes.CDLL(str(lib))


def build_all(sources: dict[str, Path | tuple[Path, tuple[str, ...]]]):
    """Build every missing library of ``{stem: source}`` (or ``{stem:
    (source, defines)}``), one nvcc each, all started together."""
    jobs = []
    for stem, src in sources.items():
        src, defines = src if isinstance(src, tuple) else (src, ())
        lib = lib_path(src, stem, defines)
        if not lib.exists():
            jobs.append((src, lib, defines))
    if not jobs:
        return
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(build, *j) for j in jobs]:
            f.result()
