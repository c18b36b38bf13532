"""Build a CUDA source of ``csrc/`` into a shared library and load it with
ctypes.

Each source has a plain C interface and includes no PyTorch headers, so
``nvcc`` builds it in seconds. The library goes to ``_build/`` inside the
package (git-ignored), named by a digest of the source, the shared
headers and the flags, so an edited source or header is rebuilt and a
stale library is never loaded. Builds happen at first use, never at
import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"seconds": wall time from the start of the build call until
#          this library was built (0.0 when loaded from _build/),
#          "log": nvcc's stderr, which carries ptxas's register and
#          spill report}
BUILD_INFO = {}


def nvcc_path():
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda."""
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "paddle_tpu_torch are built from source at first use")


def _flags(defines):
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _target(name, source, defines=()):
    """(source path, library path) of ``csrc/<source>``: the library is
    named by a digest of the source, the shared headers of ``csrc/`` and
    the flags."""
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes()
                       for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers +
                            " ".join(_flags(defines)).encode()
                            ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(sources, defines=()):
    """Build every library of ``{name: source}`` that is not in ``_build/``
    yet, one nvcc process per source, all started together, and wait for
    all of them; ``defines`` (``NAME`` or ``NAME=VALUE``) go to every
    source's nvcc as ``-D``. Raises with nvcc's output when a build fails;
    no process outlives the call."""
    t0 = time.perf_counter()
    procs = {}
    try:
        for name, source in sources.items():
            src, lib = _target(name, source, defines)
            if lib.exists():
                continue
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *_flags(defines), "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True), src, tmp, lib)
        for name, (proc, src, tmp, lib) in procs.items():
            out, err = proc.communicate()
            log = out + err
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {src.name} failed "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, lib)
            BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                                "log": log, "path": str(lib)}
    finally:
        for proc, _, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)


def load_library(name, source, defines=()):
    """Build ``csrc/<source>`` (if its digest is not in ``_build/`` yet)
    and return the loaded ``ctypes.CDLL``. Raises with nvcc's output when
    the build fails."""
    build_all({name: source}, defines)
    _, lib = _target(name, source, defines)
    handle = ctypes.CDLL(str(lib))
    BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "",
                                 "path": str(lib)})
    return handle
