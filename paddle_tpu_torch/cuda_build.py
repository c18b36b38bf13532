"""Build a CUDA source of ``csrc/`` into a shared library and load it with
ctypes.

Each source has a plain C interface and includes no PyTorch headers, so
``nvcc`` builds it in seconds. The library goes to ``_build/`` inside the
package (git-ignored), named by a digest of the source and the flags, so
an edited source is rebuilt and a stale library is never loaded. Builds
happen at first use, never at import.
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

# name -> {"seconds": build time (0.0 when loaded from _build/),
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


def load_library(name, source):
    """Build ``csrc/<source>`` (if its digest is not in ``_build/`` yet)
    and return the loaded ``ctypes.CDLL``. Raises with nvcc's output when
    the build fails."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    t0 = time.perf_counter()
    log = ""
    if not lib.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {src.name} failed "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, lib)
    handle = ctypes.CDLL(str(lib))
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log,
                        "path": str(lib)}
    return handle
