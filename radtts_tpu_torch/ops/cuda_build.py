"""Build a CUDA C++ source of csrc/ with nvcc for sm_90a into a shared
library with a plain C interface, and load it with ctypes.

Libraries go to build/radtts_tpu_torch/ at the repository root, named by a
hash of the source, the csrc/ headers it includes (`#include "x.cuh"`) and
the flags, so a changed source or header builds anew and an unchanged one
is loaded as it is. Nothing is built at import: each kernel's
wrapper builds at its first CUDA call.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "radtts_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_library(name, defines=()):
    """nvcc csrc/<name>.cu (once per source version and set of `defines`,
    each "NAME=VALUE" passed as -D) and load it. Returns (ctypes library,
    nvcc output, seconds); the output is empty when the library was already
    built."""
    tic = time.perf_counter()
    src = os.path.join(CSRC, f"{name}.cu")
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    with open(src, "rb") as f:
        text = f.read()
    for header in re.findall(rb'#include "([^"]+)"', text):
        with open(os.path.join(CSRC, header.decode()), "rb") as f:
            text += f.read()
    tag = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")
    log = ""
    if not os.path.exists(so):
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc, *flags, "-o", tmp, src],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(so), log, time.perf_counter() - tic
