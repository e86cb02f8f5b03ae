"""Build the port's CUDA kernels with plain ``nvcc`` and load them with ctypes.

Each source under ``ccdm_tpu_torch/csrc/`` has a plain C interface and is
compiled at first use into a shared library under
``build/ccdm_tpu_torch/<hash>/`` beside the package (the hash covers the
source, the headers of ``csrc/`` and the flags, so an edit rebuilds and an
unchanged tree reuses the library). The library links CUDA's runtime
statically and nothing of torch, so a build takes seconds. It is compiled to a temporary name and moved into
place with ``os.replace``: a build that is killed leaves no lock behind.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "ccdm_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# what the last build of each library printed (ptxas: registers, spills)
BUILD_LOGS: dict[str, str] = {}


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library built from csrc/<name>.cu goes: the hash covers the
    source, every header of csrc/ (csrc/*.cuh, which a source may include)
    and the flags."""
    digest = hashlib.sha256()
    for path in (CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{name}.so"


def nvcc_command(nvcc: str, source: Path, output: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already built."""
    lib = library_path(name)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}.", suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(find_nvcc(), CSRC_DIR / f"{name}.cu", Path(tmp)),
                              capture_output=True, text=True)
        BUILD_LOGS[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{BUILD_LOGS[name]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; every library exports
    ``ccdm_cuda_error_string``."""
    lib = ctypes.CDLL(str(build(name)))
    lib.ccdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ccdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.ccdm_cuda_error_string(err).decode()})")


def run(lib: ctypes.CDLL, fn_name: str, what: str, dev, *args) -> None:
    """Call `fn_name` of `lib` on `dev`'s current stream: tensors pass as
    their data pointers, None as a null pointer, anything else as it is.
    The device is made current only when it is not already."""
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    fn, stream = getattr(lib, fn_name), torch.cuda.current_stream(index).cuda_stream
    if index == current:
        err = fn(*ptrs, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*ptrs, stream)
    check(lib, err, what)
