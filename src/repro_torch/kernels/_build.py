"""Build and load the port's CUDA kernels (``csrc/*.cu``) as one shared library.

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` (``*.cuh`` are headers the sources share); the objects are
then linked into ``libreprokernels.so``, which is loaded with ``ctypes``.
The library has a plain C interface (no PyTorch headers), so a build takes
seconds.  It links against the CUDA runtime only: the tensor-core kernels
reach the driver's ``cuTensorMapEncodeTiled`` through
``cudaGetDriverEntryPoint``.  It lands in ``build/repro_torch_kernels/<hash>/``
under the repository root, where the hash covers the sources, the headers
and the flags: a changed source builds anew, an unchanged one is loaded as
it is.  Nothing is built on import; the first kernel launch on a CUDA
tensor calls :func:`library`.

Each kernel is also a ``torch.library`` op (``torch.ops.repro_torch.*``)
with a fake implementation and a FLOP formula, which a trace reads
(``launch/dryrun.py``).  :func:`traced` tells a trace's call from a run's:
a run calls the op's CUDA implementation itself, since a call through the
dispatcher adds the op's Python autograd and backend wrappers to the host
time of every launch (every psum of a sharded step).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libreprokernels.so"

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of every exported function: argtypes; the restype is int (a
# cudaError_t) unless RESTYPES names another.
SIGNATURES = {
    "repro_gemm": (P, P, P, P, I, I, I, I, I, L, L, L, L, I, I, P),
    "repro_gemm_wgmma": (P, P, P, P, I, I, I, I, P),
    "repro_gemm_tf32x3": (P, P, P, P, I, I, I, I, P),
    "repro_reduce_nway": (P, P, I, I, L, I, L, L, L, I, I, P),
    "repro_flash_attention": (P, P, P, P, I, I, I, I, I, P),
    "repro_flash_attention_wgmma": (P, P, P, P, I, I, I, I, I, P),
    "repro_rglru_scan": (P, P, P, I, I, I, I, P, L, ctypes.c_uint, P),
    "repro_rglru_scan_scratch": (I, I, I, I),
    "repro_wkv": (P, P, P, P, P, P, P, P, I, I, I, I, I, P),
    "repro_wkv_info": (I, I, P, P, P),
}
RESTYPES = {"repro_rglru_scan_scratch": L}


def nvcc() -> str:
    """The nvcc to build with; raises when the CUDA toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile every source in parallel and link them.

    Returns (library path, seconds spent, ptxas report).  A library already
    built from the same sources is reused and reports 0 seconds.
    """
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    log = out_dir / "ptxas.log"
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    exe = nvcc()
    t0 = time.perf_counter()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        tmp = Path(tmp)
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        report, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            report.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(report))
        link = subprocess.run(
            [exe, ARCH, "-shared", *[str(o) for _, o, _ in procs], "-o", str(tmp / LIB_NAME)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "ptxas.log").write_text("\n".join(report))
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp / "ptxas.log", log)
        os.replace(tmp / LIB_NAME, lib)  # last: its presence marks a finished build
    return lib, time.perf_counter() - t0, log.read_text()


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with its C signatures set."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


_PLAIN = (torch.Tensor, torch.nn.Parameter)


def traced(*tensors) -> bool:
    """Whether a kernel's call on tensors off the CPU belongs to a trace: a
    dispatch mode is on (``FakeTensorMode``, ``FlopCounterMode``, the dry
    run's counters) or an operand is a fake or meta tensor.  Such a call
    goes through the kernel's op; any other launches the kernel."""
    return is_in_torch_dispatch_mode() or any(
        type(t) not in _PLAIN or t.device.type != "cuda" for t in tensors if t is not None)
