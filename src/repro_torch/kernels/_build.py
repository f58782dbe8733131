"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers) and
is compiled on its own by one ``nvcc`` process into
``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout (the
directory is listed in ``.gitignore``).  The hash covers the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
:func:`build` starts one ``nvcc`` per stale source, all together, and waits
for every one; a failed build raises with ``nvcc``'s stderr.  ``-Xptxas -v``
makes ``ptxas`` report each kernel's registers and shared memory, kept
beside the library (:func:`ptxas_report`).

Nothing here runs at import: the tests import every module on machines
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fir", "mriq", "flash_attention", "decode_attention", "ssm_scan",
           "rglru_scan", "rmsnorm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")   # the toolkit's install prefix
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def ptxas_report(name: str) -> str:
    """``ptxas -v`` output of the last build of ``name`` (registers, shared
    memory, spills per kernel)."""
    path = library_path(name).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def build(names=SOURCES) -> list[str]:
    """Compile every stale source in ``names``: one ``nvcc`` process per
    source, all started together.  Returns the names it compiled; raises
    ``RuntimeError`` with ``nvcc``'s stderr when any build fails."""
    stale = [n for n in names if not library_path(n).exists()]
    if not stale:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for name in stale:
            out = library_path(name)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((name, proc, tmp, out))
        failures = []
        for name, proc, tmp, out in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {name}.cu "
                                f"(exit {proc.returncode}):\n{stdout}{stderr}")
                continue
            out.with_suffix(".ptxas.txt").write_text(stdout + stderr)
            os.replace(tmp, out)
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for _, proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return stale


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def check(code: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def declare(lib: ctypes.CDLL, signatures: dict) -> None:
    """Set ``restype``/``argtypes`` of each C entry point: ``c_void_p`` for
    pointers and streams, ``c_int`` for ints — without them ctypes would
    pass a pointer as a 32-bit int and cut it."""
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    for fn_name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, fn_name)
        fn.restype = restype
        fn.argtypes = list(argtypes)


def func_attributes(lib: ctypes.CDLL, fn_name: str, *selector: int) -> dict:
    """``cudaFuncGetAttributes`` of one kernel through its C helper
    ``fn_name(selector..., &regs, &static_smem, &max_threads)``."""
    regs, smem, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    check(getattr(lib, fn_name)(*selector, ctypes.byref(regs),
                                ctypes.byref(smem), ctypes.byref(threads)),
          lib, fn_name)
    return {"registers": regs.value, "static_smem_bytes": smem.value,
            "max_threads_per_block": threads.value}
