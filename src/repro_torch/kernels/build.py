"""Builds the port's CUDA sources into plain-C shared libraries, loaded
with ctypes, and holds the checks the kernel wrappers share.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` at first use,
into ``build/repro_torch/`` at the root of the checkout. The library's file
name carries a hash of its source, the shared headers ``csrc/*.cuh`` and the
flags, so a stale library is never loaded. ``build_log[name]`` keeps the
compile time of the last build in this process and the ``ptxas -v`` report
of the library (kept beside it as ``<library>.ptxas``, so a library built
by an earlier process reports it too).

The libraries link the CUDA runtime as a shared library (``-cudart shared``,
not nvcc's static default). Loaded after ``torch``, they then bind the
``libcudart.so.12`` that PyTorch has already loaded, so the kernel wrappers
and PyTorch share one runtime: one current device per thread, one view of
the streams. A static runtime would be a second, separate instance, whose
current device ``torch.cuda.device`` never sets.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# the port's kernel sources, ``csrc/<name>.cu``, each built into a library
# of its own: flash attention forward and backward, the SSD scan forward and
# backward
SOURCES = ("flash_attention", "flash_attention_bwd", "ssd", "ssd_bwd")

# launch/dryrun.py's stand-ins for the kernels while it models a step, or
# None: the wrappers hand CPU tensors to its methods (named as the kernels)
# in place of the plain versions; CUDA tensors never reach it
STAND_IN = None
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared", "-Xptxas", "-v",
)

_lock = threading.Lock()
_count_lock = threading.Lock()
_tally = threading.local()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found; set CUDA_HOME to the CUDA toolkit")
    return found


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use).

    Different sources build concurrently when called from several threads;
    one source builds once.
    """
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(_build(name)))
        return lib


def _build(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    sha = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.read_bytes())
    sha.update(" ".join(NVCC_FLAGS).encode())
    digest = sha.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    report = out.with_name(out.name + ".ptxas")
    if out.exists():
        ptxas = report.read_text().splitlines() if report.exists() else []
        build_log[name] = {"seconds": 0.0, "cached": True, "library": str(out), "ptxas": ptxas}
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    ptxas = [ln.strip() for ln in proc.stderr.splitlines() if ln.strip()]
    report_tmp = report.with_name(f"{report.name}.{os.getpid()}.tmp")
    report_tmp.write_text("\n".join(ptxas))
    os.replace(report_tmp, report)
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    build_log[name] = {
        "seconds": time.perf_counter() - t0,
        "cached": False,
        "library": str(out),
        "ptxas": ptxas,
    }
    return out


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph; False where
    PyTorch has no CUDA (the query itself raises there)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def count_launch(wrapper, name: str) -> None:
    """Records one launch of a kernel through ``wrapper``: adds one to
    ``wrapper.launches`` where the kernel runs now, and to ``name``'s entry
    of the calling thread's open :func:`launch_tally`. A launch into a CUDA
    graph being captured runs nothing yet, so it counts in the tally only:
    each replay of the graph runs it, without the wrapper."""
    counts = getattr(_tally, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + 1
    if not capturing():
        with _count_lock:
            wrapper.launches += 1


@contextlib.contextmanager
def launch_tally():
    """Counts, by kernel name, the launches the calling thread's kernel
    wrappers record inside the block (:func:`count_launch`), captured ones
    included; other threads' launches are not counted."""
    outer = getattr(_tally, "counts", None)
    _tally.counts = counts = {}
    try:
        yield counts
    finally:
        _tally.counts = outer


def needs_grad(*tensors) -> bool:
    """Whether a call on these tensors is under autograd: grad enabled and
    one of them requiring a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def device_type(*tensors) -> str:
    """"cpu" or "cuda" for tensors that share one device, which decides
    whether a kernel wrapper takes its plain version or launches; raises
    ``ValueError`` otherwise."""
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return "cpu"
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs must share one CUDA device (or all be on the CPU): {devices}")
    return "cuda"


def rows_16_byte_aligned(t) -> bool:
    """Whether ``t``'s base address and every stride but the last (of a
    dimension longer than 1) are multiples of 16 bytes. Takes tensors on any
    device, the meta device included (there the address is the storage
    offset)."""
    size, bits = t.element_size(), t.data_ptr()
    for n, stride in zip(t.shape[:-1], t.stride()[:-1]):
        if n > 1:
            bits |= stride * size
    return bits % 16 == 0


def require_16_byte_rows(kernel: str, **tensors) -> None:
    """The bf16 kernels fill shared memory with 16-byte copies (cp.async):
    each tensor's base address, and every stride but the last (contiguous)
    one, must be a multiple of 16 bytes (:func:`rows_16_byte_aligned`).
    Raises ``ValueError`` for the first tensor that is not, before anything
    is launched."""
    for label, t in tensors.items():
        size = t.element_size()
        if not rows_16_byte_aligned(t):
            raise ValueError(
                f"{kernel}: {label} (address offset {t.data_ptr() % 16}, strides "
                f"{tuple(t.stride())}, {size}-byte elements) is not 16-byte aligned"
            )


class FirstLaunchGuard:
    """Holds the first launch of each kernel instantiation in a process
    against the kernel's plain version, and raises on a disagreement. It
    guards against a first-launch fault seen once on the card and not yet
    explained (``PERF.md``, Open questions), which would otherwise serve wrong
    tokens silently.

    ``check(key, case)`` returns at once for a key already checked. Otherwise
    ``case()`` makes a small input and returns ``(launch, want)``: ``launch()``
    runs the kernel on it and ``want`` is the plain version's result, one
    tensor or a tuple. ``error(got, want)`` measures each output; if the worst
    is above ``TOL``, a second launch on the same input is measured for the
    message and the check raises, leaving the key unchecked. The cost (one
    small launch and one synchronization) is paid once per key. A key not yet
    checked raises inside a CUDA graph capture (the check must have run in an
    eager warm-up before it): the check is never skipped.
    """

    TOL = 5e-2  # far above rounding in either dtype, far below a wrong result

    def __init__(self, kernel: str, error) -> None:
        self.kernel = kernel
        self.error = error
        self.checked: set = set()
        self._lock = threading.Lock()

    def _worst(self, got, want) -> float:
        if not isinstance(want, tuple):
            got, want = (got,), (want,)
        return max(self.error(g, w) for g, w in zip(got, want))

    def check(self, key, case) -> None:
        if key in self.checked:
            return
        if capturing():
            # the check synchronises with the host, which a capture forbids
            raise RuntimeError(
                f"{self.kernel}: the first launch of {key} is reached inside a CUDA graph "
                "capture, where its first-launch check cannot run; launch it eagerly "
                "(a warm-up run) before capturing"
            )
        with self._lock:
            if key in self.checked:
                return
            launch, want = case()
            err = self._worst(launch(), want)
            if not err <= self.TOL:
                err2 = self._worst(launch(), want)
                raise RuntimeError(
                    f"{self.kernel} first-launch check failed for {key}: error {err} against "
                    f"the plain version (tolerance {self.TOL}); a second launch on the same "
                    f"inputs: {err2}"
                )
            self.checked.add(key)
