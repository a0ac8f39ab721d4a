"""Kernel dispatch and the CUDA build (the role of idiaptts_tpu's
``ops/pallas_ctx.py``).

Routing is decided by where the tensors lie, and nothing else:

- CPU tensors go to the plain PyTorch version of a kernel (the CPU path
  and the tests' oracle);
- CUDA tensors go to the hand-written kernel.  If the kernel cannot be
  built or launched for the shape it was given, the call raises.  There
  is no shape gate that hands CUDA work to the plain path.

The kernels live in ``idiaptts_torch/csrc/*.cu`` behind a plain C
interface.  At first use each source is compiled by its own ``nvcc``
process, all started together, and the objects are linked into one
shared library under ``idiaptts_torch/_build/`` (named by a hash of the
sources and flags, so an edit rebuilds), loaded with ``ctypes``.  Every
pointer and the stream are passed as ``c_void_p``; every C entry point
returns ``cudaGetLastError()`` after its launch, and a non-zero code
raises :class:`KernelError`.

Each kernel is a :class:`Kernel` object with a plain integer
``launches`` counter that goes up by one per successful launch, so a
run can show that its main path went through the kernels.  A launch
made while a CUDA graph is captured (inside :func:`capturing`) runs
nothing then: it is counted for the graph instead, and each replay of
the graph adds its launches to the counters (:func:`credit`).  With
:mod:`idiaptts_torch.utils.tracing` on, each call is a
``dispatch.launch`` span (the host's time in it) naming its kernel.
"""

import collections
import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

from idiaptts_torch.utils import tracing

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "--ptxas-options=-v")

_lock = threading.Lock()
_lib = None
_kernels = []
# {Kernel: launches} of the CUDA graph being captured, else None.
_captured = None
# Filled by the build: seconds taken (0.0 when the library was already
# built), the library path and nvcc's output (ptxas register and shared
# memory report per kernel).
build_info = {}


class KernelError(RuntimeError):
    """A hand kernel failed to build or launch."""


def use_kernel(*tensors):
    """True when the tensors lie on a CUDA device (run the hand kernel),
    False when they lie on the CPU (run the plain version).  Mixed or
    other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError("kernel inputs must all lie on the CPU or all on one "
                     "CUDA device, got {}".format(
                         sorted(str(t.device) for t in tensors)))


def resolve_device(device):
    """``torch.device`` for an entry point's ``device`` argument.  The
    entry points default to ``"cuda"``; without a usable CUDA device
    they raise rather than run on the CPU.  Pass ``device="cpu"`` for the
    plain path."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device {} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path".format(device))
    return device


def check(tensor, name, dtype, shape):
    """Validate a kernel argument: dtype, exact shape and contiguity."""
    if tensor.dtype != dtype:
        raise ValueError("{} must be {}, got {}".format(name, dtype,
                                                        tensor.dtype))
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError("{} must have shape {}, got {}".format(
            name, tuple(shape), tuple(tensor.shape)))
    if not tensor.is_contiguous():
        raise ValueError("{} must be contiguous".format(name))


def nvcc_path():
    """The nvcc that builds the kernels: PATH, then CUDA_HOME/CUDA_PATH,
    then /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get(
        "CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise KernelError("nvcc not found (PATH, CUDA_HOME, "
                          "/usr/local/cuda); cannot build the kernels")
    return path


def _build_and_load():
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not sources:
        raise KernelError("no kernel sources under " + CSRC_DIR)
    digest = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(
        BUILD_DIR, "libidiaptts_kernels_{}.so".format(
            digest.hexdigest()[:16]))
    seconds, log = 0.0, ""
    if not os.path.isfile(lib_path):
        t0 = time.perf_counter()
        log = _compile_and_link(sources, lib_path)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(lib_path)
    lib.idt_error_string.argtypes = [ctypes.c_int]
    lib.idt_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=seconds, path=lib_path, log=log)
    return lib


def _compile_and_link(sources, lib_path):
    """One ``nvcc -c`` per source, all running at once, then one link.
    Returns nvcc's output (ptxas reports); raises KernelError on a
    failure."""
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, _, proc in jobs:
            out = proc.communicate()[0]
            log.append(out)
            if proc.returncode != 0:
                failed.append("{}:\n{}".format(" ".join(cmd), out))
        if failed:
            raise KernelError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib,
               *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise KernelError("nvcc link failed ({}):\n{}".format(
                " ".join(cmd), proc.stdout + proc.stderr))
        os.replace(tmp_lib, lib_path)
    return "".join(log)


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build_and_load()
        return _lib


class Kernel:
    """One C entry point of the kernel library.

    ``argtypes`` lists the entry point's arguments without the trailing
    ``cudaStream_t``, which every entry point takes last and which
    :meth:`__call__` fills in from PyTorch's current stream on
    ``device``.
    """

    def __init__(self, name, symbol, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None
        _kernels.append(self)

    def __call__(self, device, *args):
        with tracing.span("dispatch.launch", kernel=self.name):
            lib = library()
            if self._fn is None:
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream(device).cuda_stream
                err = self._fn(*args, stream)
            if err != 0:
                raise KernelError("{} failed to launch: {} (cuda error {})"
                                  .format(self.name,
                                          lib.idt_error_string(err)
                                          .decode(), err))
            if _captured is not None:
                _captured[self] += 1
            else:
                self.launches += 1


class HostEntry:
    """A C entry point of the kernel library that launches nothing (a
    kernel's launch plan), called with ``device`` current.  A non-zero
    return raises :class:`KernelError`; no launch is counted."""

    def __init__(self, symbol, argtypes):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self._fn = None

    def __call__(self, device, *args):
        lib = library()
        if self._fn is None:
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            err = self._fn(*args)
        if err != 0:
            raise KernelError("{} failed: {} (cuda error {})".format(
                self.symbol, lib.idt_error_string(err).decode(), err))


@contextlib.contextmanager
def capturing():
    """Count the launches made inside, from any thread (a CUDA graph's
    capture, in which they run nothing), apart from the counters; yields
    the ``{Kernel: launches}`` that :func:`credit` adds for each
    replay."""
    global _captured
    _captured = collections.Counter()
    try:
        yield _captured
    finally:
        _captured = None


def credit(launches):
    """Count one replay of a graph captured with ``launches``."""
    for kernel, n in launches.items():
        kernel.launches += n


def reset_counts():
    """Zero every kernel's launch counter."""
    for k in _kernels:
        k.launches = 0


def counts():
    """{kernel name: launches} for every kernel of the imported
    modules."""
    return {k.name: k.launches for k in _kernels}
