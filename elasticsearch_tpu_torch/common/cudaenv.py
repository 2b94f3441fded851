"""Device choice, kernel builds and launch counters — the port's counterpart
of the JAX package's `common/jaxenv.py`.

- `default_device` picks the device an entry point runs on: the card, unless
  the caller asks for the CPU. It raises when CUDA is absent and the caller
  did not ask for the CPU; there is no silent host path.
- `load_library` builds `csrc/<name>.cu` with `nvcc` into a shared library
  with a plain C interface and loads it with `ctypes` (no PyTorch headers,
  so a build takes seconds). Builds land in `build/kernels/` beside the
  package, keyed by a hash of the source and flags, so an edited source is
  rebuilt. `build_all` starts one `nvcc` per source at once. A failed build
  raises `KernelBuildError`; nothing falls back to a plain version.
- `CudaError` is what a kernel wrapper raises when its launch returns a
  `cudaError_t` other than success: `.code` is that code, `.kernel` the
  kernel whose launch returned it, and `.sticky` says whether the context
  is lost with it (common/devicehealth classifies it).
- `LAUNCHES` counts kernel launches by name: each wrapper bumps its count
  where it launches its kernel, and nowhere else.
- `upload` / `pull` are the two directions of host↔device traffic on the
  serving path: uploads never synchronise (`upload_pinned` stages a large
  host row in pinned memory first; `upload_buffer` sends a whole staged
  buffer — a sparse launch's arrays — with one copy), and `pull` brings a
  whole batch of result tensors back behind one event wait. `pull_async`
  is its enqueue half (the end of a batch's dispatch) and
  `PendingPull.wait` its wait half (the batch's merge); a failed wait
  `abandon`s the staging.
- `park` keeps the pinned host buffers of a pull that failed with the
  context lost alive for the rest of the process: PyTorch frees a pinned
  block that a copy used by recording a CUDA event on its stream, and
  after a sticky error that call fails inside a destructor, which aborts
  the process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

# IEEE round-to-nearest division and square root (no --use_fast_math), and no
# contraction of a*b+c into an FMA: the kernels must be bitwise equal to their
# plain torch versions, which round every operation separately
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class DeviceUnavailableError(RuntimeError):
    """The caller asked for (or defaulted to) a device this process lacks."""


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source, or a built kernel
    disagreed with its plain version in its start check."""


# cudaError_t codes after which every later CUDA call of the process fails:
# illegal address, launch timeout, device-side assert, illegal instruction,
# misaligned address, invalid address space, invalid program counter, launch
# failure
STICKY_CODES = frozenset({700, 702, 710, 715, 716, 717, 718, 719})
# a launch the card refuses as configured: invalid configuration, invalid
# device function, no kernel image for the device, too many resources
LAUNCH_CONFIG_CODES = frozenset({9, 98, 209, 701})
# the context stays usable and the same call may succeed once pressure
# drains: memory allocation, devices unavailable, a wait timed out
TRANSIENT_CODES = frozenset({2, 46, 909})
# cudaGetErrorString's text of each code above, as PyTorch's own "CUDA
# error: <text>" messages carry it
ERROR_STRINGS = {
    2: "out of memory",
    9: "invalid configuration argument",
    46: "busy or unavailable",
    98: "invalid device function",
    209: "no kernel image is available",
    700: "an illegal memory access was encountered",
    701: "too many resources requested for launch",
    702: "the launch timed out and was terminated",
    710: "device-side assert triggered",
    715: "an illegal instruction was encountered",
    716: "misaligned address",
    717: "operation not supported on global/shared address space",
    718: "invalid program counter",
    719: "unspecified launch failure",
    909: "timeout specified for the wait operation has lapsed",
}


def error_code_of(message: str) -> int | None:
    """The cudaError_t whose text `message` carries, when it is one of
    ERROR_STRINGS."""
    low = message.lower()
    for code, text in ERROR_STRINGS.items():
        if text in low:
            return code
    return None


class CudaError(RuntimeError):
    """A CUDA call of the port's own failed: `code` is its cudaError_t,
    `kernel` the kernel whose launch returned it (None for an error that no
    launch of the port's raised), `sticky` whether the process's context is
    lost with it."""

    def __init__(self, code: int, message: str, kernel: str | None = None):
        super().__init__(message)
        self.code = int(code)
        self.kernel = kernel

    @property
    def sticky(self) -> bool:
        return self.code in STICKY_CODES


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    current CUDA device. Raises DeviceUnavailableError when CUDA is needed
    and absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "CUDA is not available; pass device='cpu' to run on the host")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise DeviceUnavailableError(f"unsupported device [{dev}]")
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(f"device [{dev}] requested but CUDA is "
                                     "not available")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# host <-> device traffic
# ---------------------------------------------------------------------------


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device` without synchronising: on the
    card a non-blocking copy (CUDA stages pageable memory before the
    call returns, so `array` may be reused at once); on the CPU the tensor
    shares `array`'s memory."""
    arr = np.ascontiguousarray(array)
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if device.type == "cpu":
        return t
    return t.to(device, non_blocking=True)


def upload_pinned(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """`upload` for a large host row (a filter mask, a function row): on the
    card the array is staged in pinned memory and copied without
    synchronising, so the copy is a DMA the stream orders; on the CPU the
    tensor shares `array`'s memory."""
    if device.type == "cpu":
        return upload(array, device)
    arr = np.ascontiguousarray(array)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).pin_memory().to(device, non_blocking=True)


# pinned host buffers of pulls that failed with the context lost, never
# freed (`park`)
_PARKED: list = []
_PARKED_LOCK = threading.Lock()


def park(buffers) -> None:
    """Keep pinned host buffers alive until the process ends: freeing them
    makes a CUDA call (an event record), which after a sticky error aborts
    the process from a destructor. A sticky error ends the process's useful
    life anyway (a restart is the cure), so the few buffers of the batches
    that failed with it are kept instead."""
    with _PARKED_LOCK:
        _PARKED.append(buffers)


def upload_buffer(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A staged host buffer on `device` with ONE copy: on the card a
    non-blocking copy from `buf` (pageable memory, which the driver has
    taken when the call returns, so its owner may write `buf` again at
    once); on the CPU the buffer itself."""
    if device.type == "cpu":
        return buf
    return buf.to(device, non_blocking=True)


class PendingPull:
    """One batch's device→host copies in flight: `pull_async` enqueued them
    behind the batch's own launches and recorded one event after them;
    `wait()` waits on that event alone and returns the host arrays.

    The split matters under double buffering: when batch N merges, batch
    N+1's launches are already on the stream. Copies enqueued at merge time
    would queue behind N+1's kernels, so N's merge would wait for N+1's
    device work. Enqueued at the end of N's dispatch, they wait for N's."""

    __slots__ = ("_tensors", "_hosts", "_done")

    def __init__(self, tensors: list, hosts: list, done):
        # the device tensors stay referenced until the copies have run
        self._tensors = tensors
        self._hosts = hosts
        self._done = done

    def wait(self) -> list:
        """The host arrays, after the one event wait (none on the CPU)."""
        if self._done is not None:
            self._done.synchronize()
            self._done = None
            self._tensors = None
        return [h.numpy() for h in self._hosts]

    def abandon(self, context_lost: bool = False) -> None:
        """Drop the batch's staging after a failed wait, with no CUDA call
        (no event query, no synchronise: after a sticky error each would
        raise again). The device tensors and the pinned host buffers go back
        to their caching allocators with their last reference, unless the
        failure may have lost the context: then the pinned buffers are
        parked, never freed (`park`)."""
        if context_lost and self._done is not None:
            park(self._hosts)
        self._done = None
        self._tensors = None
        self._hosts = []


def pull_async(tensors: list) -> PendingPull:
    """Enqueue every tensor of a batch for the host without synchronising:
    on the card, non-blocking copies into pinned buffers on the current
    stream and one event recorded after them; on the CPU the tensors are
    the host buffers already."""
    if not tensors or tensors[0].device.type != "cuda":
        return PendingPull(None, list(tensors), None)
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return PendingPull(list(tensors), hosts, done)


def pull(tensors: list) -> list:
    """Every tensor of a batch to host numpy arrays behind ONE wait (the
    counterpart of the JAX package's one `jax.device_get` per batch):
    `pull_async` and its `wait()` in one call."""
    return pull_async(tensors).wait()


# ---------------------------------------------------------------------------
# kernel builds
# ---------------------------------------------------------------------------


def kernel_sources() -> list[str]:
    """Names of the kernel sources in `csrc/` (one library each)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise KernelBuildError("nvcc not found (PATH, CUDA_HOME, CUDA_PATH)")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Build every named kernel source (default: all of `csrc/`) that has no
    current library, one nvcc process per source, all started together.
    Returns {name: compiler output} for the sources it built; raises
    KernelBuildError on any failure."""
    names = kernel_sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed, logs = [], {}
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return logs


_LIBS: dict[str, ctypes.CDLL] = {}
_LIB_LOCK = threading.Lock()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel source `csrc/<name>.cu`, built on
    first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LIB_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _src, target = _target(name)
            if not target.exists():
                build_all([name])
            lib = ctypes.CDLL(str(target))
            _LIBS[name] = lib
    return lib


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------


class LaunchCounts:
    """Kernel launches by kernel name, so a run can show that its path went
    through the hand-written kernels."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def bump(self, name: str) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


LAUNCHES = LaunchCounts()
