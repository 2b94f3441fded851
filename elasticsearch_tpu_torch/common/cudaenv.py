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
- `LAUNCHES` counts kernel launches by name: each wrapper bumps its count
  where it launches its kernel, and nowhere else.
- `upload` / `pull` are the two directions of host↔device traffic on the
  serving path: uploads never synchronise, and `pull` brings a whole batch of
  result tensors back behind one event wait. `pull_async` is its enqueue
  half (the end of a batch's dispatch) and `PendingPull.wait` its wait half
  (the batch's merge).
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
    """nvcc is missing or refused a kernel source."""


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
