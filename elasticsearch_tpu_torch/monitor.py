"""Monitor service: OS, process, filesystem and runtime metrics (a copy of
the JAX package's `monitor.py`).

The reference loads native Sigar libraries for its os and process stats;
here the source of truth is /proc (what Sigar reads underneath) plus the
resource and os modules. "jvm stats" map to the Python runtime and the
node's CUDA device: its name and the caching allocator's bytes from
`torch.cuda` (allocated, reserved, peak allocated) and the free and total
bytes the driver reports. A `cpu` node reports no device and makes no CUDA
call.
"""

from __future__ import annotations

import gc
import os
import resource
import time


def os_stats(proc: str = "/proc") -> dict:
    """`proc` overrides the procfs root so tests can feed canned fixtures
    (tests/test_monitor.py) — production always reads the real /proc."""
    out: dict = {"timestamp": int(time.time() * 1000)}
    try:
        load = os.getloadavg()
        out["load_average"] = list(load)
    except OSError:
        pass
    try:
        with open(os.path.join(proc, "meminfo")) as fh:
            mem = {}
            for line in fh:
                parts = line.split()
                if parts[0].rstrip(":") in ("MemTotal", "MemFree", "MemAvailable",
                                            "SwapTotal", "SwapFree"):
                    mem[parts[0].rstrip(":")] = int(parts[1]) * 1024
        out["mem"] = {
            "total_in_bytes": mem.get("MemTotal", 0),
            "free_in_bytes": mem.get("MemFree", 0),
            "available_in_bytes": mem.get("MemAvailable", 0),
        }
        out["swap"] = {
            "total_in_bytes": mem.get("SwapTotal", 0),
            "free_in_bytes": mem.get("SwapFree", 0),
        }
    except OSError:
        pass
    out["cpu"] = {"count": os.cpu_count()}
    return out


def process_stats(proc: str = "/proc") -> dict:
    """`proc` overrides the procfs root (canned fixtures in tests)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {
        "timestamp": int(time.time() * 1000),
        "id": os.getpid(),
        "mem": {"resident_in_bytes": ru.ru_maxrss * 1024},
        "cpu": {
            "user_in_millis": int(ru.ru_utime * 1000),
            "sys_in_millis": int(ru.ru_stime * 1000),
            "total_in_millis": int((ru.ru_utime + ru.ru_stime) * 1000),
        },
    }
    try:
        with open(os.path.join(proc, "self", "status")) as fh:
            for line in fh:
                if line.startswith("Threads:"):
                    out["threads"] = int(line.split()[1])
                elif line.startswith("VmRSS:"):
                    out["mem"]["resident_in_bytes"] = int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        out["open_file_descriptors"] = len(os.listdir(
            os.path.join(proc, "self", "fd")))
        out["max_file_descriptors"] = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    except OSError:
        pass
    return out


def fs_stats(paths: list[str]) -> dict:
    data = []
    for p in paths:
        try:
            st = os.statvfs(p)
            data.append({
                "path": p,
                "total_in_bytes": st.f_blocks * st.f_frsize,
                "free_in_bytes": st.f_bfree * st.f_frsize,
                "available_in_bytes": st.f_bavail * st.f_frsize,
            })
        except OSError:
            continue
    return {"timestamp": int(time.time() * 1000), "data": data}


def runtime_stats(device=None) -> dict:
    """The "jvm stats" analogue: the Python runtime and, on a `cuda` node,
    its card (`device`, a torch.device; None or a CPU device: no device
    entry and no CUDA call)."""
    import sys

    counts = gc.get_count()
    out = {
        "timestamp": int(time.time() * 1000),
        "runtime": "python",
        "version": sys.version.split()[0],
        "gc": {"collections": gc.get_stats()[-1].get("collections", 0)
               if gc.get_stats() else 0, "pending": sum(counts)},
        "uptime_in_millis": int(time.monotonic() * 1000),
        "devices": [],
    }
    if device is not None and device.type == "cuda":
        import torch

        free, total = torch.cuda.mem_get_info(device)
        out["devices"].append({
            "platform": "cuda",
            "device": str(device),
            "name": torch.cuda.get_device_name(device),
            "memory_allocated_in_bytes": int(torch.cuda.memory_allocated(device)),
            "memory_reserved_in_bytes": int(torch.cuda.memory_reserved(device)),
            "max_memory_allocated_in_bytes": int(
                torch.cuda.max_memory_allocated(device)),
            "free_in_bytes": int(free),
            "total_in_bytes": int(total),
        })
    return out


class MonitorService:
    def __init__(self, node):
        self.node = node

    def sections(self) -> dict:
        """Monitor stats as name -> thunk, so `/_nodes/stats/{metric}` can
        build ONLY the requested sections (each is its own procfs read)."""
        return {
            "os": os_stats,
            "process": process_stats,
            "fs": lambda: fs_stats([self.node.data_path]),
            "runtime": lambda: runtime_stats(self.node.device),
        }

    def full_stats(self) -> dict:
        return {name: build() for name, build in self.sections().items()}
