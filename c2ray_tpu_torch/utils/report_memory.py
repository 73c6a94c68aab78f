"""Host + device memory reporting.

Port of ``c2ray_tpu/utils/report_memory.py``
(``code/report_memory.f90:52-117``: parse /proc/self/status for
VmPeak/VmSize/VmRSS/VmHWM per timestep), with the card's memory from
PyTorch's CUDA allocator (``torch.cuda.memory_stats``).
"""

from typing import Dict

_KEYS = ("VmPeak", "VmSize", "VmRSS", "VmHWM")


def host_memory_kb() -> Dict[str, int]:
    """Parse /proc/self/status (report_memory.f90:52-117)."""
    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                key = line.split(":")[0]
                if key in _KEYS:
                    out[key] = int(line.split()[1])
    except OSError:
        pass
    return out


def device_memory_bytes() -> Dict[str, Dict[str, int]]:
    """Per-card allocator usage: bytes in use, their peak, and the
    card's total memory; empty without CUDA."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


def memory_report(logf=None) -> str:
    """One formatted line per call (the reference writes this each
    timestep, C2Ray.F90:312)."""
    host = host_memory_kb()
    parts = [f"{k}={v//1024}MB" for k, v in host.items()]
    dev = device_memory_bytes()
    for name, s in dev.items():
        parts.append(
            f"{name}: {s['bytes_in_use']/2**30:.2f}/"
            f"{s['bytes_limit']/2**30:.2f}GB "
            f"(peak {s['peak_bytes_in_use']/2**30:.2f}GB)")
    line = "memory: " + " ".join(parts)
    if logf is not None:
        print(line, file=logf)
    return line
