"""Device selection: the DeviceResources adapter-enumeration analog.

Port of gpuraytracer_tpu/parallel/device.py. The reference enumerates
DXGI adapters (DeviceResources.cpp:794-875) and its JAX port prefers the
TPU with an automatic CPU fallback ("auto"). Here a device is always asked
for by name: "cuda" (the card), "cuda:N", or "cpu" (the software device,
the WARP analog). A requested device that is absent is an error, and
"auto" is not carried over: nothing falls back to the CPU unless the caller
asks for it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    device: torch.device
    platform: str  # "cuda" | "cpu"
    is_software: bool  # the CPU: the WARP analog
    description: str

    @property
    def id(self) -> int:
        """The device's index (card N of "cuda:N"; 0 for the CPU)."""
        return self.device.index or 0


def available_platforms() -> list[str]:
    """The platforms present, of "cuda" and "cpu", in that order."""
    return (["cuda"] if torch.cuda.is_available() and torch.cuda.device_count() > 0
            else []) + ["cpu"]


def pick_device(device: str = "cuda") -> DeviceInfo:
    """The device named ``device``: "cuda" (card 0), "cuda:N" (the
    adapter override, DeviceResources.cpp:811-845) or "cpu". Raises
    ValueError for any other name and RuntimeError when the card is absent
    or out of range (the analog of the reference's hard assert on DXR
    support, Renderer.cpp:68)."""
    try:
        dev = torch.device(device)
    except RuntimeError as e:
        raise ValueError(f"unknown device {device!r}: expected cuda, cuda:N or cpu") from e
    if dev.type == "cpu":
        return DeviceInfo(device=dev, platform="cpu", is_software=True,
                          description="cpu (software device)")
    if dev.type != "cuda":
        raise ValueError(f"unknown device {device!r}: expected cuda, cuda:N or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    idx = dev.index or 0
    count = torch.cuda.device_count()
    if not 0 <= idx < count:
        raise RuntimeError(f"cuda device {idx} out of range ({count} devices)")
    dev = torch.device("cuda", idx)
    return DeviceInfo(device=dev, platform="cuda", is_software=False,
                      description=f"{torch.cuda.get_device_name(dev)} (cuda:{idx})")


def device_count(platform: str = "cuda") -> int:
    """The number of devices of ``platform`` ("cuda" or "cpu", as
    ``pick_device`` takes it; the CPU is one device). Raises as
    ``pick_device`` does when the platform is absent."""
    info = pick_device(platform)
    return torch.cuda.device_count() if info.platform == "cuda" else 1
