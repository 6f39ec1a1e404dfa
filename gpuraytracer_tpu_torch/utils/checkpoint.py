"""Checkpoint / resume: the animation state and the config as JSON.

Port of gpuraytracer_tpu/utils/checkpoint.py, same format (version 1):
the only mutable cross-frame state is the animation state (time, camera
pose, light position; Renderer.cpp:113-119), saved with the config and
the index of the next frame, and published atomically (written to a
temporary file, then renamed). ``load`` reads a file that the reference's
``save`` wrote and gives the same state and frame index. The reference's
config key ``platform`` (a JAX backend name: "auto", "tpu" or "cpu") has
no counterpart here and is dropped; the loaded config keeps the port's
default ``device``, and the caller picks the device it renders on.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from gpuraytracer_tpu_torch.core.camera import Camera
from gpuraytracer_tpu_torch.core.config import RenderConfig
from gpuraytracer_tpu_torch.models.animate import AnimationState

FORMAT_VERSION = 1
# Keys of the reference's RenderConfig that the port does not carry.
_DROPPED_CONFIG_KEYS = ("platform",)


def save(path: str, state: AnimationState, config: RenderConfig, frame_index: int = 0) -> None:
    payload = {
        "format_version": FORMAT_VERSION,
        "frame_index": frame_index,
        "geometry_time": float(state.geometry_time),
        "camera": {
            "eye": [float(x) for x in state.camera.eye],
            "at": [float(x) for x in state.camera.at],
            "up": [float(x) for x in state.camera.up],
        },
        "light_position": [float(x) for x in state.light_position],
        "config": dataclasses.asdict(config),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, path)  # atomic publish


def load(path: str):
    """Returns (AnimationState, RenderConfig, frame_index)."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {payload.get('format_version')}")
    cam = Camera.__new__(Camera)
    cam.eye = np.asarray(payload["camera"]["eye"], dtype=np.float64)
    cam.at = np.asarray(payload["camera"]["at"], dtype=np.float64)
    cam.up = np.asarray(payload["camera"]["up"], dtype=np.float64)
    state = AnimationState(
        camera=cam,
        light_position=np.asarray(payload["light_position"], dtype=np.float64),
        geometry_time=payload["geometry_time"],
    )
    cfg = {k: v for k, v in payload["config"].items() if k not in _DROPPED_CONFIG_KEYS}
    return state, RenderConfig(**cfg), int(payload["frame_index"])
