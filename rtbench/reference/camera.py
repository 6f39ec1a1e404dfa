"""Camera model: DirectXMath-convention matrices + per-pixel ray generation.

Port of gpuraytracer_tpu/core/camera.py. The host-side matrix builders are
numpy float64 (cast to f32 on upload) and are copied unchanged; ray
generation runs on tensors of any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rtbench.reference import hlsl


# ---------------------------------------------------------------------------
# DirectXMath matrix builders (numpy float64 host-side; cast on upload)
# ---------------------------------------------------------------------------

def look_at_lh(eye, at, up) -> np.ndarray:
    """XMMatrixLookAtLH, row-vector convention."""
    eye = np.asarray(eye, dtype=np.float64)[:3]
    at = np.asarray(at, dtype=np.float64)[:3]
    up = np.asarray(up, dtype=np.float64)[:3]
    zaxis = at - eye
    zaxis = zaxis / np.linalg.norm(zaxis)
    xaxis = np.cross(up, zaxis)
    xaxis = xaxis / np.linalg.norm(xaxis)
    yaxis = np.cross(zaxis, xaxis)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = [xaxis[0], yaxis[0], zaxis[0]]
    m[1, :3] = [xaxis[1], yaxis[1], zaxis[1]]
    m[2, :3] = [xaxis[2], yaxis[2], zaxis[2]]
    m[3, :3] = [-xaxis @ eye, -yaxis @ eye, -zaxis @ eye]
    return m


def perspective_fov_lh(fov_y_radians: float, aspect: float, zn: float, zf: float) -> np.ndarray:
    """XMMatrixPerspectiveFovLH, row-vector convention."""
    y_scale = 1.0 / math.tan(fov_y_radians / 2.0)
    x_scale = y_scale / aspect
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = x_scale
    m[1, 1] = y_scale
    m[2, 2] = zf / (zf - zn)
    m[2, 3] = 1.0
    m[3, 2] = -zn * zf / (zf - zn)
    return m


def rotation_y(radians: float) -> np.ndarray:
    """XMMatrixRotationY, row-vector convention."""
    c, s = math.cos(radians), math.sin(radians)
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = c
    m[0, 2] = -s
    m[2, 0] = s
    m[2, 2] = c
    return m


def transform_point_row(v, m) -> np.ndarray:
    """Row-vector point transform: [v, 1] @ M, returns the xyz part."""
    v = np.asarray(v, dtype=np.float64)[:3]
    out = np.append(v, 1.0) @ np.asarray(m, dtype=np.float64)
    return out[:3]


def projection_to_world_matrix(eye, at, up, fov_y_deg, aspect, zn=0.01, zf=125.0) -> np.ndarray:
    """inverse(view @ proj) in row-vector convention (Renderer.cpp:295-299)."""
    view = look_at_lh(eye, at, up)
    proj = perspective_fov_lh(math.radians(fov_y_deg), aspect, zn, zf)
    return np.linalg.inv(view @ proj)


class Camera:
    """Host-side camera state (Renderer.cpp:252-268): eye/at/up plus the
    45deg initial Y rotation applied to eye and up (not at)."""

    FOV_Y_DEG = 45.0
    Z_NEAR = 0.01
    Z_FAR = 125.0

    def __init__(self, eye=(0.0, 5.3, -17.0), at=(0.0, 0.0, 0.0), initial_y_rotation_deg=45.0):
        eye = np.asarray(eye, dtype=np.float64)
        at = np.asarray(at, dtype=np.float64)
        right = np.array([1.0, 0.0, 0.0])
        direction = at - eye
        direction = direction / np.linalg.norm(direction)
        up = np.cross(direction, right)
        up = up / np.linalg.norm(up)
        if initial_y_rotation_deg:
            rot = rotation_y(math.radians(initial_y_rotation_deg))
            eye = transform_point_row(eye, rot)
            up = transform_point_row(up, rot)
        self.eye, self.at, self.up = eye, at, up

    def rotate_y(self, radians: float) -> "Camera":
        """Camera orbit (Renderer.cpp:92-101): rotate eye, up AND at."""
        rot = rotation_y(radians)
        cam = Camera.__new__(Camera)
        cam.eye = transform_point_row(self.eye, rot)
        cam.up = transform_point_row(self.up, rot)
        cam.at = transform_point_row(self.at, rot)
        return cam

    def projection_to_world(self, aspect: float) -> np.ndarray:
        return projection_to_world_matrix(
            self.eye, self.at, self.up, self.FOV_Y_DEG, aspect, self.Z_NEAR, self.Z_FAR
        )


# ---------------------------------------------------------------------------
# Ray generation (device-side)
# ---------------------------------------------------------------------------

def generate_camera_rays(pixel_x, pixel_y, width, height, camera_position, projection_to_world):
    """GenerateCameraRay (RaytracingShaderHelper.hlsli:103-120) over pixel
    index tensors of any matching shape. Returns (origins, directions)
    with a trailing xyz axis; directions normalized."""
    sx = (pixel_x.to(torch.float32) + 0.5) / float(width) * 2.0 - 1.0
    sy = (pixel_y.to(torch.float32) + 0.5) / float(height) * 2.0 - 1.0
    sy = -sy  # DirectX-style Y

    p2w = projection_to_world
    # world = [sx, sy, 0, 1] @ P2W (row-vector convention), row by row.
    world = sx[..., None] * p2w[0] + sy[..., None] * p2w[1] + p2w[3]
    world_xyz = world[..., :3] / world[..., 3:4]
    cam = camera_position[:3]
    origins = world_xyz * 0.0 + cam
    directions = hlsl.normalize(world_xyz - cam)
    return origins, directions


def pixel_grid(width: int, height: int, device):
    """(H, W) int32 pixel index grids, x fastest (DispatchRaysIndex order)."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.int32, device=device),
        torch.arange(width, dtype=torch.int32, device=device),
        indexing="ij",
    )
    return xs, ys
