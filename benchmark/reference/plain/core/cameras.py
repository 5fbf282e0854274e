"""Perspective and equirectangular cameras and ray generation (mirror of
``neusky_tpu/core/cameras.py``; OpenGL convention: the camera looks down
−z, +y up, image rows grow downward)."""

from __future__ import annotations

import dataclasses
import enum
import math

import torch

from benchmark.reference.plain.core.rays import RayBundle


class CameraType(enum.IntEnum):
    PERSPECTIVE = 1
    EQUIRECTANGULAR = 2


@dataclasses.dataclass(frozen=True)
class Cameras:
    """A batch of cameras; tensors are ``[C, ...]``."""

    camera_to_worlds: torch.Tensor  # [C, 3, 4]
    fx: torch.Tensor  # [C]
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int = 0
    height: int = 0
    camera_type: int = int(CameraType.PERSPECTIVE)

    @property
    def num_cameras(self) -> int:
        return self.camera_to_worlds.shape[0]

    def to(self, device) -> "Cameras":
        return dataclasses.replace(
            self,
            camera_to_worlds=self.camera_to_worlds.to(device),
            fx=self.fx.to(device), fy=self.fy.to(device),
            cx=self.cx.to(device), cy=self.cy.to(device),
        )

    def generate_rays(self, camera_index: int) -> RayBundle:
        """Full-image ray bundle, row-major flattened [H*W]."""
        dev = self.camera_to_worlds.device
        ys = torch.arange(self.height, dtype=torch.float32, device=dev) + 0.5
        xs = torch.arange(self.width, dtype=torch.float32, device=dev) + 0.5
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        coords = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)
        idx = torch.full((coords.shape[0],), camera_index, dtype=torch.int64, device=dev)
        return self.generate_rays_at(idx, coords)

    def generate_rays_at(self, camera_indices: torch.Tensor, pixel_coords: torch.Tensor) -> RayBundle:
        """Rays at (row, col) pixel-centre coordinates ``pixel_coords`` [N, 2]."""
        cam_idx = torch.as_tensor(camera_indices, device=pixel_coords.device).long()
        cam_idx = cam_idx.expand(pixel_coords.shape[:1])
        c2w = self.camera_to_worlds[cam_idx]  # [N, 3, 4]
        fx, fy = self.fx[cam_idx], self.fy[cam_idx]
        cx, cy = self.cx[cam_idx], self.cy[cam_idx]
        v, u = pixel_coords[..., 0], pixel_coords[..., 1]
        if self.camera_type == int(CameraType.PERSPECTIVE):
            dir_x = (u - cx) / fx
            dir_y = -(v - cy) / fy
            dir_z = -torch.ones_like(dir_x)
            pixel_area = ((1.0 / fx) * (1.0 / fy))[..., None]
        elif self.camera_type == int(CameraType.EQUIRECTANGULAR):
            # nerfstudio's panorama in y-up camera space: the width is 2·cx,
            # θ = −2π·u/width the azimuth, φ = π·v/height the polar angle
            # from the image's top row
            theta = -2.0 * math.pi * (u / (2.0 * cx))
            phi = math.pi * (v / (2.0 * cy))
            dir_x = torch.sin(phi) * torch.sin(theta)
            dir_y = torch.cos(phi)
            dir_z = torch.sin(phi) * torch.cos(theta) * -1.0
            pixel_area = (math.pi / (2.0 * cy) * 2.0 * math.pi / (2.0 * cx) * torch.sin(phi))[..., None]
        else:
            raise ValueError(f"unknown camera type {self.camera_type}")
        dirs_cam = torch.stack([dir_x, dir_y, dir_z], dim=-1)
        dirs_world = torch.einsum("nij,nj->ni", c2w[..., :3, :3], dirs_cam)
        norm = torch.linalg.norm(dirs_world, dim=-1, keepdim=True)
        dirs_world = dirs_world / norm
        return RayBundle.create(
            origins=c2w[..., :3, 3],
            directions=dirs_world,
            pixel_area=pixel_area,
            camera_indices=cam_idx[..., None],
            directions_norm=norm,
        )
