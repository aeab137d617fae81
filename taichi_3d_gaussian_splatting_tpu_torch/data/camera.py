"""Camera metadata dataclasses.

Copy of ``taichi_3d_gaussian_splatting_tpu/data/camera.py`` (numpy only;
importing it from the JAX package would import JAX). Camera frame: x right,
y down, z forward. Arrays are numpy on the host; they become tensors at the
trainer's boundary.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass
class CameraInfo:
    camera_intrinsics: np.ndarray  # (3, 3)
    camera_height: int
    camera_width: int
    camera_id: int

    # progressive-resolution downsampling lives in
    # data/dataset.py::downsample_item (box-average + tile crop, K scaled by
    # exactly 1/factor: the crop of bottom/right rows does not change the
    # focal length)


@dataclass
class CameraView:
    camera_view_id: int
    T_pointcloud_camera: np.ndarray  # (4, 4) camera->pointcloud frame
    camera_id: int
    image_id: int
    timestamp: Optional[int] = None


class CameraDatabase:
    def __init__(self):
        self.camera_info_dict: Dict[int, CameraInfo] = {}
        self.camera_view_dict: Dict[int, CameraView] = {}

    def add_camera_info(self, camera_info: CameraInfo) -> None:
        self.camera_info_dict[camera_info.camera_id] = camera_info

    def get_camera_info(self, camera_id: int) -> CameraInfo:
        return self.camera_info_dict[camera_id]

    def add_camera_view(self, camera_view: CameraView) -> None:
        self.camera_view_dict[camera_view.camera_view_id] = camera_view

    def get_camera_view_and_info(
        self, camera_view_id: int
    ) -> Tuple[CameraView, CameraInfo]:
        view = self.camera_view_dict[camera_view_id]
        return view, self.camera_info_dict[view.camera_id]
