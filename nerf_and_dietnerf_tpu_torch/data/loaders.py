"""Dataset loaders: Blender ``cam_data.json`` and COLMAP/LLFF ``poses_bounds.npy``.

Both loaders establish the invariant the whole pipeline depends on (reference
``src/UtilsFiles.py:35-130``): poses are recentered on the average camera,
then every camera position is scaled into the unit sphere with the near/far
bounds scaled by the same factor. Returned images are float32 in [0, 1].
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path, PureWindowsPath
from typing import Optional

import numpy as np

from nerf_and_dietnerf_tpu_torch.core import pose_math

CAM_DATA_JSON = "cam_data.json"       # reference src/UtilsFiles.py:25
POSES_BOUNDS_NPY = "poses_bounds.npy"  # reference src/UtilsFiles.py:20


@dataclasses.dataclass
class Dataset:
    """Loaded scene: the 7-tuple the reference loaders return
    (``src/UtilsFiles.py:69-70, :95-96``) as a named structure."""

    images: np.ndarray          # (N, h, w, 3) float32 in [0, 1]
    camera_poses: np.ndarray    # (N, 4, 4) float32 c2w
    field_of_view: float        # radians
    near: float
    far: float
    average_c2w_before_recenter: np.ndarray  # (4, 4)
    scale: float                # unit-sphere scale factor

    @property
    def height(self) -> int:
        return self.images.shape[1]

    @property
    def width(self) -> int:
        return self.images.shape[2]

    def __len__(self) -> int:
        return self.images.shape[0]


def _imread(path) -> np.ndarray:
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path))


def load_blender(dataset_dir, near: float, far: float) -> Dataset:
    """Load a Blender-rendered scene described by ``cam_data.json``
    ({focal_length, field_of_view, frames: [{filename, transformation_matrix}]}
    — produced by ``DatasetUtils/blender_create_pictures.py:120-130``).

    Reference behavior: ``src/UtilsFiles.py:35-70`` — images divided by 255,
    recenter + spherify with the config-supplied near/far bounds scaled along.
    """
    dataset_dir = Path(dataset_dir)
    with open(dataset_dir / CAM_DATA_JSON) as f:
        meta = json.load(f)

    poses = []
    images = []
    for frame in meta["frames"]:
        poses.append(np.asarray(frame["transformation_matrix"], np.float64))
        images.append(_imread(dataset_dir / frame["filename"]))
    images = np.asarray(images, np.float32) / 255.0
    poses = np.asarray(poses)

    poses, avg_c2w = pose_math.recenter_poses(poses)
    bounds = np.array([near, far], np.float64)
    poses, bounds, scale = pose_math.spherify_poses(poses, bounds)

    return Dataset(
        images=images[..., :3],
        camera_poses=poses.astype(np.float32),
        field_of_view=float(meta["field_of_view"]),
        near=float(bounds[0]),
        far=float(bounds[1]),
        average_c2w_before_recenter=avg_c2w,
        scale=float(scale),
    )


def load_colmap(dataset_dir) -> Dataset:
    """Load a real scene processed by COLMAP in the LLFF layout.

    ``poses_bounds.npy`` rows are 17 floats: a 3x5 ``[R | t | hwf]`` block plus
    near/far bounds. Axis convention is fixed from LLFF's ``[-y, x, z]`` to
    ``[x, y, z]`` by permuting columns and negating the second
    (reference ``src/UtilsFiles.py:99-130``), then recenter + spherify; final
    bounds are ``0.9 * min`` and ``1.0 * max`` (``src/UtilsFiles.py:87-88``),
    and fov is recovered from the focal length (``:91``).
    """
    dataset_dir = Path(dataset_dir)
    raw = np.load(dataset_dir / POSES_BOUNDS_NPY)
    poses_hwf = raw[:, :-2].reshape(-1, 3, 5)
    # LLFF stores [-y, x, z]; permute to [x, y, z] and restore the sign.
    poses_hwf = poses_hwf[:, :, [1, 0, 2, 3, 4]]
    poses_hwf[:, :, 1] = -poses_hwf[:, :, 1]
    bounds = raw[:, -2:]

    poses_hwf, avg_c2w = pose_math.recenter_poses(poses_hwf)
    poses_hwf, bounds, scale = pose_math.spherify_poses(poses_hwf, bounds)

    h, w, focal = poses_hwf[0, :3, 4]
    fov = float(np.arctan2(w / 2, focal) * 2)
    near = float(bounds.min()) * 0.9
    far = float(bounds.max()) * 1.0

    image_files = sorted(
        p
        for p in os.listdir(dataset_dir)
        if p.endswith(("JPG", "jpg", "png"))
    )
    images = np.asarray(
        [_imread(dataset_dir / p)[..., :3] for p in image_files], np.float32
    ) / 255.0

    poses = np.concatenate(
        [
            poses_hwf[:, :3, :4],
            np.broadcast_to(np.array([[0.0, 0.0, 0.0, 1.0]]), (len(poses_hwf), 1, 4)),
        ],
        axis=1,
    )
    return Dataset(
        images=images,
        camera_poses=poses.astype(np.float32),
        field_of_view=fov,
        near=near,
        far=far,
        average_c2w_before_recenter=avg_c2w,
        scale=float(scale),
    )


def load_dataset(
    dataset_type: str,
    dataset_location: str,
    near: Optional[float] = None,
    far: Optional[float] = None,
) -> Dataset:
    """Config-driven dispatch (reference ``src/ExecutionRun.py:104-113``).
    Accepts Windows-style paths from the stock YAML configs."""
    location = Path(PureWindowsPath(str(dataset_location)).as_posix())
    if dataset_type == "blender":
        if near is None or far is None:
            raise ValueError("blender datasets require near/far render bounds")
        return load_blender(location, near, far)
    if dataset_type == "colmap":
        return load_colmap(location)
    raise ValueError(f"unknown dataset_type: {dataset_type!r}")


def train_test_split_indices(n_images: int, test_idx: int, subset_indices=None):
    """Training indices: all but the held-out test image, optionally restricted
    to a few-shot subset (reference ``src/ExecutionRun.py:450-462``)."""
    if subset_indices:
        keep = set(subset_indices)
        return [i for i in range(n_images) if i != test_idx and i in keep]
    return [i for i in range(n_images) if i != test_idx]
