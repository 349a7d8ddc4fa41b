"""The benchmark's scene: an analytic sphere seen by a ring of cameras.

A unit sphere coloured by its normal (0.5 + 0.5 n) on a black background,
rendered exactly in numpy, so every view agrees with every other. Camera
conventions are the configs' (pixel centres at +0.5, y up, the camera looking
down -z, ``tan(fov / 2)``). The Alexander scene of the source configs is not
in the repository; this scene stands in for it at the same view count and
frame size, and the traffic is the same work on any scene.
"""

from __future__ import annotations

import math

import numpy as np


def look_at(pos) -> np.ndarray:
    """The c2w matrix of a camera at ``pos`` looking at the origin."""
    pos = np.asarray(pos, np.float64)
    z = pos / np.linalg.norm(pos)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, pos
    return c2w


def sphere_view(pos, size: int, fov: float):
    """``(c2w, image (size, size, 3))`` of the camera at ``pos``."""
    c2w = look_at(pos)
    u = (np.arange(size) + 0.5) / size
    xs, ys = np.meshgrid((2 * u - 1) * math.tan(fov / 2), (1 - 2 * u) * math.tan(fov / 2))
    d = np.stack([xs, ys, -np.ones_like(xs)], -1) @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b = (d * c2w[:3, 3]).sum(-1)
    disc = b * b - (c2w[:3, 3] @ c2w[:3, 3] - 1.0)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    normal = c2w[:3, 3] + t[..., None] * d
    return c2w, np.where((disc > 0)[..., None], 0.5 + 0.5 * normal, 0.0)


def sphere_scene(spec: dict, seed: int):
    """``(images (n, size, size, 3) f32, poses (n, 4, 4) f32)`` of the
    configuration's ``scene``: ``n_images`` cameras on a ring of ``radius`` at
    ``height``, azimuths evenly spaced and jittered by up to ``jitter`` rad
    from ``seed``."""
    rng = np.random.default_rng(seed)
    n, size, fov = spec["n_images"], spec["size"], spec["fov"]
    poses, images = [], []
    for i in range(n):
        phi = 2 * math.pi * i / n + rng.uniform(-spec["jitter"], spec["jitter"])
        r = spec["radius"]
        c2w, image = sphere_view([r * math.sin(phi), spec["height"], r * math.cos(phi)], size, fov)
        poses.append(c2w)
        images.append(image)
    return np.asarray(images, np.float32), np.asarray(poses, np.float32)


def orbit_poses(spec: dict, count: int, seed: int) -> np.ndarray:
    """``count`` c2w matrices on the traffic's orbit: azimuth uniform, height
    uniform in ``[height_min, height_max]``, at ``radius``, looking at the
    origin."""
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0.0, 2 * math.pi, count)
    height = rng.uniform(spec["height_min"], spec["height_max"], count)
    r = spec["radius"]
    return np.asarray([look_at([r * math.sin(a), h, r * math.cos(a)])
                       for a, h in zip(phi, height)], np.float32)
