"""Video writers: rendered-frame videos and the per-epoch-plot video.

Same on-disk conventions as the reference (``src/UtilsVideo.py``): MJPG
``.avi`` via OpenCV, frames in [0, 1] RGB converted to BGR uint8. OpenCV is
imported only inside the writers. A copy of ``nerf_and_dietnerf_tpu/viz/video.py``.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List

import numpy as np

FILENAME_RGB_L_TO_R = "render_l_to_r_rgb.avi"
FILENAME_DEPTH_L_TO_R = "render_l_to_r_depths.avi"
FILENAME_RGB_SPHERE = "render_sphere_rgb.avi"
FILENAME_DEPTH_SPHERE = "render_sphere_depths.avi"
FILENAME_RGB_PATH = "render_path_rgb.avi"
FILENAME_DEPTH_PATH = "render_path_depths.avi"
FILENAME_TRAIN_SET = "train_set_video.avi"
FILENAME_PLOTS = "plots_video.avi"


def save_frames_as_video(filename, frames, fps: int) -> None:
    """Write [0,1]-valued RGB (or grayscale) frames as an MJPG ``.avi``
    (reference ``src/UtilsVideo.py:16-39``)."""
    import cv2

    frames = list(frames)
    assert frames, "no frames to write"
    filename = Path(filename)
    filename.parent.mkdir(parents=True, exist_ok=True)

    first = np.asarray(frames[0])
    height, width = first.shape[0], first.shape[1]
    writer = cv2.VideoWriter(
        str(filename), cv2.VideoWriter_fourcc(*"MJPG"), fps, (width, height)
    )
    for frame in frames:
        frame = np.asarray(frame)
        if frame.ndim == 2:
            frame = np.repeat(frame[..., None], 3, axis=-1)
        if frame.shape[:2] != (height, width):
            # cv2.VideoWriter silently drops wrong-sized frames (an FFmpeg
            # warning on stderr is all you get) — fail loudly instead.
            writer.release()
            raise ValueError(
                f"frame size {frame.shape[:2]} != video size {(height, width)}"
            )
        frame = np.uint8(np.round(np.clip(frame, 0.0, 1.0) * 255))
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def _numbered_images_in(directory) -> List[str]:
    """Numbered image files sorted by the trailing number in their stem.

    Only files whose name ends in a number are plot frames (reference
    ``src/UtilsPlots.py:15,206-218`` — ``PLOT_FILENAME_PATTERN`` requires a
    trailing digit before ``.jpg``). The unnumbered ``test_img.jpg`` snapshot
    lives in the same directory and must be excluded: its frame size differs
    from the epoch plots, and an odd-sized first frame mis-sizes the video
    writer so every real plot frame fails to write (caught end-to-end:
    1-frame plots_video.avi)."""
    def order(name):
        m = re.search(r"(\d+)\D*$", Path(name).stem)
        return int(m.group(1)) if m else None

    return sorted(
        (
            f for f in os.listdir(directory)
            if f.endswith((".jpg", ".png")) and order(f) is not None
        ),
        key=order,
    )


def save_plot_video(fps: int, plots_dir, out_path, downscale: float = 2.5) -> None:
    """Assemble the per-epoch plot images into a video, downscaled
    (reference ``src/UtilsVideo.py:42-63``)."""
    import cv2

    plots_dir = Path(plots_dir)
    names = _numbered_images_in(plots_dir)
    if not names:
        print(f"no plots found in {plots_dir}; skipping plot video")
        return
    frames = []
    for name in names:
        img = cv2.cvtColor(cv2.imread(str(plots_dir / name)), cv2.COLOR_BGR2RGB)
        h, w = img.shape[:2]
        img = cv2.resize(
            img, dsize=(int(w / downscale), int(h / downscale)),
            interpolation=cv2.INTER_AREA,
        )
        frames.append(img.astype(np.float32) / 255.0)
    save_frames_as_video(out_path, frames, fps)
