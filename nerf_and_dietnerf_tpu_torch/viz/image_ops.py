"""Host-side image operations for diagnostics (histogram equalization).

Used to make rendered depth maps legible in the depth videos
(reference ``src/ExecutionRun.py:346-348``). NumPy on host — this runs on a
handful of frames, never in the training path. A copy of
``nerf_and_dietnerf_tpu/viz/image_ops.py``.
"""

from __future__ import annotations

import numpy as np

# YIQ conversion (reference ``src/UtilsCV.py:746-760``).
_RGB2YIQ = np.array(
    [[0.299, 0.587, 0.114],
     [0.59590059, -0.27455667, -0.32134392],
     [0.21153661, -0.52273617, 0.31119955]]
)


def rgb2yiq(im: np.ndarray) -> np.ndarray:
    return im @ _RGB2YIQ.T


def yiq2rgb(im: np.ndarray) -> np.ndarray:
    return im @ np.linalg.inv(_RGB2YIQ).T


def _equalize_gray(gray: np.ndarray):
    """Equalize a [0,1] grayscale image; returns values in [0,255]
    (reference ``src/UtilsCV.py:724-743``)."""
    if np.max(gray) == 0:
        return gray, None, None
    g = gray - np.min(gray)
    g = g / np.max(g) * 255.0
    hist, _ = np.histogram(g, np.arange(257))
    cum = np.cumsum(hist)
    first_nonzero = cum[np.nonzero(cum)[0][0]]
    lut = np.round((cum - first_nonzero) / (cum[-1] - first_nonzero) * 255.0)
    eq = lut[np.round(g).astype(int)]
    hist_eq, _ = np.histogram(eq, np.arange(257))
    return eq, hist, hist_eq


def histogram_equalize(image: np.ndarray):
    """Histogram-equalize a [0,1] grayscale or RGB image; RGB goes through the
    YIQ luma channel (reference ``src/UtilsCV.py:700-721``).

    :return: ``(equalized [0,1] image, original hist, equalized hist)``.
    """
    image = np.asarray(image, np.float64)
    if image.ndim == 3:
        yiq = rgb2yiq(image)
        eq, h0, h1 = _equalize_gray(yiq[..., 0])
        yiq[..., 0] = eq / 255.0
        return yiq2rgb(yiq), h0, h1
    eq, h0, h1 = _equalize_gray(image)
    return eq / 255.0, h0, h1
