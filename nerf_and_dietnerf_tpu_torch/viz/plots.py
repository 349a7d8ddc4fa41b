"""Diagnostic plots: per-epoch panel, per-ray value plots, interpolation grid.

Same artifact layout as the reference (``src/UtilsPlots.py``):
``plot_iteration_images/train_iteration_plots_{:03}.jpg`` per epoch,
``special_plots/`` for the ray-value and interpolation figures.
Matplotlib runs with the Agg backend (host only, never in the train path)
and is imported only inside :func:`_plt`. A copy of
``nerf_and_dietnerf_tpu/viz/plots.py`` (numpy and matplotlib only).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

import numpy as np

PLOT_ITERATION_DIRNAME = "plot_iteration_images"       # reference src/ExecutionRun.py:42
SPECIAL_PLOTS_DIRNAME = "special_plots"                # reference src/ExecutionRun.py:44
EPOCH_PLOT_FORMAT = "train_iteration_plots_{:03d}.jpg"  # reference src/UtilsPlots.py:17
TEST_IMG_FILENAME = "test_img.jpg"                      # reference src/UtilsPlots.py:16


def save_test_image(save_dir, image: np.ndarray) -> Path:
    """Snapshot of the held-out test view, saved once at training start
    (reference ``src/ExecutionRun.py:177`` -> ``src/UtilsPlots.py:33-45``)."""
    plt = _plt()
    out_dir = Path(save_dir) / PLOT_ITERATION_DIRNAME
    out_dir.mkdir(parents=True, exist_ok=True)
    fig = plt.figure()
    plt.title("Test Image")
    plt.imshow(np.clip(image, 0, 1))
    path = out_dir / TEST_IMG_FILENAME
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return path


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_epoch_plot(
    save_dir,
    epoch: int,
    train_image: np.ndarray,
    train_render: np.ndarray,
    test_image: np.ndarray,
    test_render: np.ndarray,
    psnrs_train: Sequence[float],
    psnrs_test: Sequence[float],
) -> Path:
    """The 2x3 per-epoch panel: dataset image / render / PSNR curve for the
    train row and the test row (reference ``src/UtilsPlots.py:155-203``)."""
    plt = _plt()
    out_dir = Path(save_dir) / PLOT_ITERATION_DIRNAME
    out_dir.mkdir(parents=True, exist_ok=True)

    fig, axes = plt.subplots(2, 3, figsize=(14, 8))
    rows = (
        ("train", train_image, train_render, psnrs_train),
        ("test", test_image, test_render, psnrs_test),
    )
    for row, (name, img, render, psnrs) in enumerate(rows):
        axes[row, 0].imshow(np.clip(img, 0, 1))
        axes[row, 0].set_title(f"{name} image")
        axes[row, 1].imshow(np.clip(render, 0, 1))
        axes[row, 1].set_title(f"{name} render (epoch {epoch})")
        axes[row, 2].plot(np.arange(1, len(psnrs) + 1), psnrs)
        axes[row, 2].set_title(
            f"{name} PSNR: {psnrs[-1]:.2f} dB" if len(psnrs) else f"{name} PSNR"
        )
        axes[row, 2].set_xlabel("epoch")
        axes[row, 2].set_ylabel("PSNR [dB]")
        axes[row, 2].grid(True)
        for col in (0, 1):
            axes[row, col].axis("off")
    fig.tight_layout()
    path = out_dir / EPOCH_PLOT_FORMAT.format(epoch)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


# --------------------------------------------------------------------------- #
# Ray-value diagnostics                                                        #
# --------------------------------------------------------------------------- #

def slice_out_rays(ray_coords: np.ndarray, *arrays):
    """Select the per-sample records of specific pixels from (h, w, ...) maps
    (reference ``src/UtilsPlots.py:348-367``)."""
    idx = tuple(np.asarray(ray_coords).T)
    return tuple(np.asarray(a)[idx] for a in arrays)


def rebin_ray_samples(
    n_bins: int,
    z: np.ndarray,
    weights: np.ndarray,
    cumprod: np.ndarray,
    alpha: np.ndarray,
    sample_rgb: np.ndarray,
):
    """Re-bin hierarchically-sampled per-ray values onto a uniform z grid.

    Sample z's are *sorted* per ray, so each uniform bin covers a contiguous
    run of samples; per bin: weights are summed, transmittance multiplied,
    alpha summed then clipped to [0, 1], rgb averaged — matching
    ``src/UtilsPlots.py:311-345`` (which does the same via masked slicing).

    :param z: ``(rays, samples)`` sorted sample depths.
    :return: ``(alpha_b, cumprod_b, rgb_b, weights_b, bin_centers)`` each
        ``(rays, n_bins)`` (rgb: ``(rays, n_bins, 3)``).
    """
    n_rays, _ = z.shape
    alpha_b = np.zeros((n_rays, n_bins))
    cum_b = np.ones((n_rays, n_bins))
    w_b = np.zeros((n_rays, n_bins))
    rgb_b = np.zeros((n_rays, n_bins, 3))
    centers = np.zeros((n_rays, n_bins))
    for r in range(n_rays):
        counts, edges = np.histogram(z[r], bins=n_bins)
        centers[r] = 0.5 * (edges[:-1] + edges[1:])
        stop = np.cumsum(counts)
        start = np.concatenate([[0], stop[:-1]])
        for b in range(n_bins):
            sl = slice(start[b], stop[b])
            if stop[b] > start[b]:
                w_b[r, b] = weights[r, sl].sum()
                cum_b[r, b] = np.prod(cumprod[r, sl])
                alpha_b[r, b] = np.clip(alpha[r, sl].sum(), 0, 1)
                rgb_b[r, b] = sample_rgb[r, sl].mean(axis=0)
    return alpha_b, cum_b, rgb_b, w_b, centers


def save_ray_value_plots(
    save_dir,
    render_image: np.ndarray,
    ray_coords: np.ndarray,
    weights_b: np.ndarray,
    cumprod_b: np.ndarray,
    alpha_b: np.ndarray,
    rgb_b: np.ndarray,
    epoch: int,
) -> List[Path]:
    """One figure per selected ray: alpha / weights / transmittance vs bin,
    scatter colored by the per-bin rgb, with the image patch around the pixel
    inset for context (reference ``src/UtilsPlots.py:48-152``)."""
    plt = _plt()
    out_dir = Path(save_dir) / SPECIAL_PLOTS_DIRNAME
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    h, w = render_image.shape[:2]
    for r, (py, px) in enumerate(np.asarray(ray_coords)):
        fig, axes = plt.subplots(1, 4, figsize=(18, 4))
        series = (
            ("alpha", alpha_b[r]),
            ("weights", weights_b[r]),
            ("transmittance", cumprod_b[r]),
        )
        colors = np.clip(rgb_b[r], 0, 1)
        x = np.arange(len(alpha_b[r]))
        for ax, (name, values) in zip(axes, series):
            ax.scatter(x, values, c=colors, s=18)
            ax.plot(x, values, alpha=0.4)
            ax.set_title(f"{name} along ray ({py},{px})")
            ax.set_xlabel("z bin")
            ax.grid(True)
        y0, y1 = max(0, py - 8), min(h, py + 9)
        x0, x1 = max(0, px - 8), min(w, px + 9)
        axes[3].imshow(np.clip(render_image[y0:y1, x0:x1], 0, 1))
        axes[3].scatter([px - x0], [py - y0], marker="x", c="red")
        axes[3].set_title("image patch")
        axes[3].axis("off")
        fig.tight_layout()
        path = out_dir / f"ray_values_epoch_{epoch:03d}_ray_{py}_{px}.jpg"
        fig.savefig(path, dpi=110)
        plt.close(fig)
        paths.append(path)
    return paths


def save_interpolation_plot(
    save_dir,
    image1: np.ndarray,
    image2: np.ndarray,
    rendered: Sequence[np.ndarray],
) -> Path:
    """Two dataset views flanking the slerp-interpolated renders, 2 rows
    (reference ``src/UtilsPlots.py:245-277``)."""
    plt = _plt()
    out_dir = Path(save_dir) / SPECIAL_PLOTS_DIRNAME
    out_dir.mkdir(parents=True, exist_ok=True)

    frames = [image1, *rendered, image2]
    cols = (len(frames) + 1) // 2
    fig, axes = plt.subplots(2, cols, figsize=(2.2 * cols, 5))
    for ax in axes.ravel():
        ax.axis("off")
    for i, frame in enumerate(frames):
        ax = axes[i // cols, i % cols]
        ax.imshow(np.clip(frame, 0, 1))
        if i == 0:
            ax.set_title("view 1")
        elif i == len(frames) - 1:
            ax.set_title("view 2")
    fig.tight_layout()
    path = out_dir / "interpolation_between_2_images.jpg"
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
