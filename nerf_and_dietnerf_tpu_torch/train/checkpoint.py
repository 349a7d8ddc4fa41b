"""Checkpointing: full train-state saves + Keras ``.h5`` interop.

Port of ``nerf_and_dietnerf_tpu/train/checkpoint.py``:

- ``.h5`` import/export in the reference's ``saved_weights/
  NeRF_model_epoch_{:03}.h5`` layout: each sub-model (``model``, ``model_1``)
  holds its Dense layers in creation order (trunk x 8, then rgb_hidden,
  rgb_out, sigma_out; or rgb_hidden0, rgb_hidden, rgb_out, sigma_out for the
  xyz-only variant). h5py is imported only inside these functions.
- The full train state (params, Adam moments and count, step) saved with
  ``torch.save`` per step, with an atomically replaced ``latest`` pointer, in
  place of Orbax.
- The ``(2, E)`` [test; train] PSNR history as npy.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from nerf_and_dietnerf_tpu_torch.models.mlp import N_TRUNK_LAYERS, MLPConfig

Params = Dict[str, Any]

WEIGHTS_DIRNAME = "saved_weights"
H5_FILENAME_FORMAT = "NeRF_model_epoch_{:03d}.h5"
PSNR_DIRNAME = "saved_test_train_psnrs"
PSNR_FILENAME_FORMAT = "psnrs_train_test_{:03d}.npy"


def nerf_h5_path(save_location, epoch: int) -> Path:
    return Path(save_location) / WEIGHTS_DIRNAME / H5_FILENAME_FORMAT.format(epoch)


def psnr_path(save_location, epoch: int) -> Path:
    return Path(save_location) / PSNR_DIRNAME / PSNR_FILENAME_FORMAT.format(epoch)


def _mlp_leaf_order(config: MLPConfig):
    trunk = [("trunk", i) for i in range(N_TRUNK_LAYERS)]
    if config.uses_view_dirs:
        return trunk + [("rgb_hidden",), ("rgb_out",), ("sigma_out",)]
    return trunk + [("rgb_hidden0",), ("rgb_hidden",), ("rgb_out",), ("sigma_out",)]


def _get_leaf(params: Params, key):
    return params[key[0]][key[1]] if len(key) == 2 else params[key[0]]


def load_keras_h5(path, config: MLPConfig, has_fine: bool = True, device="cpu") -> Params:
    """A reference-format ``.h5`` -> ``{"coarse": ..., "fine": ... | None}``."""
    import h5py

    def dense_index(name: str) -> int:
        m = re.search(r"dense(?:_(\d+))?$", name)
        return int(m.group(1)) if m and m.group(1) else 0

    out: Params = {}
    with h5py.File(path, "r") as f:
        model_groups = sorted((k for k in f.keys() if len(f[k].keys()) > 0),
                              key=lambda k: (len(k), k))
        for which, group_name in zip(("coarse", "fine"), model_groups):
            group = f[group_name]
            layers = sorted(group.keys(), key=dense_index)
            params_one: Params = {"trunk": [None] * N_TRUNK_LAYERS}
            for key, layer in zip(_mlp_leaf_order(config), layers):
                leaf = {
                    "kernel": torch.tensor(np.array(group[layer]["kernel:0"], np.float32),
                                           device=device),
                    "bias": torch.tensor(np.array(group[layer]["bias:0"], np.float32),
                                         device=device),
                }
                if len(key) == 2:
                    params_one[key[0]][key[1]] = leaf
                else:
                    params_one[key[0]] = leaf
            out[which] = params_one
    if "coarse" not in out:
        raise ValueError(f"no model groups found in {path}")
    out.setdefault("fine", None)
    if not has_fine:
        out["fine"] = None
    return out


def save_keras_h5(path, params: Params, config: MLPConfig) -> None:
    """Write parameters in the reference's ``.h5`` layout."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    groups = [("model", params["coarse"])]
    if params.get("fine") is not None:
        groups.append(("model_1", params["fine"]))
    dense_counter = 0
    with h5py.File(path, "w") as f:
        f.attrs["backend"] = "tensorflow"
        f.attrs["layer_names"] = np.array([g[0] for g in groups], dtype=h5py.string_dtype())
        for group_name, params_one in groups:
            g = f.create_group(group_name)
            for key in _mlp_leaf_order(config):
                leaf = _get_leaf(params_one, key)
                layer_name = "dense" if dense_counter == 0 else f"dense_{dense_counter}"
                dense_counter += 1
                lg = g.create_group(layer_name)
                for name in ("kernel", "bias"):
                    lg.create_dataset(f"{name}:0", data=leaf[name].detach().to(
                        "cpu", torch.float32).numpy())


class CheckpointManager:
    """Per-step full-train-state saves (``step_{n}.pt``) and an atomically
    replaced ``latest`` file naming the newest step."""

    LATEST = "latest"

    def __init__(self, directory):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)

    def _path(self, step: int) -> Path:
        return self._dir / f"step_{step}.pt"

    def save(self, step: int, state) -> None:
        tmp = self._dir / f".step_{step}.pt.tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        tmp_latest = self._dir / f".{self.LATEST}.tmp"
        tmp_latest.write_text(str(step))
        os.replace(tmp_latest, self._dir / self.LATEST)

    def restore(self, step: Optional[int] = None, map_location=None):
        """The saved state of ``step`` (default: the latest), or None."""
        step = self.latest_step() if step is None else step
        if step is None or not self._path(step).exists():
            return None
        return torch.load(self._path(step), map_location=map_location, weights_only=False)

    def latest_step(self) -> Optional[int]:
        latest = self._dir / self.LATEST
        return int(latest.read_text()) if latest.exists() else None


def save_psnr_history(save_location, epoch: int, psnrs_test, psnrs_train) -> None:
    path = psnr_path(save_location, epoch)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(str(path), (np.asarray(psnrs_test), np.asarray(psnrs_train)))


def load_psnr_history(save_location, epoch: int):
    path = psnr_path(save_location, epoch)
    if path.exists():
        test, train = np.load(str(path))
        return list(test), list(train)
    return [], []
