"""Weights from the seed, made on the device in one draw a tree.

The trees have the program's layout (``models/mlp.py``): dense kernels
``(fan_in, fan_out)`` float32, the master type of both the bfloat16 and the
float32 configurations, Glorot-uniform with zero biases (the Keras Dense
default the source trains from). The reference is handed the same trees.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def mlp_dims(cfg: dict) -> Dict:
    """The radiance MLP's widths and the render settings of a configuration."""
    lx, ld, angles = cfg["n_pos_enc_dim_xyz"], cfg["n_pos_enc_view_dir"], cfg["n_angles_for_model"]
    if angles != 2:
        raise ValueError("the benchmark's configurations read three direction components")
    return {"xyz": 3 + 6 * lx, "dir": 2 * ld * (angles + 1), "hidden": cfg["hidden_layer_dim"],
            "last": cfg["last_hidden_layer_dim"], "n_freq_xyz": lx, "n_freq_dir": ld,
            "leaky_alpha": cfg["leaky_relu_alpha"], "near": cfg["near_depth_render"],
            "far": cfg["far_depth_render"]}


def mlp_shapes(dims: Dict) -> List[Tuple[str, int, int]]:
    """``(name, fan_in, fan_out)`` of every dense layer of one network."""
    h, x = dims["hidden"], dims["xyz"]
    trunk = [(f"trunk.{i}", x if i == 0 else (x + h if i == 4 else h), h) for i in range(8)]
    feat = h + dims["dir"]
    return trunk + [("rgb_hidden", feat, dims["last"]), ("rgb_out", dims["last"], 3),
                    ("sigma_out", feat, 1)]


def _split(flat: torch.Tensor, sizes):
    out, at = [], 0
    for n in sizes:
        out.append(flat[at:at + n])
        at += n
    return out


def nerf_params(dims: Dict, seed: int, device) -> Dict:
    """``{"coarse": mlp, "fine": mlp}``: one uniform draw for both networks."""
    shapes = mlp_shapes(dims)
    sizes = [i * o for _, i, o in shapes] * 2
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    parts = iter(_split(flat, sizes))
    tree = {}
    for net in ("coarse", "fine"):
        p = {"trunk": []}
        for name, fi, fo in shapes:
            dense = {"kernel": (next(parts).view(fi, fo) * math.sqrt(6.0 / (fi + fo))).contiguous(),
                     "bias": torch.zeros(fo, device=device)}
            if name.startswith("trunk"):
                p["trunk"].append(dense)
            else:
                p[name] = dense
        tree[net] = p
    return tree
