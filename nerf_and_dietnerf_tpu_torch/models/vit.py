"""ViT-B/32 image feature extractor (DietNeRF's frozen embedder).

Port of ``nerf_and_dietnerf_tpu/models/vit.py``: a parameter tree of tensors
and plain functions on it, as ``models/mlp.py`` is. The architecture is the
TF-Hub ``vit_b32_fe`` layout: 224x224 input, 32x32 patches -> 7x7 = 49 tokens
+ [CLS]; 12 pre-LN transformer blocks, hidden 768, 12 heads, MLP 3072, exact
GELU; learned position embeddings; a final LayerNorm; the feature is the
[CLS] row.

Casts follow the JAX package: each dense layer rounds its operands to
``compute_dtype`` and sums their products in f32 (``preferred_element_type``
there; here the rounded operands are multiplied as f32), the q.k logits and
the softmax are f32, and the attention-weighted values are rounded to
``compute_dtype`` again.

Weights: :func:`load_pretrained` reads an ``.npz`` in this module's flat
naming (:func:`save_npz`, optionally with the geometry embedded), or an HF
``transformers`` ViT state dict (``.safetensors``, or a torch ``.bin``). No
pretrained checkpoint ships with the repository.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from nerf_and_dietnerf_tpu_torch.models.mlp import params_from_jax, round_to  # noqa: F401
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_map, tree_unflatten

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    ln_eps: float = 1e-6  # HF ViTConfig defaults to 1e-12; google JAX ViT 1e-6

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.n_heads


BLOCK_DENSE = ("q", "k", "v", "proj", "mlp1", "mlp2")


def init_params(generator: torch.Generator, config: ViTConfig = ViTConfig(),
                device="cpu") -> Params:
    """Random parameters drawn from a CPU ``generator`` (normal kernels
    scaled by ``(fan_in + fan_out) ** -0.5``, zero biases, unit LayerNorm
    scales), placed on ``device``. The draws differ from the JAX package's:
    tests carry its parameters across with :func:`params_from_jax`."""
    h, p = config.hidden_dim, config.patch_size

    def dense(d_in, d_out):
        return {"kernel": torch.randn((d_in, d_out), generator=generator) * (d_in + d_out) ** -0.5,
                "bias": torch.zeros(d_out)}

    def ln():
        return {"scale": torch.ones(h), "bias": torch.zeros(h)}

    params: Params = {
        "patch_embed": dense(3 * p * p, h),
        "cls_token": torch.randn((1, 1, h), generator=generator) * 0.02,
        "pos_embed": torch.randn((1, config.n_patches + 1, h), generator=generator) * 0.02,
        "final_ln": ln(),
        "blocks": [],
    }
    widths = {"q": (h, h), "k": (h, h), "v": (h, h), "proj": (h, h),
              "mlp1": (h, config.mlp_dim), "mlp2": (config.mlp_dim, h)}
    for _ in range(config.n_layers):
        block = {name: dense(*widths[name]) for name in BLOCK_DENSE}
        block.update(ln1=ln(), ln2=ln())
        params["blocks"].append(block)
    return tree_map(lambda t: t.to(device), params)


def _layer_norm(p, x, eps):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _dense(p, x, dtype):
    return round_to(x, dtype) @ round_to(p["kernel"], dtype) + p["bias"]


def _attention(block, x, config: ViTConfig, dtype):
    b, t, h = x.shape
    nh, hd = config.n_heads, config.head_dim

    def heads(name):  # (b, nh, t, hd)
        return _dense(block[name], x, dtype).reshape(b, t, nh, hd).transpose(1, 2)

    q, k, v = heads("q"), heads("k"), heads("v")
    attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    out = round_to(round_to(attn, dtype) @ round_to(v, dtype), dtype)
    return _dense(block["proj"], out.transpose(1, 2).reshape(b, t, h), dtype)


def extract_features(params: Params, images: torch.Tensor, config: ViTConfig = ViTConfig(),
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Image batch -> [CLS] features.

    :param images: ``(b, image_size, image_size, 3)`` preprocessed to
        ``[-1, 1]`` (:func:`preprocess`).
    :return: ``(b, hidden_dim)`` float32.
    """
    b = images.shape[0]
    p, h = config.patch_size, config.hidden_dim
    g = config.image_size // p
    # Patchify: (b, g, p, g, p, 3) -> (b, g*g, p*p*3).
    x = images.float().reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(
        b, g * g, p * p * 3)
    x = _dense(params["patch_embed"], x, compute_dtype)
    cls = params["cls_token"].expand(b, 1, h)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]

    eps = config.ln_eps
    for block in params["blocks"]:
        x = x + _attention(block, _layer_norm(block["ln1"], x, eps), config, compute_dtype)
        y = _layer_norm(block["ln2"], x, eps)
        y = F.gelu(_dense(block["mlp1"], y, compute_dtype), approximate="none")
        x = x + _dense(block["mlp2"], y, compute_dtype)

    x = _layer_norm(params["final_ln"], x, eps)
    return x[:, 0].float()


def _resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """``(n_in, n_out)`` weights of a 1-D bilinear resize, with a triangle
    filter of the scale's width when it shrinks (``jax.image.resize``'s
    antialiasing), taken from ``F.interpolate`` applied to the identity."""
    eye = torch.eye(n_in, dtype=torch.float32, device=device).reshape(n_in, 1, 1, n_in)
    out = F.interpolate(eye, size=(1, n_out), mode="bilinear", align_corners=False,
                        antialias=n_out < n_in)
    return out.reshape(n_in, n_out)


def preprocess(images: torch.Tensor, config: ViTConfig = ViTConfig()) -> torch.Tensor:
    """Resize to the ViT input size and map [0,1] -> [-1,1]
    (reference ``src/DietNeRF.py:272-279``); ``(h, w, 3)`` or ``(b, h, w, 3)``
    in, ``(b, size, size, 3)`` out. The resize is two products with 1-D
    weight matrices, so its backward is products too (no scatter with
    atomics on the GPU). It agrees with ``jax.image.resize(..., "bilinear")``
    to a few 1e-7 when it grows an axis or shrinks 256 to 224 (the flagship's
    images); at other shrinking ratios the two antialiasing filters differ by
    up to a few 1e-5."""
    return resize(images, config.image_size) * 2.0 - 1.0


def resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """:func:`preprocess`'s bilinear resize alone: ``(h, w, c)`` or
    ``(b, h, w, c)`` in, ``(b, size, size, c)`` f32 out."""
    if images.ndim == 3:
        images = images[None]
    h, w = images.shape[1:3]
    x = images.float()
    if h != size:
        x = torch.einsum("bhwc,hH->bHwc", x, _resize_matrix(h, size, x.device))
    if w != size:
        x = torch.einsum("bhwc,wW->bhWc", x, _resize_matrix(w, size, x.device))
    return x


# --------------------------------------------------------------------------- #
# Pretrained-weight import and export                                         #
# --------------------------------------------------------------------------- #

def _named_leaves(tree, prefix=""):
    """``(name, leaf)`` in :func:`tree_leaves` order, named as the JAX
    package's ``save_npz`` names them (``blocks.0.q.kernel``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in _named_leaves(t, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def load_pretrained(path, config: ViTConfig = ViTConfig(), device="cpu") -> Params:
    """Import ViT weights from a local file, placed on ``device``.

    Supported layouts:
    - ``.npz``: this module's flat naming (:func:`save_npz`; the JAX
      package's files are the same).
    - HF ``transformers`` ``google/vit-base-patch32-224-in21k`` state dict
      (``.safetensors``, needs the ``safetensors`` package, or a torch
      ``.bin``): names like
      ``vit.encoder.layer.{i}.attention.attention.query.weight``.
    """
    path = str(path)
    if path.endswith(".npz"):
        like = init_params(torch.Generator(), config)
        with np.load(path) as flat:
            leaves = [torch.from_numpy(np.asarray(flat[name], np.float32)).reshape(leaf.shape)
                      for name, leaf in _named_leaves(like)]
        params = tree_unflatten(like, leaves)
    elif path.endswith(".safetensors"):
        from safetensors.torch import load_file

        params = _from_hf_state_dict(load_file(path), config)
    else:
        params = _from_hf_state_dict(torch.load(path, map_location="cpu", weights_only=True),
                                     config)
    return tree_map(lambda t: t.to(device), params)


_CONFIG_KEY = "_vit_config"  # npz metadata: geometry of the saved backbone


def save_npz(path, params: Params, config: "ViTConfig | None" = None) -> None:
    """Export weights in the flat ``.npz`` layout :func:`load_pretrained`
    reads. With ``config``, the geometry is embedded in the file
    (:func:`infer_config`)."""
    flat = {name: leaf.detach().to("cpu", torch.float32).numpy()
            for name, leaf in _named_leaves(params)}
    if config is not None:
        flat[_CONFIG_KEY] = np.asarray(
            [config.image_size, config.patch_size, config.hidden_dim,
             config.n_layers, config.n_heads, config.mlp_dim], np.int64)
    np.savez(path, **flat)


def infer_config(path) -> "ViTConfig | None":
    """The geometry embedded by :func:`save_npz`, or None when the file is
    not an npz or carries none (HF checkpoints are always B/32)."""
    path = str(path)
    if not path.endswith(".npz"):
        return None
    with np.load(path) as flat:
        if _CONFIG_KEY not in flat:
            return None
        vals = [int(v) for v in flat[_CONFIG_KEY]]
    return ViTConfig(image_size=vals[0], patch_size=vals[1], hidden_dim=vals[2],
                     n_layers=vals[3], n_heads=vals[4], mlp_dim=vals[5])


def _from_hf_state_dict(sd, config: ViTConfig) -> Params:
    """Map HF ``ViTModel`` parameter names onto this module's tree."""
    pre = "vit." if any(k.startswith("vit.") for k in sd) else ""

    def a(name):
        return torch.as_tensor(np.asarray(sd[name], np.float32))

    def dense(name):  # torch Linear stores (out, in); the tree holds (in, out)
        return {"kernel": a(name + ".weight").T.contiguous(), "bias": a(name + ".bias")}

    def ln(name):
        return {"scale": a(name + ".weight"), "bias": a(name + ".bias")}

    h = config.hidden_dim
    conv = a(f"{pre}embeddings.patch_embeddings.projection.weight")
    # HF conv kernel (h, 3, p, p); the patch rows are (p, p, 3) flattened.
    params: Params = {
        "patch_embed": {"kernel": conv.permute(2, 3, 1, 0).reshape(-1, h).contiguous(),
                        "bias": a(f"{pre}embeddings.patch_embeddings.projection.bias")},
        "cls_token": a(f"{pre}embeddings.cls_token"),
        "pos_embed": a(f"{pre}embeddings.position_embeddings"),
        "final_ln": ln(f"{pre}layernorm"),
        "blocks": [],
    }
    hf = {"q": "attention.attention.query", "k": "attention.attention.key",
          "v": "attention.attention.value", "proj": "attention.output.dense",
          "mlp1": "intermediate.dense", "mlp2": "output.dense"}
    for i in range(config.n_layers):
        b = f"{pre}encoder.layer.{i}."
        block = {name: dense(b + hf[name]) for name in BLOCK_DENSE}
        block.update(ln1=ln(b + "layernorm_before"), ln2=ln(b + "layernorm_after"))
        params["blocks"].append(block)
    return params
