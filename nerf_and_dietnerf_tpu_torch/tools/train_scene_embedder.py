"""Self-supervised (SimCLR-lite) training of a small ViT embedder on a scene
corpus, written in ``models/vit.py``'s npz format for ``--vit-weights``.

The counterpart of the JAX package's ``tools/train_scene_embedder.py``, with
its flags, model, loss and schedule. DietNeRF's embedder is a frozen
pretrained ViT-B/32 (reference ``src/DietNeRF.py:14-15,72-79``); none is in
the repository and none can be downloaded, so this trains a small ViT on the
scenes' own images: two augmented views (a random-resized crop to 224,
flip, brightness and contrast) are the positive pair, the rest of the batch
the negatives, an NT-Xent loss on a 2-layer projection head. With
``--positives view`` the pair is two views of the same scene, the
view-invariance the consistency loss assumes.

    python -m nerf_and_dietnerf_tpu_torch.tools.train_scene_embedder --out scene_vit.npz
    python -m nerf_and_dietnerf_tpu_torch.tools.train_scene_embedder --device cpu \\
        --out /tmp/v.npz --scenes DIR_A DIR_B --corpus-size 64 --steps 4 --batch 4 \\
        --hidden 32 --layers 1 --heads 2 --mlp-dim 64

Runs on the GPU unless ``--device cpu`` is given. The default corpus is the
eight scenes of ``DEFAULT_CORPUS`` under ``Assets/``, which the repository
does not hold: until they are there, give ``--scenes`` directories of
``.png`` / ``.jpg`` views, one directory a scene. The random draws come from
``torch.Generator``s, not JAX's keys, so a run is not JAX's run; the tests
hold each piece against JAX with the draws passed in.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from nerf_and_dietnerf_tpu_torch.models import vit
from nerf_and_dietnerf_tpu_torch.train.train_step import Adam, apply_updates, loss_and_grads
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parents[2]

# 256px image sets of the eight scenes the JAX tool trains on.
DEFAULT_CORPUS = [
    "Assets/AlexanderColmap/256px_71pics",
    "Assets/DrillColmap3/256px_72pics",
    "Assets/FlowersColmap/256px_54pics",
    "Assets/GladiatorColmap2/256px_44pics",
    "Assets/PhoneColmap/256px_63pics",
    "Assets/RobotBlender/image_views_sphere/256px_72pics",
    "Assets/RobotRedBlender/image_views_sphere/256px_72pics",
    "Assets/FicusBlender/image_views_sphere/256px_72pics",
]

PROJ_DIM = 128                # the projection head's output width
CROP_SCALE = (0.4, 1.0)       # the crop window's side over the image's
JITTER = (0.6, 1.4)           # brightness and contrast factors
VIEW_OFFSETS = 1_000_000      # "view" partners: a draw in [0, this) modulo the scene's size
COSINE_ALPHA = 0.1            # the learning rate's floor, a share of --lr


# --------------------------------------------------------------------------- #
# The corpus                                                                   #
# --------------------------------------------------------------------------- #

def corpus_from_arrays(images, scene_ids, size: int):
    """``(images (N, size, size, 3) f32 in [0, 1], scene_ids (N,) int64)`` on the
    CPU: each ``(h, w, 3)`` image in [0, 1] resized alone (``vit.resize``),
    as the JAX tool resizes each with ``jax.image.resize``."""
    resized = [vit.resize(torch.as_tensor(np.asarray(im, np.float32)), size)[0]
               for im in images]
    return torch.stack(resized), torch.as_tensor(np.asarray(scene_ids, np.int64))


def load_corpus(dirs, size: int):
    """The ``.jpg`` / ``.png`` views of each directory (a scene each; relative
    paths from the repository's root), as :func:`corpus_from_arrays`."""
    import imageio.v2 as imageio

    images, scene_ids = [], []
    for sid, d in enumerate(dirs):
        d = Path(d) if Path(d).is_absolute() else REPO / d
        for p in sorted(p for p in d.iterdir() if p.suffix.lower() in (".jpg", ".png")):
            images.append(np.asarray(imageio.imread(p), np.float32)[..., :3] / 255.0)
            scene_ids.append(sid)
    return corpus_from_arrays(images, scene_ids, size)


# --------------------------------------------------------------------------- #
# Augmentation                                                                 #
# --------------------------------------------------------------------------- #

def crop_weights(n_in: int, n_out: int, scale: torch.Tensor,
                 translation: torch.Tensor) -> torch.Tensor:
    """``(b, n_in, n_out)``: the 1-D weights of ``jax.image.scale_and_translate``'s
    bilinear kernel, one matrix an image (``jax._src.image.scale.
    compute_weight_mat`` with ``antialias=True``): output ``i`` samples the
    input at ``(i + 0.5 - t) / s - 0.5`` with a triangle widened to
    ``max(1 / s, 1)``, the weights normalised over the input, zero where the
    sample lies outside it."""
    scale = scale.float()[:, None, None]
    translation = translation.float()[:, None, None]
    dev = scale.device
    inv = 1.0 / scale
    kernel_scale = torch.clamp_min(inv, 1.0)
    out = torch.arange(n_out, dtype=torch.float32, device=dev)[None, None, :]
    sample = (out + 0.5) * inv - translation * inv - 0.5                # (b, 1, n_out)
    src = torch.arange(n_in, dtype=torch.float32, device=dev)[None, :, None]
    w = torch.clamp_min(1.0 - torch.abs(sample - src) / kernel_scale, 0.0)
    total = torch.sum(w, dim=1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def augment_with(images: torch.Tensor, crop: torch.Tensor, y0: torch.Tensor,
                 x0: torch.Tensor, flip: torch.Tensor, brightness: torch.Tensor,
                 contrast: torch.Tensor, size_out: int = 224) -> torch.Tensor:
    """The JAX tool's augmentation with its draws given, one a image: a square
    window of side ``crop * size_in`` at ``(y0, x0)`` resized to ``size_out``
    (bilinear, antialiased when it shrinks), mirrored left-right where
    ``flip``, times ``brightness``, its contrast about each channel's mean
    scaled by ``contrast``, clipped to [0, 1] and mapped to [-1, 1].

    :param images: ``(b, size_in, size_in, 3)`` in [0, 1].
    :return: ``(b, size_out, size_out, 3)``.
    """
    size_in = images.shape[1]
    # A true division: ``size_out / t`` in torch multiplies by a reciprocal,
    # a last-place change of the scale that moves the weights by ~1e-5.
    s = torch.full_like(crop, size_out) / (crop * size_in)
    wy = crop_weights(size_in, size_out, s, -y0 * s)
    wx = crop_weights(size_in, size_out, s, -x0 * s)
    wx = torch.where(flip[:, None, None], wx.flip(-1), wx)
    out = torch.einsum("bhwc,bhH->bHwc", images.float(), wy)
    out = torch.einsum("bHwc,bwW->bHWc", out, wx)
    out = out * brightness[:, None, None, None]
    mean = torch.mean(out, dim=(1, 2), keepdim=True)
    out = torch.clamp((out - mean) * contrast[:, None, None, None] + mean, 0.0, 1.0)
    return out * 2.0 - 1.0


def draw_augment(generator: torch.Generator, n: int, size_in: int,
                 device) -> Dict[str, torch.Tensor]:
    """:func:`augment_with`'s draws for ``n`` images, the JAX tool's
    distributions: crop U(0.4, 1), offsets U(0, size_in - window), a fair
    flip, brightness and contrast U(0.6, 1.4)."""
    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand((n,), generator=generator, device=device)

    crop = u(*CROP_SCALE)
    room = size_in - crop * size_in
    return {"crop": crop, "y0": u() * room, "x0": u() * room, "flip": u() < 0.5,
            "brightness": u(*JITTER), "contrast": u(*JITTER)}


def augment(generator: torch.Generator, images: torch.Tensor, size_out: int = 224):
    """:func:`augment_with` on fresh draws from ``generator``."""
    return augment_with(images, **draw_augment(generator, images.shape[0], images.shape[1],
                                               images.device), size_out=size_out)


# --------------------------------------------------------------------------- #
# Model and loss                                                               #
# --------------------------------------------------------------------------- #

def init_head(generator: torch.Generator, hidden: int, device="cpu"):
    """The projection head: Dense(hidden) -> ReLU -> Dense(128), kernels
    normal / sqrt(fan_in), zero biases (the JAX tool's ``dense_init``)."""
    def dense(d_in, d_out):
        return {"kernel": (torch.randn((d_in, d_out), generator=generator)
                           * d_in ** -0.5).to(device),
                "bias": torch.zeros((d_out,), device=device)}

    return {"h": dense(hidden, hidden), "out": dense(hidden, PROJ_DIM)}


def init_params(seed: int, cfg: vit.ViTConfig, device="cpu"):
    """``{"vit": ..., "proj": ...}``: the backbone, then the head, drawn from
    one CPU generator of ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    backbone = vit.init_params(gen, cfg, device)
    return {"vit": backbone, "proj": init_head(gen, cfg.hidden_dim, device)}


def embed(params, images: torch.Tensor, cfg: vit.ViTConfig,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Unit-norm ``(b, 128)`` projections of the [CLS] features (the ViT's
    products in ``compute_dtype``, the head in f32)."""
    feats = vit.extract_features(params["vit"], images, cfg, compute_dtype=compute_dtype)
    head = params["proj"]
    h = torch.relu(feats @ head["h"]["kernel"] + head["h"]["bias"])
    z = h @ head["out"]["kernel"] + head["out"]["bias"]
    return z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-8)


def nt_xent(z: torch.Tensor, temp: float):
    """``(loss, accuracy)`` of the NT-Xent objective on ``z = [z1; z2]`` (2B
    rows): row ``i``'s positive is row ``i + B`` (and back), its own
    similarity masked; the accuracy is the share of rows whose most similar
    row is the positive."""
    n = z.shape[0]
    b = n // 2
    sim = (z @ z.T) / temp
    sim = sim - 1e9 * torch.eye(n, device=z.device)
    pos = torch.cat([torch.arange(b, device=z.device) + b, torch.arange(b, device=z.device)])
    logp = torch.log_softmax(sim, dim=-1)
    loss = -logp[torch.arange(n, device=z.device), pos].mean()
    acc = (sim.argmax(dim=-1) == pos).float().mean()
    return loss, acc


def scene_ranges(scene_ids: torch.Tensor):
    """``(starts, counts)`` of each scene's contiguous run in ``scene_ids``."""
    n_scenes = int(scene_ids.max()) + 1
    starts = torch.searchsorted(scene_ids.contiguous(),
                                torch.arange(n_scenes, device=scene_ids.device))
    counts = torch.bincount(scene_ids, minlength=n_scenes)
    return starts, counts


def partner_indices(idx: torch.Tensor, offs: torch.Tensor, scene_ids: torch.Tensor,
                    ranges, positives: str) -> torch.Tensor:
    """The second view of each pair: the same image ("augment"), or the view
    ``offs % count`` of its scene's run ("view"); ``ranges`` is
    :func:`scene_ranges` of ``scene_ids``."""
    if positives == "augment":
        return idx
    starts, counts = ranges
    s = scene_ids[idx]
    return starts[s] + offs % counts[s]


def loss_fn(params, v1: torch.Tensor, v2: torch.Tensor, cfg: vit.ViTConfig, temp: float,
            compute_dtype=torch.bfloat16):
    """``(loss, accuracy)`` of two batches of augmented views."""
    return nt_xent(embed(params, torch.cat([v1, v2], dim=0), cfg, compute_dtype), temp)


@dataclasses.dataclass(frozen=True)
class CosineAdam(Adam):
    """Adam with ``optax.cosine_decay_schedule(lr, steps, alpha)``'s rate."""

    steps: int = 1
    alpha: float = COSINE_ALPHA

    def lr(self, count: int) -> float:
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, self.steps) / self.steps))
        return self.learning_rate * ((1.0 - self.alpha) * cosine + self.alpha)


# --------------------------------------------------------------------------- #
# Training                                                                     #
# --------------------------------------------------------------------------- #

def train(corpus: torch.Tensor, scene_ids: torch.Tensor, cfg: vit.ViTConfig, *, steps: int,
          batch: int, lr: float, temp: float, positives: str, seed: int, device,
          log_every: int = 50, log=print) -> dict:
    """``steps`` Adam steps on ``corpus`` (moved to ``device``). Returns
    ``{"params", "losses", "accs", "seconds"}``: the trained tree, each
    step's loss and accuracy (lists of floats) and the loop's seconds, the
    device synchronised at its end."""
    dev = resolve_device(device)
    corpus, scene_ids = corpus.to(dev), scene_ids.to(dev)
    params = init_params(seed, cfg, dev)
    opt = CosineAdam(learning_rate=lr, steps=steps)
    opt_state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_images = corpus.shape[0]
    ranges = scene_ranges(scene_ids)
    losses, accs = [], []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        idx = torch.randint(0, n_images, (batch,), generator=gen, device=dev)
        offs = torch.randint(0, VIEW_OFFSETS, (batch,), generator=gen, device=dev)
        idx2 = partner_indices(idx, offs, scene_ids, ranges, positives)
        v1 = augment(gen, corpus[idx], cfg.image_size)
        v2 = augment(gen, corpus[idx2], cfg.image_size)
        loss, acc, grads = loss_and_grads(params, lambda p: loss_fn(p, v1, v2, cfg, temp))
        updates, opt_state = opt.update(grads, opt_state)
        params = apply_updates(params, updates)
        losses.append(loss)
        accs.append(acc.detach())
        if step % log_every == 0 or step == steps:
            window = torch.stack(losses[-log_every:]).mean()
            log(f"step {step}/{steps}: loss={float(window):.4f} acc={float(acc):.3f} "
                f"({time.perf_counter() - t0:.0f}s)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return {"params": params, "losses": torch.stack(losses).tolist(),
            "accs": torch.stack(accs).tolist(), "seconds": seconds}


def vit_config(hidden: int, layers: int, heads: int, mlp_dim: int) -> vit.ViTConfig:
    """The trained backbone's geometry: 224 px, 32 px patches."""
    return vit.ViTConfig(image_size=224, patch_size=32, hidden_dim=hidden, n_layers=layers,
                         n_heads=heads, mlp_dim=mlp_dim)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="output .npz (vit.save_npz format)")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32, help="image pairs per step")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--temp", type=float, default=0.2)
    ap.add_argument("--corpus-size", type=int, default=256)
    ap.add_argument("--scenes", nargs="*", default=None,
                    help="one directory of views a scene (default: DEFAULT_CORPUS, absent)")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--mlp-dim", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--positives", choices=("augment", "view"), default="augment",
        help="'augment': SimCLR (two crops of the SAME image are the positive pair; "
        "instance discrimination, which separates views of one object). 'view': two "
        "DIFFERENT views of the same scene are the positive pair, the view-invariant "
        "'same object from any viewpoint' property DietNeRF's consistency loss assumes.",
    )
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--log-every", type=int, default=50, help="steps a progress line")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    corpus, scene_ids = load_corpus(args.scenes or DEFAULT_CORPUS, args.corpus_size)
    print(f"corpus: {corpus.shape[0]} images @ {args.corpus_size}px, "
          f"{int(scene_ids.max()) + 1} scenes, positives={args.positives}", flush=True)
    cfg = vit_config(args.hidden, args.layers, args.heads, args.mlp_dim)
    run = train(corpus, scene_ids, cfg, steps=args.steps, batch=args.batch, lr=args.lr,
                temp=args.temp, positives=args.positives, seed=args.seed, device=dev,
                log_every=args.log_every, log=lambda s: print(s, flush=True))
    vit.save_npz(args.out, run["params"]["vit"], config=cfg)
    print(f"saved backbone to {args.out} (config {dataclasses.asdict(cfg)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
