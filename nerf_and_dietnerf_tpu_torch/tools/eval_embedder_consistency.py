"""Is an embedder's feature map view-consistent per scene?

The counterpart of the JAX package's ``tools/eval_embedder_consistency.py``.
DietNeRF's consistency loss assumes "same scene from any viewpoint => similar
embedding" (reference ``src/DietNeRF.py:204-222``). This measures it for a
checkpoint: the mean cosine of the [CLS] features (``vit.preprocess``, then
``vit.extract_features`` in f32) between two different views of one scene
("within") and between views of different scenes ("across"). A useful
embedder has within >> across; a random one has both high (untrained features
are dominated by shared low-level statistics).

    python -m nerf_and_dietnerf_tpu_torch.tools.eval_embedder_consistency \\
        [--weights scene_vit.npz] [--scenes DIR_A DIR_B ...] [--device cpu]

Prints one JSON line with the JAX tool's keys. Runs on the GPU unless
``--device cpu`` is given. The JAX tool reads only ``DEFAULT_CORPUS``, which
the repository does not hold; this one takes the trainer's ``--scenes`` (one
directory of views a scene) and defaults to that corpus.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from nerf_and_dietnerf_tpu_torch.models import vit
from nerf_and_dietnerf_tpu_torch.tools.train_scene_embedder import (
    DEFAULT_CORPUS, load_corpus, vit_config)
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device

BATCH = 64            # images a ViT call
RANDOM_SEED = 7       # the random embedder's generator


def random_embedder(device="cpu"):
    """``(cfg, params)``: the JAX tool's random-init geometry (256 wide, 6
    layers, 8 heads, MLP 1024, 224 px / 32 px patches), drawn from a
    ``torch.Generator`` of seed 7; not JAX's numbers."""
    cfg = vit_config(256, 6, 8, 1024)
    return cfg, vit.init_params(torch.Generator().manual_seed(RANDOM_SEED), cfg, device)


@torch.no_grad()
def features(params, cfg: vit.ViTConfig, corpus: torch.Tensor, device) -> torch.Tensor:
    """f32 [CLS] features of the corpus images (in [0, 1]), 64 at a time."""
    return torch.cat([
        vit.extract_features(params, vit.preprocess(corpus[i:i + BATCH].to(device), cfg), cfg,
                             compute_dtype=torch.float32)
        for i in range(0, corpus.shape[0], BATCH)])


def consistency(feats: torch.Tensor, scene_ids: torch.Tensor) -> dict:
    """Mean cosine of distinct same-scene pairs and of cross-scene pairs, and
    their difference (unrounded)."""
    z = feats.double()
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    sim = z @ z.T
    ids = scene_ids.to(sim.device)
    same = ids[:, None] == ids[None, :]
    off_diag = ~torch.eye(len(z), dtype=torch.bool, device=sim.device)
    within = float(sim[same & off_diag].mean())
    across = float(sim[~same].mean())
    return {"within_scene_cos": within, "across_scene_cos": across,
            "separation": within - across}


def report(label: str, numbers: dict) -> str:
    """The JAX tool's JSON line."""
    return json.dumps({"embedder": label, **{k: round(v, 4) for k, v in numbers.items()}})


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", default=None,
                    help="npz (vit.save_npz); without it a random embedder (seed 7 of a "
                    "torch.Generator, so not the JAX tool's random numbers)")
    ap.add_argument("--scenes", nargs="*", default=None,
                    help="one directory of views a scene (default: DEFAULT_CORPUS, absent)")
    ap.add_argument("--corpus-size", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    corpus, scene_ids = load_corpus(args.scenes or DEFAULT_CORPUS, args.corpus_size)
    if args.weights:
        cfg = vit.infer_config(args.weights) or vit.ViTConfig()
        params = vit.load_pretrained(args.weights, cfg, dev)
        label = args.weights
    else:
        cfg, params = random_embedder(dev)
        label = "random-init"
    print(report(label, consistency(features(params, cfg, corpus, dev), scene_ids)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
