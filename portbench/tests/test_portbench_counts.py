"""The operation counts against a count of the reference's matrix products."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import counts, weights
from reference import nerf as ref_nerf
from reference.precision import rounder

SMALL = {"hidden_layer_dim": 16, "last_hidden_layer_dim": 8, "n_pos_enc_dim_xyz": 2,
         "n_pos_enc_view_dir": 1, "n_angles_for_model": 2, "leaky_relu_alpha": 0.05,
         "near_depth_render": 2.0, "far_depth_render": 6.0}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_forward_and_backward_flops_match_the_reference_products():
    dims = weights.mlp_dims(SMALL)
    params = weights.nerf_params(dims, 3, "cpu")["coarse"]
    rows = 5
    enc = torch.rand(rows, dims["xyz"], requires_grad=True)
    encd = torch.rand(rows, dims["dir"], requires_grad=True)
    leaves = [p.requires_grad_(True) for p in _leaves(params)]
    fwd = _count(lambda: ref_nerf.mlp(params, enc, encd, 0.05, rounder("float32")))
    assert fwd == rows * counts.forward_flops(dims)
    out = ref_nerf.mlp(params, enc, encd, 0.05, rounder("float32"))
    bwd = _count(lambda: torch.autograd.grad(out.sum(), [enc, encd] + leaves))
    assert bwd == rows * counts.backward_flops(dims)


def test_flagship_forward_is_1_024_mflop_a_sample():
    dims = weights.mlp_dims(dict(SMALL, hidden_layer_dim=256, last_hidden_layer_dim=128,
                                 n_pos_enc_dim_xyz=5, n_pos_enc_view_dir=4))
    assert counts.forward_flops(dims) == 1_024_304
    assert counts.backward_flops(dims) == 2 * 1_024_304


def test_bound_is_the_larger_of_operations_and_bytes():
    assert counts.bound_seconds(989e12, 0, "bfloat16") == 1.0
    assert counts.bound_seconds(0, 3.35e12, "float32") == 1.0
    assert counts.bound_seconds(495e12, 1.0, "float32") == 1.0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]
