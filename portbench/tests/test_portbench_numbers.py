"""The numbers the check compares: leaf gaps by the median leaf and by the
worst held leaf, leaves of nought gradient left out of the change, the
resampled samples' 99th percentile, and the frames' 99th percentile."""

import math

import numpy as np
import pytest
import torch

from harness import drivers, weights
from reference import train as ref_train

DIMS = weights.mlp_dims({"hidden_layer_dim": 8, "last_hidden_layer_dim": 4,
                         "n_pos_enc_dim_xyz": 1, "n_pos_enc_view_dir": 1,
                         "n_angles_for_model": 2, "leaky_relu_alpha": 0.05,
                         "near_depth_render": 2.0, "far_depth_render": 6.0})
NAMES = ref_train.leaf_names(weights.nerf_params(DIMS, 0, "cpu"))
HELD = drivers.held_leaves(NAMES)


def _side():
    """Leaves of one norm each, the same resampled samples on both sides."""
    grads = [torch.ones(8) for _ in NAMES]
    change = [torch.full((8,), 0.5) for _ in NAMES]
    z = [torch.linspace(2.0, 6.0, 200).reshape(10, 20)]
    return ({"losses": [1.0, 0.9, 0.8], "grad1": grads, "change": change, "z": z},
            {"losses": [1.0, 0.9, 0.8], "grad1": [t.clone() for t in grads],
             "change": [t.clone() for t in change], "names": NAMES,
             "z": [t.clone() for t in z], "span": 4.0})


def test_the_leaves_are_named_in_leaf_order_and_held_apart():
    assert len(NAMES) == 44 and int(HELD.sum()) == 26   # the fine 22, the coarse heads 4
    assert NAMES[:2] == ["coarse.rgb_hidden.bias", "coarse.rgb_hidden.kernel"]
    assert not HELD[NAMES.index("coarse.trunk.0.kernel")]
    assert HELD[NAMES.index("fine.trunk.0.kernel")] and HELD[NAMES.index("fine.sigma_out.bias")]


def test_identical_sides_read_nought():
    prog, ref = _side()
    assert all(v == 0 for v in drivers.train_numbers(prog, ref).values())


def test_one_held_leaf_sets_the_held_number():
    prog, ref = _side()
    i = NAMES.index("fine.trunk.3.kernel")
    prog["grad1"][i] = prog["grad1"][i] * 1.25
    n = drivers.train_numbers(prog, ref)
    assert n["grad_gap"] == 0                             # one of 44 leaves moved
    assert n["grad_gap_held"] == pytest.approx(0.25)


def test_a_leaf_through_the_resampling_is_not_held():
    prog, ref = _side()
    prog["grad1"][NAMES.index("coarse.trunk.2.kernel")] *= 10
    n = drivers.train_numbers(prog, ref)
    assert n["grad_gap"] == 0 and n["grad_gap_held"] == 0
    assert drivers.train_diagnostics(prog, ref)["grad_gap.worst"] == pytest.approx(9)


def test_leaves_of_nought_gradient_are_left_out_of_the_change():
    prog, ref = _side()
    for side in (prog, ref):
        for i in range(20):             # under half the leaves
            side["grad1"][i] = side["grad1"][i] * 1e-4
    for i in range(20):
        prog["change"][i] = prog["change"][i] * 3  # moved by round-off alone
    d = drivers.train_diagnostics(prog, ref)
    assert d["leaves_left_out"] == 20
    assert d["change_gap"] == 0


def test_the_z_gap_is_the_99th_percentile_and_a_missing_resampling_fails():
    prog, ref = _side()
    prog["z"][0][3, 7] += 2.0           # one sample's jump
    assert drivers.train_numbers(prog, ref)["z_gap"] == 0
    prog["z"][0][:] += 0.004
    assert drivers.train_numbers(prog, ref)["z_gap"] == pytest.approx(1e-3, rel=1e-4)
    for z in (None, prog["z"][0][:5]):  # none resampled, or not one a ray and sample
        prog["z"] = [z]
        assert not math.isfinite(drivers.train_numbers(prog, ref)["z_gap"])


def test_the_frame_gap_is_the_99th_percentile():
    ref = {0: np.zeros((10, 10, 3), np.float32), 3: np.zeros((10, 10, 3), np.float32)}
    prog = {k: v.copy() for k, v in ref.items()}
    prog[3][4, 5, 1] = 0.5           # one ray's jump
    assert drivers.Render.numbers(prog, ref)["frame_gap"] == 0
    prog[0][:] = 1e-3
    assert drivers.Render.numbers(prog, ref)["frame_gap"] == pytest.approx(1e-3)
