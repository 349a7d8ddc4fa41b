"""The check fails what it must: the control (the reference one precision
below the configuration's, in the program's place) and a run whose timed
path is broken underneath come out not correct under each cell's limits.

At a size a CPU test holds: the flagship's structure, narrower and on a
smaller scene; the program's kernels run their plain versions here."""

import math
import time

import pytest

import control
from harness import cli, drivers, manifest

MAN = manifest.load()


def tiny(cell: str):
    w = manifest.cell(MAN, cell)
    cfg = dict(manifest.config(MAN, w["config"]), hidden_layer_dim=64, last_hidden_layer_dim=32,
               n_rays_in_batch_train=256, n_render_samples_coarse=16,
               n_render_samples_fine=32)
    cfg["scene"] = dict(cfg["scene"], n_images=12, size=32)
    traffic = dict(manifest.traffic(w["traffic"]))
    if traffic["kind"] == "train":
        traffic["steps_per_call"] = 2
    if traffic["kind"] == "render":
        traffic["check_frames"] = 2
    return cfg, traffic


def run(cell: str, seed: int = 2 ** 31 + 5, traced: bool = False):
    cfg, traffic = tiny(cell)
    if traced and traffic["kind"] == "render":
        # Every frame of the traced calls and of the call after them.
        traffic["check_frames"] = traffic["trace_calls"] + 1
    return cli.run_cell(cfg, traffic, manifest.limits(cell), manifest.end_to_end(MAN, cell),
                        manifest.per_layer(MAN, cell), seed, 0.0, traced, "cpu",
                        time.perf_counter())


def failing(numbers, limits):
    return [k for k, v in limits.items() if not (math.isfinite(numbers[k]) and numbers[k] <= v)]


CELLS = [w["name"] for w in MAN["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_unbroken_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_run_is_correct(cell):
    out = run(cell, traced=True)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0 and out["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    cfg, traffic = tiny(cell)
    (r,) = control.readings(cell, [7], ["control"], "cpu", cfg, traffic)
    assert failing(r["numbers"], manifest.limits(cell)), r["numbers"]


def _kind(cell):
    return manifest.traffic(manifest.cell(MAN, cell)["traffic"])["kind"]


REFERENCE_FAULTS = [(c, f) for c in CELLS for f in drivers.KINDS[_kind(c)].faults]


@pytest.mark.parametrize("cell,fault", REFERENCE_FAULTS)
def test_each_fault_planted_in_the_reference_is_not_correct(cell, fault):
    cfg, traffic = tiny(cell)
    (r,) = control.readings(cell, [7], [f"fault:{fault}"], "cpu", cfg, traffic)
    assert failing(r["numbers"], manifest.limits(cell)), r["numbers"]


def test_an_unknown_fault_is_refused():
    cfg, traffic = tiny(CELLS[0])
    with pytest.raises(ValueError, match="unknown side"):
        next(control.readings(CELLS[0], [7], ["fault:typo"], "cpu", cfg, traffic))


def _unchanged_state(monkeypatch):
    from nerf_and_dietnerf_tpu_torch.train import train_step

    monkeypatch.setattr(train_step, "apply_updates", lambda params, updates: params)


def _half_batch(monkeypatch):
    from nerf_and_dietnerf_tpu_torch.models import nerf

    whole = nerf.training_losses

    def half(params, config, key, o, d, rgb, draws=None):
        n = o.shape[0] // 2
        return whole(params, config, key, o[:n], d[:n], rgb[:n], draws)

    monkeypatch.setattr(nerf, "training_losses", half)


def _trunk_grad_doubled(monkeypatch):
    from nerf_and_dietnerf_tpu_torch.train import train_step

    whole = train_step.loss_and_grads

    def doubled(params, loss_fn):
        loss, aux, grads = whole(params, loss_fn)
        for net in grads.values():
            for layer in net["trunk"]:
                for k in layer:
                    layer[k] = 2.0 * layer[k]
        return loss, aux, grads

    monkeypatch.setattr(train_step, "loss_and_grads", doubled)


def _frame_fault(alter):
    def plant(monkeypatch):
        from nerf_and_dietnerf_tpu_torch.parallel import render_tiles

        whole = render_tiles.render_frame

        def broken(*args, **kwargs):
            result, z = whole(*args, **kwargs)
            alter(result.rgb)
            return result, z

        monkeypatch.setattr(render_tiles, "render_frame", broken)
    return plant


def _altered_answer(rgb):
    rgb += 1.0 / 255.0  # one step of an 8-bit frame


def _rays_left_out(rgb):
    flat = rgb.view(-1, 3)
    flat[flat.shape[0] // 2:] = 0.0


FAULTS = {"train": {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
                    "trunk_grad_doubled": _trunk_grad_doubled},
          "render": {"altered_answer": _frame_fault(_altered_answer),
                     "half_batch": _frame_fault(_rays_left_out)}}
CASES = [(c, f) for c in CELLS for f in FAULTS[_kind(c)]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[_kind(cell)][fault](monkeypatch)
    out = run(cell)
    assert not out["correct"], out["checks"]

