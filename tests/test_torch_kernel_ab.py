"""The parent-against-change timing tool (``tools/kernel_ab.py``): its turns,
its report from fake timings, its distances' bookkeeping and its refusal to
run without a card. The builds and the timings themselves run on the card
only."""

import json

import pytest
import torch

from nerf_and_dietnerf_tpu_torch.tools import chain, kernel_ab, sass_diff


def test_turns_alternate_and_start_with_each_side_in_turn():
    assert kernel_ab.turn_order(4) == [("parent", "change"), ("change", "parent"),
                                       ("parent", "change"), ("change", "parent")]
    assert kernel_ab.turn_order(0) == []


def test_every_case_runs_on_each_side_once_a_turn_after_its_swap():
    events = []
    cases = {"a": lambda: 1.0, "b": lambda: 2.0}
    current = {}

    def swap(side):
        events.append(("swap", side))
        current["side"] = side

    def time_case(fn):
        events.append(("time", current["side"]))
        return fn() + (0.5 if current["side"] == "change" else 0.0)

    times = kernel_ab.run_turns(cases, 3, swap, time_case)
    sides = [side for kind, side in events if kind == "time"]
    # turn 0: parent, change; turn 1: change, parent; turn 2: parent, change
    assert sides == ["parent", "change"] * 2 + ["change", "parent"] * 2 + ["parent", "change"] * 2
    # every timing comes right after the swap to its own side
    assert all(events[i] == ("swap", events[i + 1][1]) for i in range(0, len(events), 2))
    assert times == {"a": {"parent": [1.0] * 3, "change": [1.5] * 3},
                     "b": {"parent": [2.0] * 3, "change": [2.5] * 3}}


def test_report_takes_medians_over_the_turns():
    times = {"B2 bf16 N=262144": {"parent": [10.0, 12.0, 11.0, 30.0],
                                  "change": [11.0, 11.5, 12.0, 11.0]},
             "step pallas bf16": {"parent": [48.0, 47.0, 49.0, 48.0],
                                  "change": [50.0, 50.0, 52.0, 51.0]}}
    distances = {"B2 bf16 N=262144": {"plain": {"dx": 2e-3}, "parent": {"dx": 3e-3},
                                      "change": {"dx": 1.5e-3}}}
    sass = {"change": {"mlp_bwd": {"k": {"registers": 255, "HMMA": 6240}}}}
    rep = kernel_ab.report(times, distances, sass, "NVIDIA H100 80GB HBM3, 700.00 W")
    json.dumps(rep)  # plain JSON
    assert rep["turns"] == 4 and rep["card"].startswith("NVIDIA H100")
    b2 = rep["cases"]["B2 bf16 N=262144"]
    assert (b2["parent_ms"], b2["change_ms"]) == (11.5, 11.25)  # the outlier turn drops out
    assert b2["change_over_parent"] == pytest.approx(11.25 / 11.5)
    assert b2["turns_ms"] == times["B2 bf16 N=262144"]
    assert rep["cases"]["step pallas bf16"]["change_over_parent"] == pytest.approx(50.5 / 48.0)
    assert rep["vs_f64_chain"] is distances and rep["sass"] is sass


def test_chain_distances_hold_each_side_against_one_f64_chain():
    exact = torch.tensor([1.0, 2.0, 2.0])
    current = {}
    outs = {"parent": torch.tensor([1.0, 2.0, 2.3]), "change": torch.tensor([1.0, 2.1, 2.0])}
    case = chain.Chain(kernel=lambda branches=None: {"out": outs[current["side"]]},
                       plain=lambda: {"out": torch.tensor([1.0, 2.0, 2.2])},
                       exact=lambda branches=None: {"out": exact.double()}, pres=None,
                       config=None, cd=torch.bfloat16, rows=3)
    rec = kernel_ab.side_distances({"B1 bf16": case},
                                   lambda side: current.update(side=side))["B1 bf16"]["out"]
    assert rec["plain"] == pytest.approx(0.2 / 3)
    assert rec["parent"] == pytest.approx(0.3 / 3)
    assert rec["change"] == pytest.approx(0.1 / 3, rel=1e-5)
    assert rec["ratio_parent_to_plain"] == pytest.approx(1.5)
    assert rec["ratio_change_to_plain"] == pytest.approx(0.5, rel=1e-5)


def test_builds_only_the_kernels_it_times():
    script = sass_diff.build_script("kernel_ab", kernel_ab.LIBS)
    compile(script, "build", "exec")
    assert "'kernel_ab'" in script and "rmtree" in script
    assert "kl.KERNEL_SOURCES = {n: kl.KERNEL_SOURCES[n] for n in ['mlp_fwd', 'mlp_bwd', " \
           "'raymarch_fwd', 'raymarch_bwd']}" in script
    assert "KERNEL_SOURCES = {" not in sass_diff.build_script("sass_diff")


def test_tool_refuses_to_run_without_a_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_ab.main([str(tmp_path)]) == 2
    err = capsys.readouterr().err
    assert "needs a CUDA card" in err and "no CPU version" in err
