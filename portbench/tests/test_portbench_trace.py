"""The idle share and the attribution of idle gaps on a synthetic trace."""

import types

import pytest

from harness import readers, trace


def _evt(kind, name, start, end):
    return types.SimpleNamespace(device_type=f"DeviceType.{kind}", name=name, key=name,
                                 time_range=types.SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events

    def key_averages(self):
        out = {}
        for e in self._events:
            if e.device_type.endswith("CUDA"):
                a = out.setdefault(e.name, types.SimpleNamespace(
                    device_type=e.device_type, key=e.name, count=0, self_device_time_total=0.0))
                a.count += 1
                a.self_device_time_total += e.time_range.end - e.time_range.start
        return list(out.values())


EVENTS = [
    _evt("CPU", "aten::item", 0, 200),
    _evt("CPU", "cudaStreamSynchronize", 45, 58),
    _evt("CUDA", "void mlp_fwd_mma_kernel<true>(nerf_mlp::Dims)", 0, 40),
    _evt("CUDA", "elementwise_kernel", 30, 50),       # overlaps the first
    _evt("CUDA", "mlp_bwd_mma_kernel(nerf_mlp::Dims)", 60, 90),
    _evt("CUDA", "reduce_partials(float const*)", 130, 140),
]


def test_busy_window_and_idle_share():
    tr = trace.read(_Prof(EVENTS))
    assert tr.window_s == pytest.approx(140e-6)
    assert tr.busy_s == pytest.approx((50 + 30 + 10) * 1e-6)
    assert tr.idle_share == pytest.approx(1 - 90 / 140)
    assert tr.device_ops == 4


def test_each_gap_goes_to_the_innermost_host_operation():
    tr = trace.read(_Prof(EVENTS))
    assert tr.idle_by_host == {"aten::item": pytest.approx(40e-6),
                               "cudaStreamSynchronize": pytest.approx(10e-6)}
    assert tr.breakdown()["idle_gaps"][0] == ["aten::item", pytest.approx(40e-6)]


def test_kernel_time_by_whole_symbol():
    tr = trace.read(_Prof(EVENTS))
    assert tr.seconds_of(["mlp_bwd_mma_kernel", "reduce_partials"]) == (pytest.approx(40e-6), 2)
    assert tr.seconds_of(["mlp_fwd"]) == (0, 0)


def test_outside_share_and_idle_percent():
    tr = trace.read(_Prof(EVENTS))
    ctx = readers.Context(tr, {"steps": 1}, {},
                          ["mlp_fwd_mma_kernel", "mlp_bwd_mma_kernel", "reduce_partials"])
    assert readers.outside_percent(ctx) == pytest.approx(100 * 20 / 100)
    assert readers.idle_percent(ctx) == pytest.approx(100 * (1 - 90 / 140))


def test_the_program_kernels_are_read_from_its_sources():
    names = trace.hand_kernels(readers.METRICS_DIR.parents[1] / "nerf_and_dietnerf_tpu_torch"
                               / "csrc")
    for k in ("mlp_fwd_mma_kernel", "mlp_fwd_tf32_kernel", "mlp_bwd_mma_kernel",
              "mlp_bwd_t32_kernel", "reduce_partials"):
        assert k in names
