"""The reduction of a trace, on hand-made profiler events."""

import pytest
import torch

from benchmark.trace import reduce_events

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, dev, a, b):
        self._n, self._d, self._a, self._b = name, dev, a, b

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b


def test_busy_launches_gaps_and_breakdown():
    ev = [
        Ev("bench.pass", CPU, 0, 1000), Ev("aten::add", CPU, 10, 300), Ev("cudaLaunchKernel", CPU, 20, 30),
        Ev("cuLaunchKernelEx", CPU, 40, 50), Ev("cudaMemcpyAsync", CPU, 400, 900),
        Ev("kernel_a", CUDA, 100, 200), Ev("kernel_b", CUDA, 150, 250), Ev("kernel_a", CUDA, 700, 800),
    ]
    tr = reduce_events(ev, window_s=1e-6)
    assert tr.launches == 2
    assert tr.busy_s == pytest.approx(250e-9)  # [100, 250] and [700, 800]
    assert tr.device_s["kernel_a"] == pytest.approx(200e-9)
    assert tr.kernel_s("kernel") == pytest.approx(300e-9)
    assert tr.gaps == [("cudaMemcpyAsync", pytest.approx(450e-9))]  # the host waited in a copy
    assert tr.breakdown()["device_ops"][0] == ["kernel_a", pytest.approx(200e-9)]


def test_program_span_less_its_cuda_calls():
    ev = [
        Ev("suite.dispatch", CPU, 0, 1000), Ev("aten::add", CPU, 10, 300),
        Ev("cudaLaunchKernel", CPU, 20, 120), Ev("cuLaunchKernel", CPU, 50, 100),  # nested: counted once
        Ev("cudaMemcpyAsync", CPU, 900, 1500),  # runs past the span's end
        Ev("suite.dispatch", CPU, 2000, 2500), Ev("cudaLaunchKernel", CPU, 2100, 2400),
        Ev("cudaStreamSynchronize", CPU, 3000, 4000),  # outside every span
        Ev("kernel_a", CUDA, 100, 200),
        Ev("suite.dispatch", CUDA, 0, 1000),  # the range mirrored on the device's timeline
    ]
    tr = reduce_events(ev, window_s=5e-6, span_names={"suite.dispatch"})
    assert tr.busy_s == pytest.approx(100e-9) and "suite.dispatch" not in tr.device_s
    total, in_api = tr.spans["suite.dispatch"]
    assert total == pytest.approx(1500e-9)
    assert in_api == pytest.approx((100 + 100 + 300) * 1e-9)
    assert reduce_events(ev, window_s=5e-6).spans == {}
