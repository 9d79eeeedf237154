"""The profiler reduction on a hand-made event list: busy and idle
seconds, idle gaps named by the host, operations launched inside a host
range, and the clock offset from the benchmark's marks."""
from torch.autograd import DeviceType

from portbench.tracing import Trace


class Ev:
    def __init__(self, name, start, dur, cuda=False, corr=-1, tid=1):
        self._v = (name, start, dur, cuda, corr, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return False


def _trace():
    ev = [Ev("bench.step", 1000, 1000),            # the window 1000-2000
          Ev("moe_dispatch", 1100, 200),
          Ev("cudaLaunchKernel", 1150, 10, corr=7),
          Ev("cudaLaunchKernel", 1400, 10, corr=8),
          Ev("aten::item", 1500, 300),
          Ev("router_kernel", 1200, 100, cuda=True, corr=7),
          Ev("gemm", 1250, 250, cuda=True, corr=8),   # overlaps: merged
          Ev("gemm", 1900, 200, cuda=True, corr=9),   # clipped at 2000
          Ev("moe_dispatch", 1200, 0, cuda=True)]     # a range on the card
    return Trace(ev, [("bench.step", 1000 / 1e9 - 5.0)])


def test_busy_idle_and_ops():
    tr = _trace()
    assert tr.window_s == 1000 / 1e9
    assert tr.merged() == [(1200, 1500), (1900, 2000)]
    assert tr.busy_s == 400 / 1e9
    assert [d[0] for d in tr.ops()] == ["router_kernel", "gemm", "gemm"]
    assert tr.op_seconds("gemm") == 450 / 1e9
    assert tr.top_ops()[0] == ["gemm", 450 / 1e9]
    assert abs(tr.ns(0.0) - 5e9) < 1e-3


def test_idle_gaps_are_named_by_the_host():
    gaps = dict(_trace().idle_gaps())
    # 1000-1200: middle 1100 in moe_dispatch; 1500-1900: middle 1700 in
    # aten::item
    assert gaps == {"moe_dispatch in bench.step": 200 / 1e9,
                    "aten::item in bench.step": 400 / 1e9}


def test_launched_inside_a_range():
    assert _trace().launched_inside("moe_dispatch") == 100 / 1e9
