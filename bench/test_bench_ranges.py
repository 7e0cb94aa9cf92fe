"""The program's own ranges (``repro_torch.obs.REGIONS``) leave the traced
run's record as it was: on synthetic captures, with and without program
ranges (a host range, and its device annotation, which the profiler marks
``is_user_annotation``), under ``bench.moe_layer``, around it, and inside
the layer's backward node (the remat recompute), the busy time, the time
inside each range kind, the time by kernel class and the kernel counts
are the same."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from bench import trace as T
from repro_torch.obs import REGIONS


class _Ev:
    def __init__(self, name, dev, start, end, parent=None, kernels=(),
                 annotation=False):
        self.name = name
        self.device_type = DeviceType.CUDA if dev else DeviceType.CPU
        self.time_range = SimpleNamespace(start=start, end=end)
        self.cpu_parent = parent
        self.kernels = [SimpleNamespace(name=k, duration=d)
                        for k, d in kernels]
        self.is_user_annotation = annotation


def _capture(ranged: bool, where: str):
    """A step: the attention's GEMM, then the MoE layer's (forward, under
    ``bench.moe_layer``), then the combine's backward node, which runs
    the group's recompute; with ``ranged`` the program's ranges at
    ``where`` ("around" the bench's range or "under" it)."""
    def rng(name, parent, start, end):
        return _Ev(name, False, start, end, parent, annotation=True) \
            if ranged else parent
    step = _Ev("bench.train_step", False, 0, 1000, annotation=True)
    attn = rng("lm.attention", step, 10, 90)
    a_mm = _Ev("aten::mm", False, 20, 30, attn, [("Kernel2", 40.0)])
    outer = rng("lm.moe", step, 100, 290) if where == "around" else step
    moe = _Ev("bench.moe_layer", False, 110, 280, outer, annotation=True)
    inner = rng("lm.moe", moe, 115, 275) if where == "under" else moe
    m_mm = _Ev("aten::mm", False, 120, 130, inner, [("Kernel2", 30.0)])
    node = _Ev("autograd::engine::evaluate_function: _CombineBackward0",
               False, 300, 900, step)
    r_attn = rng("lm.attention", node, 310, 390)
    r_mm = _Ev("aten::mm", False, 320, 330, r_attn, [("Kernel2", 40.0)])
    b_cp = _Ev("aten::copy_", False, 400, 410, node,
               [("elementwise_kernel", 5.0)])
    cpu = [step, attn, a_mm, outer, moe, inner, m_mm, node, r_attn, r_mm,
           b_cp]
    dev = [_Ev("Kernel2", True, 1000, 1040), _Ev("Kernel2", True, 1100, 1130),
           _Ev("Kernel2", True, 1200, 1240),
           _Ev("elementwise_kernel", True, 1300, 1305)]
    if ranged:          # each program range's device annotation
        dev += [_Ev(e.name, True, 1000 + e.time_range.start,
                    1000 + e.time_range.end, annotation=True)
                for e in cpu if e.name in REGIONS]
    return list(dict.fromkeys(cpu)) + dev


@pytest.mark.parametrize("where", ["around", "under"])
def test_program_ranges_leave_the_record_unchanged(where):
    plain = T.analyze(_capture(False, where), {}, 1.0, 1, {})
    ranged = T.analyze(_capture(True, where), {}, 1.0, 1, {})
    for key in ("busy_s", "inside_s", "by_kind_s", "device_ops"):
        assert ranged[key] == plain[key], key
    # the layer's forward and its node's recompute and copy: 75 us
    assert plain["inside_s"] == {"moe_layer": pytest.approx(75e-6),
                                 "train_step": pytest.approx(115e-6)}
    assert plain["busy_s"] == pytest.approx(115e-6)
