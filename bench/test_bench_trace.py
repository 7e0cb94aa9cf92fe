"""The traced run's checks and readers, on synthetic records: kernel
events held to the launch counters (a lost or an extra event drops the
session), the kernel classes, and each per-layer reader."""
import pytest

from bench import harness as H
from bench import run as R
from bench import trace as T
from bench.yardstick import kernels as K


def test_counts_match_the_counters():
    counts = {"gating_kernel": 12, "positions_kernel": 10,
              "positions_solo_kernel": 2, "ffn_gemm_kernel": 24,
              "elementwise_kernel": 900}
    launched = {"topk_gating_fused": 12, "topk_positions": 12,
                "grouped_ffn": 12}
    assert T._unwitnessed(counts, launched) == {}


@pytest.mark.parametrize("counts,launched", [
    ({"gating_kernel": 11}, {"topk_gating_fused": 12}),        # one lost
    ({"ffn_gemm_kernel": 23}, {"grouped_ffn": 12}),            # half a call
    ({"gating_kernel": 1}, {}),                                # no launch
    ({}, {"grouped_matmul": 3}),                               # none shown
])
def test_a_session_that_lost_events_is_dropped(counts, launched):
    assert T._unwitnessed(counts, launched)


def test_kernel_classes():
    assert K.kind("void (anonymous namespace)::ffn_gemm_kernel<2>(...)") \
        == "port"
    assert K.kind("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n") == "gemm"
    assert K.kind("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTN") == "gemm"
    assert K.kind("ncclDevKernel_AllToAll_RING_LL(ncclDevKernelArgs)") == \
        "collective"
    assert K.kind("void at::native::vectorized_elementwise_kernel<4, ...>"
                  "(int, ...)") == "elementwise"
    assert K.kind("Memcpy DtoH (Device -> Pinned)") == "elementwise"


REC = {"steps": 2, "window_s": 1.0, "busy_s": 0.8,
       "by_kind_s": {"elementwise": 0.2, "gemm": 0.4, "port": 0.2},
       "inside_s": {"moe_layer": 0.3, "grouped_matmul": 0.1},
       "entries": {"grouped_matmul": {"calls": 4, "bound_s": 0.05,
                                      "device_s": 0.1},
                   "grouped_ffn": {"calls": 4, "bound_s": 0.02,
                                   "device_s": 0.04},
                   "flash_attention": {"calls": 0, "bound_s": 0.0,
                                       "device_s": 0.0}},
       "device_ops": [], "idle_gaps": [], "flops": 98.9e12, "chips": 1,
       "step_flops": 49.45e12, "window_step_s": 0.5,
       "server_layer_s": 0.05, "batch_tokens_mean": 12000.0}
WANT = {"mfu.train": 10.0, "moe_device_ms.train": 150.0,
        "elementwise_device_ms.train": 100.0,
        "grouped_matmul_roofline.train": 50.0,
        "device_idle_share.train": 20.0, "mfu.prefill": 10.0,
        "server_host_ms.prefill": 25.0, "batch_tokens_mean.prefill": 12000.0,
        "grouped_ffn_roofline.prefill": 50.0,
        "flash_attention_roofline.prefill": None,
        "device_idle_share.prefill": 20.0}


READERS = sorted(p.stem for p in (H.BENCH / "metrics").glob("*.py"))


def test_every_per_layer_metric_has_a_reader():
    assert {m["name"] for m in H.manifest()["per_layer"]} <= set(READERS)
    assert set(READERS) == set(WANT)


@pytest.mark.parametrize("name", READERS)
def test_reader(name):
    got = R.metric_reader(name)(REC)
    want = WANT[name]
    assert got == pytest.approx(want) if want is not None else got is None


class _Ev:
    def __init__(self, name, dev, start, end, parent=None, kernels=()):
        from types import SimpleNamespace
        from torch.autograd import DeviceType
        self.name = name
        self.device_type = DeviceType.CUDA if dev else DeviceType.CPU
        self.time_range = SimpleNamespace(start=start, end=end)
        self.cpu_parent = parent
        self.kernels = [SimpleNamespace(name=k, duration=d)
                        for k, d in kernels]


def test_a_kernel_counts_once_in_the_moe_layer():
    """A kernel launched in the forward's range, itself run inside the
    layer's backward node (remat), is the layer's once."""
    node = _Ev("autograd::engine::evaluate_function: _GroupedFFNBackward0",
               False, 0, 100)
    rng = _Ev("bench.moe_layer", False, 10, 90, node)
    op = _Ev("aten::mm", False, 20, 30, rng, [("Kernel2", 40.0)])
    dev = _Ev("Kernel2", True, 200, 240)
    rec = T.analyze([node, rng, op, dev], {}, 1.0, 1, {})
    assert rec["inside_s"] == {"moe_layer": pytest.approx(40e-6)}
    assert rec["busy_s"] == pytest.approx(40e-6)
    assert rec["by_kind_s"] == {"gemm": pytest.approx(40e-6)}
