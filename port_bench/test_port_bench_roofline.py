"""The yardstick's counts against values worked by hand at small shapes,
and the traced window's sums and readers on made-up device ops."""
from __future__ import annotations

import numpy as np
import pytest

from port_bench import bench, kernels, readers, roofline

TINY = {"hidden_size": 4, "num_attention_heads": 1,
        "num_key_value_heads": 1, "intermediate_size": 8,
        "num_local_experts": 2, "num_experts_per_tok": 1, "vocab_size": 8,
        "num_hidden_layers": 1, "sliding_window": None,
        "moe": {"capacity_factor": 1.0, "group_tokens": 4}}


@pytest.mark.parametrize("args,want", [
    ((4, 4, True, None), 10), ((4, 4, True, 2), 7),
    ((4, 4, False, None), 16), ((2, 4, True, None, 2), 7),
    ((8192, 8192, True, 4096), 4096 * 4097 // 2 + 4096 * 4096),
])
def test_live_pairs(args, want):
    assert roofline.live_pairs(*args) == want


@pytest.mark.parametrize("args,want", [
    ((1024, 8, 2, 1.25), 320), ((1, 8, 2, 1.25), 8), ((100, 4, 2, 1.25), 64),
])
def test_capacity(args, want):
    assert roofline.capacity(*args) == want


@pytest.mark.parametrize("train,want", [(False, 512.0), (True, 1136.0)])
def test_crossbar_bytes(train, want):
    assert roofline.crossbar_bytes(TINY, 4, train) == want


@pytest.mark.parametrize("backward,want", [(False, (160.0, 144.0)),
                                           (True, (480.0, 416.0))])
def test_flash_work(backward, want):
    assert roofline.flash_work(TINY, 1, 4, backward) == want


def test_model_flops():
    assert roofline.active_params_per_token(TINY) == 168
    assert roofline.train_flops(TINY, 1, 4) == 5280.0
    assert roofline.prefill_flops(TINY, 4) == 1568.0


def test_least_time_takes_the_larger_bound():
    assert roofline.least_s(3.35e12) == pytest.approx(1.0)
    assert roofline.least_s(1.0, 989e12) == pytest.approx(1.0)


def test_mixtral_8x7b_train_step_flops():
    cfg = bench.config_spec("mixtral-8x7b")
    # 2 layers: 2 x (attention 41.9 M + router 32.8 k + 2 experts 352.3 M)
    assert roofline.active_params_per_token(cfg) == 2 * (
        4096 * 4096 * 2 + 4096 * 1024 * 2 + 4096 * 8 + 2 * 3 * 4096 * 14336)
    # about 23.4 TFLOP a step: 6 x 0.92 B active x 4096, and attention
    assert 23.0e12 < roofline.train_flops(cfg, 1, 4096) < 23.9e12


def test_quantile_is_numpy_default():
    xs = list(np.random.default_rng(0).random(37))
    for q in (0.0, 0.5, 0.95, 1.0):
        assert bench.quantile(xs, q) == pytest.approx(np.quantile(xs, q))


def _bench_with(ops, work, window_s=1.0):
    b = bench.Bench("x", {}, {}, 0, 1, True, "cpu", 0.0)
    b.device_ops, b.trace_window_s, b.window_s = ops, window_s, window_s
    b.work.update(work)
    return b


CROSS = "void (anonymous namespace)::gather_kernel<8>(int const*)"
FLASH = "void (anonymous namespace)::tc::fwd_ws_kernel<128, true>(Params)"
NATIVE = "void at::native::(anonymous namespace)::vectorized_gather_kernel<4>()"


def test_kernel_names():
    assert kernels.base(CROSS) == "gather_kernel"
    assert kernels.base(FLASH) == "fwd_ws_kernel"
    assert kernels.base(NATIVE) is None
    assert kernels.base("sm90_xmma_gemm_bf16bf16") is None


def test_readers_on_made_up_ops():
    ops = [(CROSS, 0.0, 0.1), (FLASH, 0.05, 0.2), (NATIVE, 0.5, 0.1)]
    b = _bench_with(ops, {"traced_crossbar_bytes": 3.35e12 * 0.05,
                          "traced_flash_least_s": 0.1,
                          "window_flops": 989e12 * 0.25})
    assert b.busy_s() == pytest.approx(0.35)
    assert readers.device_idle(b) == pytest.approx(65.0)
    assert readers.crossbar_roofline(b) == pytest.approx(50.0)
    assert readers.flash_roofline(b) == pytest.approx(50.0)
    assert readers.mfu(b) == pytest.approx(25.0)
    bd = b.breakdown()
    assert bd["device_ops"][0][0].startswith("tc::fwd_ws_kernel")
    assert bd["idle_gaps"][0][1] == pytest.approx(0.25)


def test_readers_find_nothing_to_read():
    b = _bench_with([], {})
    for read in (readers.device_idle, readers.crossbar_roofline,
                 readers.flash_roofline, readers.mfu, readers.peak_mem_gb):
        assert read(b) is None
    assert readers.span_mean_ms(b, "server.tick") is None
