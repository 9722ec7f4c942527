"""The solve profiler's bookkeeping, on the CPU: kernel names sorted into
probe, fused update, GEMM and other, the busy time as a union of device intervals, and a
refusal to run without a card (it never measures the CPU in its place)."""

import pytest
import torch

from tpu_jordan_torch import profile_solve


@pytest.mark.parametrize("name,kind", [
    ("void gj_probe_kernel<float>(float const*, float*, ...)", "probe"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>",
     "gemm"),
    ("void (anonymous namespace)::fused_update_tile<1, false>(Args)",
     "update"),
    ("void at::native::index_elementwise_kernel<128, 4>", "other"),
])
def test_kernel_kinds(name, kind):
    assert profile_solve._kind(name) == kind


@pytest.mark.parametrize("spans,busy", [
    ([], 0.0),
    ([(0.0, 2.0), (5.0, 6.0)], 3.0),           # apart
    ([(0.0, 4.0), (1.0, 2.0)], 4.0),           # nested
    ([(3.0, 7.0), (0.0, 5.0), (6.0, 9.0)], 9.0),  # chained, out of order
])
def test_busy_time_is_the_union_of_spans(spans, busy):
    assert profile_solve._union_us(spans) == busy


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_solve.main(["--rows", "64:8:rand:float32"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
