"""Trace reduction (``trace.py``) and the readers on a synthetic run."""

import pytest

from gpubench import core, spec, trace

PROBE = "void gj_probe_fused_panel_micro<double, 32>(double const*, int)"
GEMM = "sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize64x64x16"
DGEMM = "void cutlass::Kernel2<cutlass_80_tensorop_d884gemm_64x64_16x4>(Params)"
OTHER = "void at::native::elementwise_kernel<128, 4>(int, Func)"


def synthetic_profile():
    # Two calls; times in microseconds.  Device: busy [0, 10] ∪ [12, 20]
    # ∪ [30, 40]; a copy at [50, 52].
    device = [(PROBE, 0.0, 6.0), (GEMM, 4.0, 10.0), (OTHER, 12.0, 20.0),
              (DGEMM, 30.0, 40.0), ("Memcpy DtoH (Device -> Pageable)",
                                    50.0, 52.0)]
    host = [("aten::item", 9.0, 14.0),            # spans gap 10–12
            ("cudaStreamSynchronize", 10.5, 11.5),  # innermost there
            ("aten::copy_", 19.0, 45.0),           # spans gap 20–30 and 40–50
            ("cudaLaunchKernel", 44.0, 46.0)]      # innermost at mid 45
    return trace.Profile(device=device, host=host, calls=2,
                         window_s=100e-6)


@pytest.mark.parametrize("name, kind", [
    (PROBE, "probe"), ("void gj_probe_kernel<float>(float*)", "probe"),
    ("fused_update_fp32(Close)", "update"), (GEMM, "gemm"),
    (DGEMM, "gemm"), ("ampere_dgemm_64x16", "gemm"), (OTHER, "other")])
def test_kind(name, kind):
    assert trace.kind(name) == kind


def test_union_and_merge():
    iv = [(0, 6), (4, 10), (12, 20), (15, 18), (30, 40)]
    assert trace.union(iv) == 10 + 8 + 10
    assert trace.merged(iv) == [(0, 10), (12, 20), (30, 40)]
    assert trace.union([]) == 0


def test_profile_busy_kinds_and_kernels():
    p = synthetic_profile()
    assert len(p.kernels) == 4
    assert p.busy_s == pytest.approx(30e-6)
    by = p.seconds_by_kind()
    assert by["probe"] == pytest.approx(6e-6)
    assert by["gemm"] == pytest.approx(16e-6)
    assert by["other"] == pytest.approx(8e-6)


def test_breakdown():
    p = synthetic_profile()
    ops = p.device_ops()
    assert ops[0] == ["cutlass::Kernel2<cutlass_80_tensorop_d884gemm_64x64_16x4>",
                      pytest.approx(10e-6)]
    assert len(ops) == 5
    assert ["gj_probe_fused_panel_micro<double, 32>",
            pytest.approx(6e-6)] in ops
    gaps = dict((k, v) for k, v in p.idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(2e-6)
    assert gaps["aten::copy_"] == pytest.approx(10e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)


def synthetic_run(cell_name="gj_fp64.n8192_m384", profile=None):
    cell = spec.load_cell(cell_name)
    w = core.Window(host_s=[0.0105, 0.0110, 0.0100], event_ms=[10.0, 10.5, 9.5],
                    window_s=0.0315)
    return core.Run(cell=cell, setup_s=12.5, window=w,
                    work_per_call=2.0 * cell.n ** 3 * cell.batch,
                    peaks={"flops": {"float64": 67e12, "float32": 67e12},
                           "bytes_per_s": 3.35e12},
                    profile=profile)


def read(name, run):
    return spec.metric_reader(name)(run)


def test_end_to_end_readers():
    run = synthetic_run()
    assert read("gflops", run) == pytest.approx(
        3 * 2.0 * 8192 ** 3 / 0.0315 / 1e9)
    assert read("setup_s", run) == 12.5
    assert read("call_p95_ms", run) is None      # fewer than 20 calls
    run.window.event_ms = [float(i) for i in range(1, 101)]
    assert read("call_p95_ms", run) == pytest.approx(95.05)


def test_layer_readers():
    run = synthetic_run(profile=synthetic_profile())
    assert read("entry_host_ms", run) == pytest.approx(
        (31.5 - 30.0) / 3)
    assert read("engine_ms", run) == 10.0
    assert read("launches_per_call", run) == 2.0
    assert read("probe_ms", run) == pytest.approx(3e-3)
    assert read("idle_pct", run) == pytest.approx(70.0)
    from gpubench import work

    probe_s, _ = work.probe_bound_s(8192, 384, 1, "float64", 67e12, 3.35e12)
    assert read("probe_roofline", run) == pytest.approx(
        100 * probe_s / 3e-6)
    gemm_s, _ = work.gemm_bound_s(8192, 1, "float64", 67e12, 3.35e12)
    assert read("gemm_roofline", run) == pytest.approx(100 * gemm_s / 8e-6)


def test_readers_find_nothing_to_read():
    run = synthetic_run()
    for name in ("launches_per_call", "probe_ms", "probe_roofline",
                 "gemm_roofline", "idle_pct"):
        assert read(name, run) is None
    run = synthetic_run(profile=synthetic_profile())
    run.peaks = None
    assert read("probe_roofline", run) is None
    assert read("gemm_roofline", run) is None
    run.profile.device = [d for d in run.profile.device
                          if trace.kind(d[0]) != "probe"]
    assert read("probe_ms", run) is None


@pytest.mark.parametrize("name, short", [
    ("void (anonymous namespace)::gj_probe_kernel<float>(float const*, int)",
     "gj_probe_kernel<float>"),
    ("void at::native::(anonymous namespace)::elementwise_kernel<128>(int)",
     "at::native::elementwise_kernel<128>"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
    (GEMM, GEMM)])
def test_short_name(name, short):
    assert trace.short_name(name) == short
