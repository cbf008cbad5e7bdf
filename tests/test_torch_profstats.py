"""telemetry.profstats over ``torch.profiler`` chrome traces, on the CPU,
against the JAX package's (incubator_mxnet_tpu/telemetry/profstats.py;
its tests/test_profstats.py).

The fixture trace is written by the test in torch.profiler's layout (the
device's kernels, copies and memsets as ``cat`` kernel / gpu_memcpy /
gpu_memset events on the device's pid, one tid a stream; host operators
and runtime calls beside them). The event model and the kernel categories
are re-derived for CUDA (a departure, ROADMAP §3: each kernel is its own
op with its duration, the streams of a device one track); the
aggregation above them (busy and idle share, gaps, the devstats join,
folding, hotspots, the table, the daemon's skip rules) is the
reference's: the same op records through both packages' ``_to_summary``
and ``fold_summary`` give the same answers.
"""
import json

import pytest

from incubator_mxnet_tpu.telemetry import profstats as jprof

from incubator_mxnet_tpu_torch.telemetry import devstats, profstats


def _kernel(name, ts, dur, stream=7, pid=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": stream,
            "ts": ts, "dur": dur, "args": {"device": pid, "stream": stream}}


def _trace():
    """Two streams of device 0 over [1000, 1100] us (kernels overlapping
    across the streams count once in the busy time), host events that
    are not ops, and a malformed event."""
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python3"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 123,
         "tid": 1, "ts": 990, "dur": 200},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 123, "tid": 1, "ts": 995, "dur": 5},
        _kernel("flash_fwd_tc<128>", 1000, 10),
        _kernel("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 1010, 30),
        _kernel("nvjet_tst_64x24_64x16_2x4_h_bz_TNT", 1020, 20, stream=9),
        _kernel("void at::native::vectorized_elementwise_kernel<4, "
                "at::native::GeluCUDAKernelImpl>", 1060, 10),
        _kernel("Memcpy DtoH (Device -> Pinned)", 1090, 10,
                cat="gpu_memcpy"),
        _kernel("flash_fwd_tc<128>", 1075, 5),
        {"ph": "X", "cat": "kernel", "name": "bad", "pid": 0, "tid": 7,
         "ts": "x"},
    ]}


def test_summarize_a_torch_profiler_trace(tmp_path):
    capture = tmp_path / "capture-1-1"
    capture.mkdir()
    (capture / "capture.trace.json").write_text(json.dumps(_trace()))
    s = profstats.summarize_capture(str(capture))
    assert s["schema"] == jprof.SCHEMA
    assert s["traces"] == 1 and s["skipped_events"] == 1
    assert s["device_tracks"] == 1 and s["window_us"] == 100.0
    # busy: [1000, 1040] (three kernels, the nvjet one on another stream
    # inside the gemm's span), [1060, 1070], [1075, 1080], [1090, 1100]
    assert s["device_busy_us"] == 65.0
    assert s["device_idle_ratio"] == pytest.approx(0.35)
    ops = {o["op"]: o for o in s["ops"]}
    assert ops["flash_fwd_tc<128>"]["count"] == 2
    assert ops["flash_fwd_tc<128>"]["self_us"] == 15.0
    assert ops["flash_fwd_tc<128>"]["category"] == "attention"
    assert "aten::mm" not in ops and "cudaLaunchKernel" not in ops
    # two streams' kernels overlapping each keep their whole duration
    assert ops["sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n"]["self_us"] == 30.0
    assert s["categories"]["matmul"]["self_us"] == 50.0
    assert s["categories"]["copy"]["self_us"] == 10.0
    assert s["gaps"][0] == {"start_us": 1040.0, "dur_us": 20.0}
    table = profstats.format_table(s)
    assert "flash_fwd_tc<128>" in table and "device idle: 35.0%" in table


@pytest.mark.parametrize("name, category", [
    ("flash_fwd_tc<128>", "attention"),
    ("flash_bwd_dkv_tc", "attention"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "matmul"),
    ("nvjet_tst_64x24_64x16_2x4_h_bz_TNT", "matmul"),
    ("cutlass3x_sm90_tensorop_gemm", "matmul"),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel", "conv"),
    ("sm80_xmma_fprop_implicit_gemm_indexed", "conv"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("void at::native::(anonymous)::CatArrayBatchedCopy", "copy"),
    ("void at::native::(anonymous)::cunn_SoftMaxForward", "reduce"),
    ("void at::native::(anonymous)::vectorized_layer_norm_kernel", "reduce"),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor>",
     "elementwise"),
    ("triton_poi_fused_add_0", "elementwise"),
    ("some_user_kernel", "other")])
def test_categories_are_cuda_names(name, category):
    """The departure: the JAX package ranks XLA HLO op names (``dot.4``,
    ``loop_fusion``); the port ranks CUDA kernel names into the same
    categories plus ``attention`` for K1-K3."""
    assert profstats.categorize(name) == category


def test_fold_and_hotspots_equal_the_references():
    """The same summary folded through both packages gives the same
    rolling table and idle ratio."""
    agg = profstats._empty_agg()
    profstats._merge_agg(agg, profstats.summarize_events(
        _trace()["traceEvents"]))
    for pkg in (profstats, jprof):
        pkg.reset_rolling()
    try:
        for pkg in (profstats, jprof):
            summary = pkg._to_summary(
                {k: (dict(v) if isinstance(v, dict) else v)
                 for k, v in agg.items()}, 1, 0, capture_dir="/x/capture-9")
            pkg.remember(summary)
            pkg.fold_summary(summary)
        got, want = profstats.hotspots(5), jprof.hotspots(5)
        assert got == want
        assert got["device_idle_ratio"] == pytest.approx(0.35)
        assert profstats.get_summary("capture-9")["events"] == 6
        assert profstats.summaries() == jprof.summaries() == ["capture-9"]
        brief = profstats.brief(profstats.get_summary("capture-9"), top=2)
        assert len(brief["ops"]) == 2
    finally:
        for pkg in (profstats, jprof):
            pkg.reset_rolling()


def test_capture_and_summarize_on_the_cpu_and_the_daemon_rules(
        tmp_path, monkeypatch):
    """A real torch.profiler capture on the CPU has no device activity: a
    valid zero summary with the devstats join. The daemon's cycle skips
    under an operator capture and under a load probe above
    MXTPU_PROFSTATS_MAX_LOAD, as the reference's."""
    monkeypatch.setenv("MXTPU_PROFILE_DIR", str(tmp_path))
    profstats.reset_rolling()
    out, summary = profstats.capture_and_summarize(0.05)
    assert summary["capture_id"] == out["capture_id"]
    assert summary["events"] == 0 and summary["device_idle_ratio"] is None
    assert summary["devstats"]["window_s"] >= \
        summary["devstats"]["traced_s"] >= 0.05
    assert "host_bubble_us" in summary["bubbles"]
    profstats.add_load_probe("t-probe", lambda: 0.99)
    try:
        monkeypatch.setenv("MXTPU_PROFSTATS_MAX_LOAD", "0.5")
        before = profstats._CAPTURES.value(outcome="skipped_load")
        assert profstats.run_once(capture_s=0.05, interval_s=1.0) is None
        assert profstats._CAPTURES.value(outcome="skipped_load") == \
            before + 1
    finally:
        profstats.remove_load_probe("t-probe")
    with devstats._capture_lock:
        before = profstats._CAPTURES.value(outcome="skipped_busy")
        assert profstats.run_once(capture_s=0.05, interval_s=1.0) is None
        assert profstats._CAPTURES.value(outcome="skipped_busy") == \
            before + 1
    assert profstats.run_once(capture_s=0.05, interval_s=1.0) is not None
    profstats.reset_rolling()
