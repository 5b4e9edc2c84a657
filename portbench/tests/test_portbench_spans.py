"""`spans.py` on synthetic profiler events, its readers without spans, and
the span probe's traced run on the CPU against a program that has no
`recording`."""

import time
import types

import pytest
import torch

from portbench import cells, harness, spanprobe, spans, yardstick

from test_portbench_harness import SEED


def _event(name, start, dur, cuda, corr=0, thread=1):
    kind = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: kind, is_user_annotation=lambda: False,
        correlation_id=lambda: corr, start_thread_id=lambda: thread,
        device_resource_id=lambda: thread)


def _span(name, start, end, step=1):
    return types.SimpleNamespace(name=name, start=start, end=end, step=step)


# kernels k1 [100, 200), k2 [300, 400), k3 [600, 700); their launches at
# 50, 220 (main thread) and 500 (autograd's thread)
EVENTS = [_event("k1", 100, 100, True, corr=1),
          _event("k2", 300, 100, True, corr=2),
          _event("k3", 600, 100, True, corr=3),
          _event("cudaLaunchKernel", 50, 10, False, corr=1),
          _event("cudaLaunchKernel", 220, 10, False, corr=2),
          _event("cudaLaunchKernel", 500, 10, False, corr=3, thread=2),
          _event("cudaStreamSynchronize", 420, 170, False, corr=4)]


def test_gap_split_over_two_spans_and_kernels_by_correlation_id():
    tuples = [(0, 250, "train.forward"), (150, 240, "train.loss"),
              (250, 800, "train.backward")]
    got = spans.attribute(EVENTS, tuples)
    # gaps [200, 300) and [400, 600): the first 40 ns in the loss, 10 in
    # the forward, the rest in the backward
    assert got["idle_s"] == pytest.approx({
        "train.loss": 40e-9, "train.forward": 10e-9,
        "train.backward": 250e-9})
    # k1 launched at 50 (forward), k2 at 220 (loss), k3 at 500 from a
    # second thread, which falls to the backward by time
    assert got["busy_s"] == pytest.approx({
        "train.forward": 100e-9, "train.loss": 100e-9,
        "train.backward": 100e-9})


def test_uncovered_parts_and_unmatched_kernels_are_named():
    got = spans.attribute(EVENTS + [_event("memset", 800, 10, True, corr=9)],
                          [(250, 350, "detect.post")])
    assert got["idle_s"] == pytest.approx({
        "detect.post": 50e-9, spans.NO_SPAN: 350e-9})
    assert got["busy_s"] == pytest.approx({spans.NO_SPAN: 300e-9,
                                           spans.NO_CALL: 10e-9})


def test_skewed_stamps_keep_each_stack_nested():
    """A runtime call that runs 3 ns past its span's end (clock skew):
    the gap inside it is named by the span and the call, and the next
    span alone takes the gap after it."""
    events = [_event("k1", 0, 10, True, corr=1),
              _event("k2", 100, 10, True, corr=2),
              _event("k3", 200, 10, True, corr=3),
              _event("cudaMemcpyAsync", 20, 83, False, corr=5)]
    tuples = [(15, 100, "detect.copy_back"), (100, 300, "detect.strip"),
              (0, 300, "detect.batch")]
    gaps = dict(spans.name_gaps(events, tuples))
    assert gaps == pytest.approx({
        "detect.copy_back > cudaMemcpyAsync": 90e-9,
        "detect.strip": 90e-9})
    got = spans.attribute(events, tuples)
    assert got["idle_s"] == pytest.approx({
        "detect.batch": 5e-9, "detect.copy_back": 85e-9,
        "detect.strip": 90e-9})


def test_without_spans_the_breakdown_is_reduce_traces():
    base = yardstick.reduce_trace(EVENTS)
    got = spans.reduce(EVENTS, [], 0, 0, "train.batch")
    assert got.pop("program")["idle_s"] == pytest.approx(
        {spans.NO_SPAN: 300e-9})
    assert got == base
    assert dict(base["idle_gaps"]) == pytest.approx({
        spans.HOST_CODE: 100e-9, "cudaLaunchKernel": 200e-9})


def test_host_ms_a_step_before_the_stretch():
    recorded = [_span("detect.batch", 0, 10_000_000, 1),
                _span("detect.forward", 1_000_000, 5_000_000, 1),
                _span("detect.batch", 20_000_000, 24_000_000, 2),
                _span("detect.forward", 21_000_000, 22_000_000, 2),
                _span("detect.batch", 40_000_000, 50_000_000, 3)]
    got = spans.host_ms(recorded, 0, 30_000_000, "detect.batch")
    assert got == pytest.approx({"detect.batch": 7.0, "detect.forward": 2.5})
    assert spans.host_ms(recorded, 60_000_000, 70_000_000,
                         "detect.batch") == {}


def test_readers_by_hand():
    program = {"idle_s": {"detect.forward": 0.004, "detect.post": 0.002,
                          "detect.strip": 0.003, spans.NO_SPAN: 0.001},
               "busy_s": {"train.loss": 0.006, "train.update": 0.002},
               "host_ms": {"detect.inputs": 0.5, "detect.forward": 20.0,
                           "detect.post": 1.5, "detect.copy_back": 4.0,
                           "detect.strip": 2.0, "train.batch": 1.0,
                           "train.forward": 30.0, "train.backward": 40.0,
                           "train.update": 5.0}}
    ctx = {"trace": {"program": program}, "profiled_steps": 2}
    read = {n: f(ctx) for n, (_, f) in spans.READERS.items()}
    assert read == pytest.approx({
        "detect_issue_ms": 22.0, "detect_wait_ms": 4.0, "detect_strip_ms": 2.0,
        "detect_idle_issue_ms": 3.0, "detect_idle_after_ms": 2.0,
        "train_issue_ms": 76.0, "train_loss_busy_ms": 3.0,
        "train_update_busy_ms": 1.0})


@pytest.mark.parametrize("ctx", [
    {}, {"trace": None}, {"trace": {"busy_s": 1.0}, "profiled_steps": 4},
    {"trace": {"program": {"idle_s": {}, "busy_s": {}, "host_ms": {}}},
     "profiled_steps": 0}], ids=["empty", "no-trace", "no-spans", "nothing"])
def test_each_reader_gives_none_without_spans(ctx):
    for name, (_, read) in spans.READERS.items():
        assert read(ctx) is None, name


def test_probe_on_a_program_without_recording_prints_the_harness_metrics(
        tiny_root, monkeypatch):
    from mydetection_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "recording")
    saved = harness.Profiled
    line = spanprobe.traced("fcos_detect_b32", SEED, 0.5,
                            torch.device("cpu"), root=tiny_root)
    want, _, _ = harness.run("fcos_detect_b32", SEED, 0.5, True,
                             torch.device("cpu"), time.perf_counter(),
                             root=tiny_root)
    assert line["correct"] is True
    assert set(line["metrics"]) == set(want["metrics"])
    assert not set(line["metrics"]) & set(spans.READERS)
    assert harness.Profiled is saved
    assert "program" not in line and "span_checks" not in line


def test_probe_puts_the_harness_back_and_reads_no_device_metric_on_the_cpu(
        tiny_root):
    """On the CPU the profiler sees no device, so no device metric and no
    breakdown are read; the harness's Profiled is put back."""
    saved = harness.Profiled
    line = spanprobe.traced("yolov3_train_b64", SEED, 0.3,
                            torch.device("cpu"), root=tiny_root)
    assert harness.Profiled is saved
    assert line["correct"] is True
    kind = cells.load_cell("yolov3_train_b64", tiny_root)["traffic"]["kind"]
    assert kind == "train" and set(line["metrics"]) == {"train_fwd_ms",
                                                        "train_bwd_ms"}
