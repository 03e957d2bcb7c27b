"""The program's spans in a traced run (``core/spans.py``) and the
readers of ``ica.decorr_pct``, ``ica.sync_wait_pct`` and
``moments.roofline_pct``: the spans move no reading the trace already
gave, kernels fall under the span that launched them, idle gaps under
the span that covers them, and a program without spans reads nothing."""

import importlib
import json
import time
from types import SimpleNamespace

import pytest
import torch

from port_bench.core import harness, readers, spans, spec, trace

from .conftest import ROOT, SEED, tiny_cell


def x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def doc_with_spans():
    """A fit on thread 1: a moments stage launching kernel 1, an iterate
    stage launching kernel 2 with a lim read inside it; a worker (thread
    2) copying; a kernel launched outside every stage; a span of the
    device's timeline and one that is not the program's.  Times in µs."""
    ev = [
        x("user_annotation", "petal.fit", 0, 100),
        x("user_annotation", "petal.rpca.moments", 5, 40),
        x("cpu_op", "aten::mm", 6, 10),
        x("cuda_runtime", "cudaLaunchKernel", 8, 2, corr=1),
        x("kernel", "gemm", 12, 30, tid=7, corr=1),
        x("user_annotation", "petal.ica.iterate", 50, 45),
        x("user_annotation", "petal.ica.lim_read", 80, 10),
        x("cuda_runtime", "cudaLaunchKernel", 55, 2, corr=2),
        x("kernel", "tanh", 60, 10, tid=7, corr=2),
        x("user_annotation", "petal.stream.host_copy", 20, 30, tid=2),
        x("cuda_runtime", "cudaLaunchKernel", 102, 1, corr=3),
        x("kernel", "fill", 104, 2, tid=7, corr=3),
        x("gpu_user_annotation", "petal.rpca.moments", 12, 30, tid=7),
        x("user_annotation", "other.span", 0, 1),
    ]
    return {"traceEvents": ev}


def stripped(doc):
    return {"traceEvents": [e for e in doc["traceEvents"]
                            if "user_annotation" not in e["cat"]]}


def test_spans_move_no_reading_of_the_trace():
    with_spans = trace.summarize(trace.events_from_chrome(doc_with_spans()))
    without = trace.summarize(trace.events_from_chrome(stripped(doc_with_spans())))
    assert (with_spans.window_s, with_spans.busy_s, with_spans.busy) == (
        without.window_s, without.busy_s, without.busy)
    assert trace.device_ops(with_spans) == trace.device_ops(without)
    assert trace.idle_gaps(with_spans) == trace.idle_gaps(without)
    for s in (with_spans, without):
        assert len(s.kernels()) == 3
    run = SimpleNamespace(summary=with_spans)
    run_without = SimpleNamespace(summary=without)
    assert readers.idle_pct(run) == readers.idle_pct(run_without)
    kpi = spec.module(ROOT, "metrics", "ica.kernels_per_iter")
    fits = [harness.Fit(1.0, 10), harness.Fit(1.0, 10)]
    run.traced_fits = run_without.traced_fits = fits
    assert kpi.value(run) == kpi.value(run_without) == 3 / 20


def test_kernels_fall_under_the_span_that_launched_them():
    sp = spans.from_chrome(doc_with_spans())
    assert sp.main_tid() == 1
    assert {s.name for s in sp.spans} == {
        "petal.fit", "petal.rpca.moments", "petal.ica.iterate",
        "petal.ica.lim_read", "petal.stream.host_copy"}
    got = spans.kernels_by_span(sp)
    assert got["petal.rpca.moments"] == [pytest.approx((12e-6, 42e-6))]
    assert got["petal.ica.iterate"] == [pytest.approx((60e-6, 70e-6))]
    assert got[spans.OUTSIDE] == [pytest.approx((104e-6, 106e-6))]
    assert spans.device_s(got["petal.rpca.moments"]) == pytest.approx(30e-6)
    assert spans.host_s(sp, "petal.ica.iterate") == pytest.approx(45e-6)
    assert spans.host_s(sp, "petal.ica.lim_read") == pytest.approx(10e-6)
    assert spans.host_s(sp, "petal.stream.host_copy") == 0.0  # the worker's
    assert spans.count(sp, "petal.rpca.moments") == 1


def test_idle_by_span_takes_the_innermost_span_of_the_fitting_thread():
    doc = doc_with_spans()
    s = trace.summarize(trace.events_from_chrome(doc))
    got = dict(map(tuple, spans.idle_by_span(s, spans.from_chrome(doc))))
    # Busy: [12, 42], [60, 70], [104, 106] µs.  The gap [42, 60] has its
    # middle (51) in iterate, inside the fit; the gap [70, 104] its
    # middle (87) in lim_read, inside iterate.
    assert got == pytest.approx({"petal.ica.iterate": 18e-6,
                                 "petal.ica.lim_read": 34e-6})


def test_innermost_with_siblings_and_gaps():
    S = spans.Span
    ss = [S("a", 1, 0.0, 10.0), S("b", 1, 1.0, 2.0), S("c", 1, 4.0, 2.0),
          S("d", 1, 20.0, 1.0)]
    assert spans.innermost(ss, [0.5, 2.0, 3.5, 5.0, 15.0, 20.5, 2.5]) == [
        "a", "b", "a", "c", None, "d", "b"]


def _fake_run(tmp_path, monkeypatch, doc, name="fastica_64x100k_f32.fit"):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    path = harness.trace_dir(ROOT) / f"{name}-{SEED}.json"
    path.write_text(json.dumps(doc))
    summary = trace.summarize_file(path)
    x = torch.zeros((1000, 8))
    return SimpleNamespace(
        root=ROOT, cell=SimpleNamespace(name=name), summary=summary,
        inputs=SimpleNamespace(arg=x), peaks={"flop_s": {"float32": 1e12},
                                             "hbm_bytes_s": 1e12},
        counts=importlib.import_module("port_bench.counts.randomized_pca"),
        cfg={"data": {"dtype": "float32"}})


def test_the_readers_read_the_runs_trace(tmp_path, monkeypatch, capsys):
    run = _fake_run(tmp_path, monkeypatch, doc_with_spans())
    decorr = spec.module(ROOT, "metrics", "ica.decorr_pct")
    wait = spec.module(ROOT, "metrics", "ica.sync_wait_pct")
    assert wait.value(run) == pytest.approx(100 * 10 / 45)
    assert decorr.value(run) == 0.0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [list(line) for line in lines] == [["idle_by_span"]]
    moments = spec.module(ROOT, "metrics", "moments.roofline_pct")
    n, d = run.inputs.arg.shape
    least = max(run.counts.gram_pass_ops(n, d) / 1e12,
                run.counts.gram_pass_bytes(n, d, 4) / 1e12)
    assert moments.value(run) == pytest.approx(100 * least / 30e-6)


def test_a_program_without_spans_reads_nothing(tmp_path, monkeypatch):
    run = _fake_run(tmp_path, monkeypatch, stripped(doc_with_spans()))
    for name in ("ica.decorr_pct", "ica.sync_wait_pct", "moments.roofline_pct"):
        assert spec.module(ROOT, "metrics", name).value(run) is None


def test_a_trace_that_is_not_the_runs_reads_nothing(tmp_path, monkeypatch):
    run = _fake_run(tmp_path, monkeypatch, doc_with_spans())
    run.summary = trace.summarize(trace.events_from_chrome(
        stripped(doc_with_spans()))[:-1])
    assert spans.of_run(run) is None


def test_a_traced_run_on_the_cpu_reads_the_step_parts(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell = tiny_cell("fastica_64x100k_f32.fit")
    r = harness.run_cell(ROOT, cell, SEED, 0.2, True, torch.device("cpu"),
                         time.perf_counter())
    assert r["correct"] is True
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert 0 < got["ica.decorr_pct"] < 100
    assert 0 <= got["ica.sync_wait_pct"] < 100
    out = capsys.readouterr().out
    assert '{"idle_by_span": ' in out


def test_moments_roofline_reads_none_without_kernels(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell = tiny_cell("rpca_1Mx4096_f32.incore")
    r = harness.run_cell(ROOT, cell, SEED, 0.2, True, torch.device("cpu"),
                         time.perf_counter())
    assert r["correct"] is True
    assert "moments.roofline_pct" not in r["metrics"]
