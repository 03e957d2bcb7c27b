"""The port's spans and counters: ``utils.profiling.span`` inside the
fits, on ``torch.profiler``'s timeline, and the feed's counters in every
streamed fit's ``last_fit_stats_.extra``.

Under ``utils.profiling.trace()`` each stage writes a ``petal.*``
``user_annotation`` event, nested in the stage that encloses it on its
thread; with no profiler running a span is one shared no-op; the spans
change no bit of any fit.
"""

import json
import socket
from collections import Counter

import numpy as np
import pytest
import torch

import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.models import streaming as pst
from petal_decomposition_tpu_torch.utils import profiling

FIT = "petal.fit"


def _data(n=600, d=12, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * np.linspace(3.0, 1.0, d)
            + 2.0).astype(dtype)


def _ica_data(n=800, k=4, seed=1):
    rng = np.random.default_rng(seed)
    return rng.laplace(size=(n, k)) @ rng.standard_normal((k, k))


def _traced(tmp_path, fn):
    """``fn()`` under ``utils.profiling.trace()``: its result and the
    trace's ``petal.*`` spans as ``(name, tid, start, end)``."""
    with profiling.trace(str(tmp_path)):
        out = fn()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("petal.")]
    return out, spans


def _parent(span, spans):
    """The name of the innermost other span of ``span``'s thread that
    holds it, or None."""
    name, tid, s, e = span
    holders = [o for o in spans if o is not span and o[1] == tid
               and o[2] <= s and e <= o[3] and (o[3] - o[2]) >= (e - s)]
    return min(holders, key=lambda o: o[3] - o[2])[0] if holders else None


def _names(spans):
    return Counter(name for name, *_ in spans)


def _parents(spans, name):
    return {_parent(sp, spans) for sp in spans if sp[0] == name}


def test_without_a_profiler_a_span_is_one_shared_no_op(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *args, **kw):
        made.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert profiling.span("petal.a") is profiling.span("petal.b")
    x = _data()
    pt.RandomizedPca(3, seed=1, device="cpu", range_finder="gram",
                     gram_projection="gram").fit(x)
    pt.FastIca(seed=1, device="cpu", max_iter=3).fit(_ica_data())
    pt.RandomizedPca(3, seed=1, device="cpu").fit_batched(
        [x[:300], x[300:]], block_rows=300)
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("petal.recorded"):
            pass
    assert made == ["petal.recorded"]


def test_randomized_pca_gram_route_stages(tmp_path):
    x = _data()
    m, spans = _traced(tmp_path, lambda: pt.RandomizedPca(
        3, seed=1, device="cpu", range_finder="gram",
        gram_projection="gram").fit(x))
    stages = ["petal.rpca.moments", "petal.rpca.gram_recovery",
              "petal.rpca.recover_u", "petal.rpca.svd_flip"]
    assert _names(spans) == Counter({FIT: 1, **{s: 1 for s in stages}})
    for s in stages:
        assert _parents(spans, s) == {FIT}
    order = sorted((sp for sp in spans if sp[0] in stages), key=lambda sp: sp[2])
    assert [sp[0] for sp in order] == stages
    assert m.last_fit_stats_.n_samples == 600


def test_randomized_pca_sketch_route_stages(tmp_path):
    x = _data()
    _, spans = _traced(tmp_path, lambda: pt.RandomizedPca(
        3, seed=1, device="cpu", range_finder="direct").fit(x))
    stages = ["petal.rpca.sketch", "petal.rpca.orthonormalize",
              "petal.rpca.project", "petal.rpca.svd_b",
              "petal.rpca.recover_u", "petal.rpca.svd_flip"]
    assert _names(spans) == Counter({FIT: 1, **{s: 1 for s in stages}})
    for s in stages:
        assert _parents(spans, s) == {FIT}


def test_fast_ica_step_parts(tmp_path):
    ica, spans = _traced(tmp_path, lambda: pt.FastIca(
        seed=3, device="cpu", max_iter=4, tol=0.0).fit(_ica_data()))
    steps = ica.n_iter_
    assert steps == 4
    assert _names(spans) == Counter({
        FIT: 1, "petal.ica.whiten": 1, "petal.ica.iterate": 1,
        "petal.ica.sums": steps, "petal.ica.decorrelate": steps,
        "petal.ica.lim_read": steps})
    assert _parents(spans, "petal.ica.whiten") == {FIT}
    assert _parents(spans, "petal.ica.iterate") == {FIT}
    for part in ("petal.ica.sums", "petal.ica.decorrelate",
                 "petal.ica.lim_read"):
        assert _parents(spans, part) == {"petal.ica.iterate"}


@pytest.mark.parametrize("depth", ["2", "0"])
def test_fit_batched_feed_spans(tmp_path, monkeypatch, depth):
    monkeypatch.setenv("PETAL_STREAM_PREFETCH", depth)
    x = _data()
    _, spans = _traced(tmp_path, lambda: pt.RandomizedPca(
        3, seed=1, device="cpu").fit_batched([x[:300], x[300:]],
                                             block_rows=300))
    names = _names(spans)
    assert names[FIT] == 1 and names["petal.stream.solve"] == 1
    assert names["petal.stream.accum"] == 2
    assert names["petal.stream.host_copy"] == 2
    main = next(sp[1] for sp in spans if sp[0] == FIT)
    copies = {sp[1] for sp in spans if sp[0] == "petal.stream.host_copy"}
    for s in ("petal.stream.accum", "petal.stream.solve"):
        assert _parents(spans, s) == {FIT}
    if depth == "0":
        # No worker: the copies run on the caller's thread, in the fit.
        assert names["petal.stream.feed_wait"] == 0
        assert copies == {main}
        assert _parents(spans, "petal.stream.host_copy") == {FIT}
    else:
        # Two chunks and the end of the stream are waited for; the
        # worker stages on a thread of its own.
        assert names["petal.stream.feed_wait"] == 3
        assert _parents(spans, "petal.stream.feed_wait") == {FIT}
        assert copies and main not in copies
        fit = next(sp for sp in spans if sp[0] == FIT)
        for sp in spans:
            if sp[0] == "petal.stream.host_copy":
                assert fit[2] <= sp[2] and sp[3] <= fit[3]


@pytest.mark.parametrize("entry", ["rpca_fit", "ica_fit", "rpca_fit_batched",
                                   "pca_partial_fit", "ica_fit_batched"])
def test_the_profiler_changes_no_bit_of_a_fit(tmp_path, entry):
    x, xi = _data(), _ica_data()

    def run():
        if entry == "rpca_fit":
            return pt.RandomizedPca(3, seed=1, device="cpu").fit(x).components_
        if entry == "ica_fit":
            return pt.FastIca(seed=2, device="cpu", max_iter=20).fit(
                xi).components_
        if entry == "rpca_fit_batched":
            return pt.RandomizedPca(3, seed=1, device="cpu").fit_batched(
                [x[:250], x[250:]], block_rows=200).components_
        if entry == "pca_partial_fit":
            m = pt.Pca(3, device="cpu")
            m.partial_fit(x[:300], block_rows=128)
            return m.partial_fit(x[300:]).components_
        return pt.FastIca(seed=2, device="cpu", max_iter=20).fit_batched(
            [xi[:500], xi[500:]], block_rows=256).components_

    plain = run()
    traced, spans = _traced(tmp_path, run)
    assert spans
    assert torch.equal(plain, traced)


@pytest.mark.parametrize("depth", ["2", "0"])
def test_stream_counters(monkeypatch, depth):
    monkeypatch.setenv("PETAL_STREAM_PREFETCH", depth)
    x = _data(n=700, d=10, dtype=np.float32)
    m = pt.RandomizedPca(3, seed=1, device="cpu").fit_batched(
        [x[:350], x[350:]], block_rows=256)
    extra = m.last_fit_stats_.extra
    assert extra["staged_bytes"] == 700 * 10 * 4
    assert extra["host_copy_s"] >= 0 and extra["feed_wait_s"] >= 0
    if depth == "0":
        assert extra["feed_wait_s"] == 0
    # The keys the streams had keep their names and values.
    assert extra["streamed_blocks"] == 3
    assert extra["mean_shift_ratio"] >= 0


def test_stream_counters_partial_fit_per_call():
    x = _data(n=900, d=8)
    m = pt.Pca(2, device="cpu")
    m.partial_fit(x[:500], block_rows=128)
    assert m.last_fit_stats_.extra["staged_bytes"] == 500 * 8 * 8
    m.partial_fit(x[500:])
    st = m.last_fit_stats_
    assert st.extra["staged_bytes"] == 400 * 8 * 8
    assert st.extra["partial_fit_calls"] == 2
    assert st.extra["streamed_blocks"] == 8
    assert (st.n_samples, st.n_features) == (900, 8)
    assert st.extra["host_copy_s"] >= 0 and st.extra["feed_wait_s"] >= 0


@pytest.mark.parametrize("whiten", [True, False])
def test_stream_counters_fast_ica_count_both_passes(whiten):
    """Whitened, both passes stage the rows; ``whiten=False`` measures
    the stream on the host first and stages it once."""
    x = _ica_data(n=800, k=4)
    m = pt.FastIca(seed=2, device="cpu", max_iter=10, whiten=whiten)
    m.fit_batched([x[:400], x[400:]], block_rows=300)
    st = m.last_fit_stats_
    assert st.extra["staged_bytes"] == (2 if whiten else 1) * 800 * 4 * 8
    assert st.extra["host_copy_s"] >= 0 and st.extra["feed_wait_s"] >= 0
    assert st.n_iter == m.n_iter_ and (st.n_samples, st.n_features) == (800, 4)
    assert st.extra["streamed_blocks"] == 3
    assert ("whitened_buffer_cols" in st.extra) == whiten


@pytest.mark.parametrize("entry", ["pca_fit_batched", "rpca_partial_fit",
                                   "ica_fit_batched"])
def test_every_streamed_entry_opens_a_fit_span(tmp_path, entry):
    x = _data()

    def run():
        if entry == "pca_fit_batched":
            return pt.Pca(2, device="cpu").fit_batched(x, block_rows=256)
        if entry == "rpca_partial_fit":
            return pt.RandomizedPca(2, seed=1, device="cpu").partial_fit(
                x, block_rows=256)
        return pt.FastIca(seed=1, device="cpu", max_iter=3).fit_batched(
            _ica_data(), block_rows=256)

    m, spans = _traced(tmp_path, run)
    assert _names(spans)[FIT] == 1
    assert m.last_fit_stats_.wall_time_s > 0


def test_a_partial_fit_with_no_rows_records_nothing():
    x = _data(n=400, d=8)
    m = pt.Pca(2, device="cpu").partial_fit(x, block_rows=128)
    stats = m.last_fit_stats_
    m.partial_fit(np.zeros((0, 8)))
    assert m.last_fit_stats_ is stats


def test_device_prefetch_counts_into_the_given_counters(monkeypatch):
    monkeypatch.setenv("PETAL_STREAM_PREFETCH", "2")
    chunks = [np.ones((5, 3), np.float32), np.ones((2, 3), np.float32)]
    feed = pst._FeedCounters()
    got = list(pst._device_prefetch(iter(chunks), torch.device("cpu"), feed))
    assert [tuple(b.shape) for b in got] == [(5, 3), (2, 3)]
    assert feed.staged_bytes == 7 * 3 * 4
    extra = {}
    feed.record(extra)
    assert set(extra) == {"feed_wait_s", "host_copy_s", "staged_bytes"}


@pytest.fixture
def one_rank_group():
    """A gloo process group of this process alone, left after the test."""
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_placement_and_collectives(tmp_path, one_rank_group):
    """In a group, placing local rows gathers their shape under
    ``petal.mesh.place``, every all-reduce of a fit opens
    ``petal.mesh.all_reduce`` and every gather ``petal.mesh.all_gather``
    (a group of one calls them too), and the fit's ``extra`` counts its
    own collectives."""
    from petal_decomposition_tpu_torch.parallel import (
        distributed,
        make_mesh,
        rows_from_local,
    )

    mesh = make_mesh(devices=["cpu"] * 2)
    x = torch.from_numpy(_data())
    model = pt.RandomizedPca(3, seed=1, mesh=mesh)
    counts = {}

    def run():
        rows = rows_from_local(x, mesh)
        calls, nbytes = distributed.collectives.calls, distributed.collectives.bytes
        model.fit(rows)
        counts["calls"] = distributed.collectives.calls - calls
        counts["bytes"] = distributed.collectives.bytes - nbytes
        return rows

    rows, spans = _traced(tmp_path, run)
    names = _names(spans)
    assert names["petal.mesh.place"] == 1
    assert _parents(spans, "petal.mesh.all_gather") == {"petal.mesh.place"}
    reduces = [sp for sp in spans if sp[0] == "petal.mesh.all_reduce"]
    assert reduces and names["petal.mesh.all_gather"] == 1
    (fit,) = [sp for sp in spans if sp[0] == FIT]
    assert all(fit[2] <= sp[2] and sp[3] <= fit[3] for sp in reduces)
    extra = model.last_fit_stats_.extra
    assert extra["collective_calls"] == counts["calls"] == len(reduces)
    assert extra["collective_bytes"] == counts["bytes"] > 0
    assert torch.equal(model.components_, pt.RandomizedPca(
        3, seed=1, mesh=mesh).fit(x).components_)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_pinned_ring_stages_on_the_worker_thread(tmp_path, monkeypatch,
                                                     cuda_device):
    """On the card the worker waits for a free slot (``slot_wait``) and
    copies into pinned staging (``host_copy``) on its own thread; the
    counters count every chunk's bytes."""
    monkeypatch.setenv("PETAL_STREAM_PREFETCH", "2")
    x = _data(n=4000, d=64, dtype=np.float32)
    blocks = [x[i:i + 500] for i in range(0, 4000, 500)]
    m, spans = _traced(tmp_path, lambda: pt.RandomizedPca(
        4, seed=1, device=cuda_device).fit_batched(blocks, block_rows=500))
    names = _names(spans)
    main = next(sp[1] for sp in spans if sp[0] == FIT)
    worker = {sp[1] for sp in spans if sp[0] in ("petal.stream.host_copy",
                                                  "petal.stream.slot_wait")}
    assert names["petal.stream.host_copy"] == 8
    assert names["petal.stream.slot_wait"] >= 8
    assert names["petal.stream.accum"] == 8
    assert worker and main not in worker
    extra = m.last_fit_stats_.extra
    assert extra["staged_bytes"] == 4000 * 64 * 4
    assert extra["host_copy_s"] > 0 and extra["feed_wait_s"] >= 0
    plain = pt.RandomizedPca(4, seed=1, device=cuda_device).fit_batched(
        blocks, block_rows=500)
    assert torch.equal(plain.components_, m.components_)
