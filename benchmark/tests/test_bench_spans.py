"""``spans.py`` and the readers of the program's spans on a hand-made
traced stretch: kernels launched inside and outside a span (matched by
correlation id), sync calls inside and outside, two units; and None
where the stretch holds no event of the span, as a program without it
records."""

import pytest

from benchmark import harness, spans
from benchmark.trace import Reading


def _span(name, ts, dur, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _launch(ts, corr, name="cudaLaunchKernel"):
    return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 2, "args": {"correlation": corr}}


def _kernel(ts, dur, corr):
    return {"cat": "kernel", "name": "k", "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _stretch(units=2):
    """Two requests of ``ts.search`` (0-100 µs, 200-300 µs), each with a
    plan, a tokenize and rows; kernels of 10 µs (plan) and 7 µs (outside)."""
    ev = []
    for base, c in ((0, 1), (200, 11)):
        ev += [_span("ts.search", base, 100), _span("ts.tokenize", base + 5, 20),
               _span("ts.ivf.plan", base + 30, 10), _span("ts.search.rows", base + 80, 15),
               _span("ts.encoder.attention", base + 50, 5), _span("ts.encoder.ffn", base + 56, 5),
               _span("ts.train.optimizer", base + 62, 5),
               _launch(base + 31, c), _kernel(base + 500, 10, c),
               _launch(base + 51, c + 1), _kernel(base + 510, 3, c + 1),
               _launch(base + 57, c + 2), _kernel(base + 520, 4, c + 2),
               _launch(base + 63, c + 3), _kernel(base + 530, 2, c + 3),
               _launch(base + 150, c + 4), _kernel(base + 540, 7, c + 4),
               _launch(base + 70, c + 5, "cudaStreamSynchronize"),
               _launch(base + 90, c + 6, "cudaMemcpyAsync"),
               _launch(base + 120, c + 7, "cudaDeviceSynchronize")]
    return Reading(ev, wall_s=1.0, units=units)


def test_host_ms_sums_the_span_a_unit():
    r = _stretch()
    assert spans.host_ms(r, "ts.tokenize") == pytest.approx(2 * 20e-3 / 2)
    assert spans.host_ms(r, "ts.search.rows") == pytest.approx(15e-3)
    assert spans.host_ms(r, "ts.absent") is None


def test_device_ms_reads_the_kernels_launched_inside():
    r = _stretch()
    assert spans.device_ms(r, "ts.ivf.plan") == pytest.approx(10e-3)
    assert spans.device_ms(r, "ts.search") == pytest.approx((10 + 3 + 4 + 2) * 1e-3)
    assert spans.device_ms(r, "ts.absent") is None


def test_calls_in_counts_the_named_calls_that_start_inside():
    r = _stretch()
    assert spans.calls_in(r, "ts.search", spans.SYNC_CALLS) == pytest.approx(1.0)
    assert spans.calls_in(r, "ts.search", ("cudaLaunchKernel",)) == pytest.approx(4.0)
    assert spans.calls_in(r, "ts.ivf.plan", spans.SYNC_CALLS) == 0
    assert spans.calls_in(r, "ts.absent", spans.SYNC_CALLS) is None


def test_no_reading_or_no_units_reads_none():
    r = _stretch(units=0)
    for fn in (spans.host_ms, spans.device_ms):
        assert fn(None, "ts.search") is None and fn(r, "ts.search") is None
    assert spans.calls_in(r, "ts.search", spans.SYNC_CALLS) is None


READERS = {
    "tokenize_ms.text": 20e-3, "tokenize_ms.encode": 20e-3, "rows_ms.text": 15e-3,
    "host_syncs.text": 1.0, "ivf_plan_ms.search": 10e-3, "attention_ms.encode": 3e-3,
    "ffn_ms.encode": 4e-3, "optim_step_ms": 2e-3,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader(name):
    read = harness.load_reader(name)
    assert read({"reading": _stretch()}) == pytest.approx(READERS[name])
    without = Reading([e for e in _stretch().host + _stretch().device
                       if e.get("cat") != "user_annotation"], 1.0, 2)
    assert read({"reading": without}) is None
    assert read({}) is None


def test_the_new_metrics_are_entries_that_read_spans():
    bench = harness.load_benchmark()
    mine = {m["name"]: m for m in bench["per_layer"] if m["name"] in READERS}
    assert set(mine) == set(READERS)
    assert all(m["source"] == "program_span" and m["workloads"] for m in mine.values())
