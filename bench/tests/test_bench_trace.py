"""Reading the traced window from chrome-trace events."""
import pytest

from bench import trace


def ev(cat, name, ts, dur, device=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if device is not None:
        e["args"] = {"device": device}
    return e


def test_busy_is_the_union_inside_the_window():
    evts = [ev("user_annotation", "window", 100, 1000),
            ev("kernel", "k", 50, 100, 0),          # clipped to 100..150
            ev("kernel", "k", 140, 60, 0),          # overlaps: union to 200
            ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 500, 100, 0),
            ev("kernel", "k", 300, 100, 1),
            ev("cpu_op", "aten::add", 0, 5000)]
    s = trace.summarize(evts, [0, 1])
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_by_device[0] == pytest.approx(200e-6)
    assert s.pageable_by_device == {0: 0.0, 1: 0.0}
    assert s.busy_by_device[1] == pytest.approx(100e-6)
    assert s.busy_s([0, 1]) == pytest.approx(150e-6)
    assert sum(x for _, _, x in s.ops) == pytest.approx(310e-6)


def test_idle_time_by_host_span():
    evts = [ev("user_annotation", "window", 0, 100),
            ev("user_annotation", "step", 0, 60),
            ev("user_annotation", "poll", 60, 10),
            ev("user_annotation", "submit", 80, 10),
            ev("kernel", "k", 10, 20, 0)]
    s = trace.summarize(evts, [0])
    idle = {k: round(v * 1e6, 6) for k, v in s.idle_by_span.items()}
    assert idle == {"step": 40.0, "poll": 10.0, "submit": 10.0, "between calls": 20.0}
    assert sum(s.idle_by_span.values()) + s.busy_s([0]) == pytest.approx(s.window_s)


def test_a_card_with_nothing_on_it_is_idle_all_window():
    s = trace.summarize([ev("user_annotation", "window", 0, 50)], [0, 1])
    assert s.busy_s([0, 1]) == 0.0
    assert s.idle_by_span["between calls"] == pytest.approx(2 * 50e-6)


def test_no_window_no_summary():
    assert trace.summarize([ev("kernel", "k", 0, 1, 0)], [0]).window_s == 0.0


def test_a_copy_through_pageable_memory_is_the_hosts_not_the_cards():
    """It counts apart, and the card idles under it."""
    evts = [ev("user_annotation", "window", 0, 100),
            ev("user_annotation", "step", 0, 100),
            ev("kernel", "k", 0, 20, 0),
            ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 20, 50, 0),
            ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 60, 20, 0)]
    s = trace.summarize(evts, [0])
    assert s.busy_s([0]) == pytest.approx(20e-6)
    assert s.pageable_s([0]) == pytest.approx(60e-6)
    assert s.idle_by_span["step"] == pytest.approx(80e-6)
    assert sum(x for _, _, x in s.ops) == pytest.approx(90e-6)
