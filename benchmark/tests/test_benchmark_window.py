"""The window: it opens when the last warm-up visit completes and counts the
videos that complete inside it."""

import pytest

from benchmark.harness import cell


def test_window_opens_after_every_warmup_visit(monkeypatch):
    clock = iter([1.0, 2.0, 3.0, 4.0, 12.0, 14.5, 15.0])
    monkeypatch.setattr(cell.time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(cell, "process_age", lambda: 42.0)
    stream = [{"visit": i, "link": f"/s/v{i}", "frames": 10 * (i + 1)} for i in range(6)]
    rec = cell.Recorder(stream, warmup=3, seconds=10, keep=set())
    opened = []
    rec.on_open = lambda: opened.append(rec.t_open)  # the card's peak is reset here
    rec.completed("/s/v0")            # t = 1
    rec.completed("/s/v3")            # t = 2: not a warm-up visit
    rec.completed("/s/v2")            # t = 3
    assert rec.t_open is None
    rec.completed("/s/v1")            # t = 4: the last warm-up visit opens the window
    assert rec.t_open == 4.0 and rec.t_close == 14.0 and rec.setup_s == 42.0
    assert opened == [4.0]
    rec.completed("/s/v4")            # t = 12: inside
    rec.completed("/s/v5")            # t = 14.5: after the close
    rec.completed("/elsewhere")       # not a visit of the stream: ignored
    assert [v["visit"] for v in rec.in_window()] == [4]
    assert opened == [4.0]


def test_process_age_is_positive_and_grows():
    a = cell.process_age()
    b = cell.process_age()
    assert 0 < a <= b


@pytest.mark.parametrize("trace", [False, True])
def test_dry_run_reports_the_cells_metrics(trace, tmp_env):
    from benchmark.harness import manifest

    result = cell.run_cell(cell.Options(workload="i3d_pwc.kinetics_packed", seed=2 ** 31 + 5,
                                        seconds=6, trace=trace, dry_run=True))
    bench = manifest.load()
    names = {m["name"] for m in (manifest.per_layer_for(bench, "i3d_pwc.kinetics_packed")
                                 if trace else bench["end_to_end"])}
    # on the CPU the trace holds no device activity: the readers that need it stay silent
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
        assert result["metrics"]["frames_per_s"]["value"] > 0
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert ("breakdown" in result) == trace
    # the profiled sub-window follows the window, as long as the traffic asks
    assert ("profiled" in result["window"]) == trace
    if trace:
        assert result["window"]["profiled"]["seconds"] >= 2
    assert list(result)[-1] == "checks"
