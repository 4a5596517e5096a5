"""The port's flight recorder and metrics plane
(shadow_tpu_torch/runtime/flightrec.py) held against the JAX package's on
the CPU, through both CLIs on tests/test_torch_recovery_cli.py's phold
config (12 peers to 200 ms, four rounds a chunk, one device): the
metrics JSONL samples and events and the Prometheus file of a clean run,
and the black box (`flight-recorder.json`) of a run that exhausts its
capacity under `--no-recover`, whose last sample is the failing chunk,
equal apart from the wall-clock fields named in WALL_FIELDS. Also: the
stream's rotation at its size cap, the recorder adding no probe read and
no host_stats fetch to the chunk loop, the profiler window (and CUPTI
torn down when it stops), and the `metrics` subcommand rendering both
files as the reference renders them."""

import dataclasses
import io
import json
import os
import pathlib

import pytest
import torch

from test_pipeline import _phold_world
from test_torch_ensemble import port_world
from test_torch_recovery_cli import CONFIG, SMALL

from shadow_tpu.cli import main as j_main
from shadow_tpu.runtime.flightrec import render_summary_file as j_render_summary_file
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu.utils import shadow_log as j_log
from shadow_tpu_torch.cli import main as t_main
from shadow_tpu_torch.engine import round as t_round
from shadow_tpu_torch.engine.round import ChunkProbe, bootstrap, run_until
from shadow_tpu_torch.engine.state import init_state
from shadow_tpu_torch.runtime import flightrec
from shadow_tpu_torch.runtime.flightrec import FlightRecorder, render_summary_file
from shadow_tpu_torch.utils import shadow_log as t_log
from shadow_tpu_torch.utils.tracker import Tracker


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the fields that hold wall-clock readings: a sample's and an event's
# seconds since the recorder started, the black box's own and its write
# time; every other field of the files must be equal
WALL_FIELDS = ("wall_s", "written_at")


def _drop_wall(obj):
    if isinstance(obj, dict):
        return {k: _drop_wall(v) for k, v in obj.items() if k not in WALL_FIELDS}
    if isinstance(obj, list):
        return [_drop_wall(v) for v in obj]
    return obj


def _run_both(tmp_path, capacities, *flags, rc=0):
    """Both CLIs on the phold config in one data directory (each run's
    files are read before the next run writes them): {"ref"/"port": the
    files the run wrote, by name}."""
    path = tmp_path / "phold.yaml"
    data = tmp_path / "data"
    path.write_text(CONFIG.format(data_dir=data, capacities=capacities, seed=1))
    out = {}
    for name, main, log, extra in (("ref", j_main, j_log, ()),
                                   ("port", t_main, t_log, ("--device", "cpu"))):
        log.set_sink(io.StringIO())  # the runs' records stay out of the test's output
        try:
            assert main(["run", *extra, *flags, str(path)]) == rc
        finally:
            log.flush()
            log.set_sink(None)
        out[name] = {p.name: p.read_text() for p in sorted(tmp_path.glob("m.*"))}
        box = data / "flight-recorder.json"
        if box.exists():
            out[name]["flight-recorder.json"] = box.read_text()
            box.unlink()
    return out


def _jsonl(text: str) -> "list[dict]":
    return [json.loads(ln) for ln in text.splitlines() if ln.strip()]


_CLEAN = {}


def _clean_runs(tmp_path_factory):
    if not _CLEAN:
        tmp = tmp_path_factory.mktemp("clean")
        _CLEAN.update(_run_both(
            tmp, "", "--metrics-file", str(tmp / "m.jsonl"), "--metrics-prom", str(tmp / "m.prom")))
        _CLEAN["tmp"] = tmp
    return _CLEAN


_FAILED = {}


def _failed_runs(tmp_path_factory):
    """At queue 4 and outbox 1 the first chunk overflows: under
    --no-recover the run fails there and leaves the black box."""
    if not _FAILED:
        _FAILED.update(_run_both(tmp_path_factory.mktemp("failed"), SMALL, "--no-recover", rc=1))
    return _FAILED


def test_metrics_stream_matches_shadow_tpu_run(tmp_path_factory):
    runs = _clean_runs(tmp_path_factory)
    want, got = (_jsonl(runs[n]["m.jsonl"]) for n in ("ref", "port"))
    samples = [s for s in got if s["type"] == "sample"]
    assert len(samples) > 10
    assert [s["chunk"] for s in samples] == list(range(len(samples)))
    assert _drop_wall(got) == _drop_wall(want)
    assert "flight-recorder.json" not in runs["port"]  # no failure, no black box


def test_prom_snapshot_matches_shadow_tpu_run(tmp_path_factory):
    runs = _clean_runs(tmp_path_factory)
    assert "shadow_tpu_events_total" in runs["port"]["m.prom"]
    assert runs["port"]["m.prom"] == runs["ref"]["m.prom"]


def test_capacity_failure_black_box_matches_shadow_tpu_run(tmp_path_factory):
    """The failed run's black box: its last sample is the failing chunk's."""
    runs = _failed_runs(tmp_path_factory)
    want, got = (json.loads(runs[n]["flight-recorder.json"]) for n in ("ref", "port"))
    assert got["failure"]["kind"] == "capacity"
    assert got["failure"]["error"].startswith("event capacity exhausted")
    assert got["last_sample"] == got["samples"][-1]
    assert got["last_sample"]["chunk"] == got["chunks"] - 1
    assert _drop_wall(got) == _drop_wall(want)


def test_metrics_subcommand_renders_like_shadow_tpu(tmp_path, tmp_path_factory, capsys):
    runs = _clean_runs(tmp_path_factory)
    stream = tmp_path / "m.jsonl"
    stream.write_text(runs["port"]["m.jsonl"])
    assert t_main(["metrics", str(stream)]) == 0
    out = capsys.readouterr().out
    assert "p50" in out and "events" in out
    assert out.strip() == render_summary_file(str(stream)) == j_render_summary_file(str(stream))
    box = tmp_path / "flight-recorder.json"
    box.write_text(_failed_runs(tmp_path_factory)["port"]["flight-recorder.json"])
    capsys.readouterr()
    assert t_main(["metrics", str(box)]) == 0
    out = capsys.readouterr().out
    assert "FAILURE: kind=capacity" in out
    assert out.strip() == j_render_summary_file(str(box))
    garbage = tmp_path / "garbage.json"
    garbage.write_text("{}")
    assert t_main(["metrics", str(garbage)]) == 1


def _probe(**kw) -> ChunkProbe:
    """A ChunkProbe with every cumulative lane 0 but those given."""
    fields = {f.name: 0 for f in dataclasses.fields(ChunkProbe)}
    fields.update(kw)
    return ChunkProbe(**fields)


def test_metrics_stream_rotates_at_size_cap(tmp_path):
    """tests/test_flightrec.py's rotation case: the stream rotates at
    metrics_max_bytes keeping metrics_keep numbered segments, and the
    newest sample stays in the newest segment."""
    mf = tmp_path / "m.jsonl"
    rec = FlightRecorder(num_hosts=8, metrics_path=str(mf), metrics_max_bytes=2_000,
                         metrics_keep=2)
    for i in range(120):
        rec.observe(_probe(now=(i + 1) * 1000, events_handled=(i + 1) * 10))
    rec.close()
    assert rec.rotations >= 2
    assert mf.exists() and (tmp_path / "m.jsonl.1").exists()
    assert (tmp_path / "m.jsonl.2").exists()
    assert not (tmp_path / "m.jsonl.3").exists()
    for p in (mf, tmp_path / "m.jsonl.1", tmp_path / "m.jsonl.2"):
        assert p.stat().st_size < 2_600

    def samples(p):
        return [s for s in _jsonl(p.read_text()) if s["type"] == "sample"]

    live, older = samples(mf), samples(tmp_path / "m.jsonl.1")
    assert (live or older)[-1]["chunk"] == 119
    if live and older:
        assert older[-1]["chunk"] < live[0]["chunk"]
    events = [e for p in (mf, tmp_path / "m.jsonl.1") for e in _jsonl(p.read_text())
              if e["type"] == "event"]
    assert {e["kind"] for e in events} == {"metrics_rotate"}


def test_recorder_adds_no_probe_read_or_host_stats_fetch(tmp_path, monkeypatch):
    """The recorder reads only the probe the chunk loop read: with it
    installed (metrics stream and prom file on) the loop makes as many
    state_probe reads and host_stats fetches (a tracker's heartbeats, one
    every 10 ms) as without it, and the samples carry no device memory on
    the CPU."""
    jcfg, jm, jt, _ = _phold_world()
    cfg, model, tables = port_world(dataclasses.replace(jcfg, tracker=True), jm, jt)
    st0 = bootstrap(init_state(cfg, model.init("cpu"), device="cpu"), model, cfg)
    calls = {"state_probe": 0, "host_stats": 0}
    for name in calls:
        real = getattr(t_round, name)

        def counting(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(t_round, name, counting)

    def run():
        for k in calls:
            calls[k] = 0
        tracker = Tracker(host_names=[f"h{i}" for i in range(cfg.num_hosts)],
                          heartbeat_ns=10 * NS_PER_MS)
        run_until(st0, 40 * NS_PER_MS, model, tables, cfg, rounds_per_chunk=4, tracker=tracker)
        return dict(calls)

    plain = run()
    assert plain["state_probe"] > 0 and plain["host_stats"] >= 3
    rec = FlightRecorder(num_hosts=cfg.num_hosts, metrics_path=str(tmp_path / "m.jsonl"),
                         prom_path=str(tmp_path / "m.prom"))
    with flightrec.installed(rec):
        recorded = run()
    rec.close()
    assert len(rec.samples) == plain["state_probe"]
    assert recorded == plain
    assert all("device_bytes_in_use" not in s for s in rec.samples)


def test_profiler_window_writes_a_chrome_trace(tmp_path):
    """--xprof-chunks 1:3 brackets the dispatches of chunks 1 and 2: the
    capture starts at chunk 0's sample and stops at chunk 2's, as the
    reference's window does, and leaves a Chrome trace in the directory."""
    prof = tmp_path / "prof"
    rec = FlightRecorder(num_hosts=8, xprof_dir=str(prof), xprof_chunks=(1, 3))
    for i in range(5):
        torch.ones(4).sum()
        rec.observe(_probe(now=(i + 1) * 1000))
    rec.close()
    assert [(e["kind"], e["chunk"]) for e in rec.events] == [("xprof_start", 0),
                                                             ("xprof_stop", 2)]
    trace = json.loads((prof / "chunks-1-3.pt.trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("preset", [None, "0"])
def test_profiler_window_tears_cupti_down_at_stop(tmp_path, monkeypatch, preset):
    """With CUDA activity in the capture, CUPTI is torn down when the
    window stops (TEARDOWN_CUPTI=1), so that the run's later launches pay
    no profiler cost; a caller's own setting is kept."""
    if preset is None:
        monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    else:
        monkeypatch.setenv("TEARDOWN_CUPTI", preset)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []

    class Profile:  # stands in for torch.profiler.profile, which needs the card here
        def __init__(self, activities):
            seen.append((activities, os.environ.get("TEARDOWN_CUPTI")))

        def start(self):
            pass

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            pathlib.Path(path).write_text("{}")

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    rec = FlightRecorder(num_hosts=8, xprof_dir=str(tmp_path / "prof"), xprof_chunks=(1, 3))
    for i in range(4):
        rec.observe(_probe(now=(i + 1) * 1000))
    rec.close()
    assert [e["kind"] for e in rec.events] == ["xprof_start", "xprof_stop"]
    (acts, teardown), = seen
    assert torch.profiler.ProfilerActivity.CUDA in acts
    assert teardown == (preset or "1")


@pytest.mark.parametrize("window", ["3", "3:1", "a:b", "1:2:3"])
def test_xprof_chunks_refusal_like_shadow_tpu_run(tmp_path, capsys, window):
    path = tmp_path / "phold.yaml"
    path.write_text(CONFIG.format(data_dir=tmp_path / "data", capacities="", seed=1))
    texts = []
    for main, extra in ((j_main, ()), (t_main, ("--device", "cpu"))):
        assert main(["run", *extra, "--xprof-chunks", window, str(path)]) == 1
        err = capsys.readouterr().err
        texts.append(err[err.rindex(": error: ") + len(": error: "):].strip())
    assert texts[1] == texts[0] == (
        f"invalid --xprof-chunks {window!r}: expected 'START:END' with 0 <= START < END")


def test_metrics_follow_renders_until_its_update_bound(tmp_path, tmp_path_factory):
    stream = tmp_path / "m.jsonl"
    stream.write_text(_clean_runs(tmp_path_factory)["port"]["m.jsonl"])
    out = io.StringIO()
    assert flightrec.follow_file(str(stream), interval_s=0.01, max_updates=1, out=out) == 1
    assert out.getvalue().strip() == render_summary_file(str(stream))
