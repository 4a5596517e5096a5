"""The host-side tracker plane of the port (shadow_tpu_torch/utils/tracker.py
and the chunk loops' hooks) held against the JAX package's on the CPU:
the per-host heartbeat lines (their text after the wall-clock prefix) and
the sim-stats `tracker` fold without `phases`, on the phold world of
tests/test_tracker.py::test_heartbeat_lines_and_stats_fold_phold and on
examples/tgen cut to 300 ms as tests/test_torch_slice.py cuts it (a
heartbeat every 100 ms, 8 rounds a chunk); an R = 2 ensemble through
flatten_host_stats (`run --replicas 2 --tracker` on tests/test_torch_recovery_cli.py's
phold config), whose metrics stream and prom file are held against the
reference's too; the Chrome trace, well nested, with the reference's span
names; and the trajectory with the tracker on and off. Exact equality
throughout."""

import dataclasses
import io
import json
import pathlib

import pytest
import torch

from test_pipeline import _phold_world
from test_torch_ensemble import port_world
from test_torch_recovery_cli import CONFIG as PHOLD_CONFIG
from test_torch_slice import _tgen_example

from shadow_tpu.cli import main as j_main
from shadow_tpu.engine.round import host_stats as j_host_stats
from shadow_tpu.engine.round import run_until as j_run_until
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu.utils import shadow_log as j_log
from shadow_tpu.utils.tracker import Tracker as JTracker
from shadow_tpu_torch.cli import main as t_main
from shadow_tpu_torch.engine.round import bootstrap, host_stats, run_until
from shadow_tpu_torch.engine.state import init_state, state_to_numpy
from shadow_tpu_torch.utils import shadow_log as t_log
from shadow_tpu_torch.utils.tracker import Tracker


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the reference test's phold run: heartbeats every 10 ms to 40 ms, four
# rounds per chunk
PHOLD_END = 40 * NS_PER_MS
PHOLD_HB = 10 * NS_PER_MS
PHOLD_RPC = 4
# the reference's dispatch span names for a single run
SPAN_NAMES = {"donate_copy", "compile+launch", "chunk_launch", "probe_fetch", "host_stats_fetch"}


def _captured(log, fn):
    """(fn's result, the log records it wrote)."""
    sink = io.StringIO()
    log.set_sink(sink)
    try:
        out = fn()
    finally:
        log.flush()
        log.set_sink(None)
    return out, sink.getvalue()


def _lines(text: str, marker: str) -> "list[str]":
    """The records holding `marker`, without their wall-clock prefix."""
    return [ln.split(" ", 1)[1] for ln in text.splitlines() if marker in ln]


def _fold(tracker) -> dict:
    out = tracker.stats_dict()
    out.pop("phases")
    return out


_RUNS = {}


def _phold_runs():
    """The JAX package's and the port's tracked phold runs (and the port's
    untracked one), once."""
    if not _RUNS:
        jcfg0, jm, jt, jst = _phold_world()
        jcfg = dataclasses.replace(jcfg0, tracker=True)
        names = [f"h{i}" for i in range(jcfg.num_hosts)]
        jtr = JTracker(host_names=names, heartbeat_ns=PHOLD_HB)
        jfinal, jlog = _captured(j_log, lambda: j_run_until(
            jst, PHOLD_END, jm, jt, jcfg, rounds_per_chunk=PHOLD_RPC, tracker=jtr))
        jtr.finalize(j_host_stats(jfinal))

        cfg, model, tables = port_world(jcfg, jm, jt)
        st0 = bootstrap(init_state(cfg, model.init("cpu"), device="cpu"), model, cfg)
        tr = Tracker(host_names=names, heartbeat_ns=PHOLD_HB)
        final, log = _captured(t_log, lambda: run_until(
            st0, PHOLD_END, model, tables, cfg, rounds_per_chunk=PHOLD_RPC, tracker=tr))
        tr.finalize(host_stats(final))
        untracked = run_until(st0, PHOLD_END, model, tables, cfg, rounds_per_chunk=PHOLD_RPC)
        _RUNS.update(jtr=jtr, jlog=jlog, tr=tr, log=log, final=final, untracked=untracked)
    return _RUNS


def test_phold_heartbeat_lines_match_jax():
    r = _phold_runs()
    want, got = _lines(r["jlog"], "tracker: "), _lines(r["log"], "tracker: ")
    assert len(want) >= 3 * 6  # three heartbeats of six hosts
    assert got == want


def test_phold_stats_fold_matches_jax():
    r = _phold_runs()
    got = _fold(r["tr"])
    assert got == _fold(r["jtr"])
    assert sum(got["events_by_kind"].values()) == int(r["final"].events_handled.sum())
    assert r["tr"].stats_dict()["phases"]["probe_fetch"]["count"] >= 3


def test_tracker_leaves_trajectory_unchanged():
    """The tracker reads the state and writes nothing into it."""
    r = _phold_runs()
    want, got = state_to_numpy(r["untracked"]), state_to_numpy(r["final"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k] == want[k]).all(), k


def test_chrome_trace_well_nested_with_reference_span_names(tmp_path):
    r = _phold_runs()
    path = r["tr"].write_trace(str(tmp_path / "trace.json"))
    doc = json.loads(pathlib.Path(path).read_text())
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    names = {e["name"] for e in spans}
    assert names == {e["name"] for e in r["jtr"].spans()} == SPAN_NAMES
    # two spans of one thread are disjoint or one holds the other
    by_tid = {}
    for e in spans:
        by_tid.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"]))
    for ivs in by_tid.values():
        ivs.sort()
        for i, (a0, a1) in enumerate(ivs):
            for b0, b1 in ivs[i + 1:]:
                assert b0 >= a1 or b1 <= a1, ((a0, a1), (b0, b1))
    # one probe read per chunk, each after its chunk's launch
    launches = [e for e in spans if e["name"] in ("compile+launch", "chunk_launch")]
    assert len(launches) == len(r["tr"].spans("probe_fetch"))


def _cli(main, log, argv):
    rc, text = _captured(log, lambda: main(argv))
    return rc, text


def _stats(path) -> dict:
    s = json.loads(pathlib.Path(path).read_text())
    s["tracker"].pop("phases")
    return s


def test_tgen_example_heartbeats_and_stats_match_shadow_tpu_run(tmp_path):
    """examples/tgen cut to 300 ms with a heartbeat every 100 ms and 8
    rounds a chunk (a heartbeat falls due inside the run, where the
    reference renders it from the chunk after the probe that made it
    due), through both CLIs with --tracker: the same per-host tracker
    lines and manager heartbeat lines (which gain the drop reasons), and
    the same `tracker` section."""
    paths = {}
    for name in ("ref", "port"):
        path = _tgen_example(tmp_path, name)
        # one device, as the port runs (the JAX CLI would shard the hosts
        # over this process's host devices, which the occupancy field of
        # its lines divides by)
        src = path.read_text().replace(
            "general:\n", 'general:\n  heartbeat_interval: "100 ms"\n  parallelism: 1\n', 1)
        path.write_text(src.replace("rounds_per_chunk: 128", "rounds_per_chunk: 8"))
        paths[name] = path
    rc, jlog = _cli(j_main, j_log, ["run", "--tracker", str(paths["ref"])])
    assert rc == 0
    rc, log = _cli(t_main, t_log, ["run", "--device", "cpu", "--tracker", str(paths["port"])])
    assert rc == 0
    want = _lines(jlog, "tracker: ")
    # two heartbeats of 16 hosts: the probe past 100 ms is at 214 ms (no
    # event falls between), then the run's end
    assert len(want) == 2 * 16
    assert _lines(log, "tracker: ") == want
    want = _lines(jlog, "heartbeat: ")
    assert want and all(", drops loss=" in ln for ln in want)
    assert _lines(log, "heartbeat: ") == want
    w, g = (_stats(tmp_path / n / "sim-stats.json") for n in ("ref", "port"))
    assert g["tracker"] == w["tracker"]
    assert sum(g["tracker"]["events_by_kind"].values()) == g["events_handled"]


_REPLICAS = {}


def _replicas_runs(tmp_path_factory):
    """`run --replicas 2 --tracker --metrics-file --metrics-prom` on
    tests/test_torch_recovery_cli.py's phold config through both CLIs,
    once: {"ref"/"port": (sim-stats, log text, metrics JSONL, prom)}."""
    if not _REPLICAS:
        tmp = tmp_path_factory.mktemp("replicas")
        for name, main, log, extra in (("ref", j_main, j_log, ()),
                                       ("port", t_main, t_log, ("--device", "cpu"))):
            path = tmp / f"{name}.yaml"
            path.write_text(PHOLD_CONFIG.format(data_dir=tmp / name, capacities="", seed=1))
            m = tmp / f"{name}.jsonl"
            rc, text = _cli(main, log, ["run", *extra, "--tracker", "--replicas", "2",
                                        "--metrics-file", str(m), "--metrics-prom",
                                        str(tmp / f"{name}.prom"), str(path)])
            assert rc == 0
            _REPLICAS[name] = (_stats(tmp / name / "sim-stats.json"), text, m.read_text(),
                               (tmp / f"{name}.prom").read_text())
    return _REPLICAS


def test_replicas_tracker_fold_matches_shadow_tpu_run(tmp_path_factory):
    """`run --replicas 2 --tracker`: the ensemble's [R, H] counters fold
    through flatten_host_stats into the reference's section (summed
    window widths over the summed live rounds), with no per-host lines."""
    runs = _replicas_runs(tmp_path_factory)
    (w, jtext, _, _), (g, text, _, _) = runs["ref"], runs["port"]
    assert not _lines(jtext, "tracker: ") and not _lines(text, "tracker: ")
    assert g["tracker"] == w["tracker"]
    assert g["tracker"]["window"]["iters"] > 0
    assert g["tracker"]["events_by_kind"]["local"] + g["tracker"]["events_by_kind"][
        "packet"] == g["events_handled"]


def test_replicas_metrics_stream_matches_shadow_tpu_run(tmp_path_factory):
    """The same run's metrics stream (a sample a chunk of the aggregate
    probe, equal but for the wall-clock field `wall_s`) and prom file."""
    runs = _replicas_runs(tmp_path_factory)
    want, got = (
        [json.loads(ln) for ln in runs[n][2].splitlines() if ln.strip()] for n in ("ref", "port"))
    samples = [s for s in got if s["type"] == "sample"]
    assert len(samples) > 10
    assert [s["chunk"] for s in samples] == list(range(len(samples)))
    for doc in (want, got):
        for s in doc:
            s.pop("wall_s", None)
    assert got == want
    assert "shadow_tpu_events_total" in runs["port"][3]
    assert runs["port"][3] == runs["ref"][3]
