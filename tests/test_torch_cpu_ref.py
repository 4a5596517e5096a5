"""The port's scalar conformance oracles (shadow_tpu_torch/cpu_ref/) held
against the JAX package's and against the port's device engine on the
CPU, on the reference tests' worlds: tests/test_cpu_ref_tgen.py's four
tgen worlds and tests/test_cpu_ref_bulk.py's three bulk-tcp worlds (the
two oracles' event traces equal, then every TCP field, every model
counter and every leftover queue entry of the port's engine run equal to
the oracle's), tests/test_engine_phold.py's phold worlds through
CpuRefPhold, and the `run` entry point with `scheduler: cpu-ref`
(examples/tgen, cut to 300 ms): the same sim-stats.json and hosts file as
the JAX package's, and the same counters as the port's device run.
Exact equality throughout."""

import dataclasses

import numpy as np
import pytest
import torch

from test_cpu_ref_bulk import TCP_FIELDS
from test_cpu_ref_bulk import _world as bulk_world
from test_cpu_ref_tgen import _world as tgen_world
from test_engine_phold import _setup as phold_setup
from test_torch_ensemble import port_world
from test_torch_slice import _stats, _tgen_example

from shadow_tpu.cpu_ref import CpuRefBulk as JCpuRefBulk
from shadow_tpu.cpu_ref import CpuRefPhold as JCpuRefPhold
from shadow_tpu.cpu_ref import CpuRefTgen as JCpuRefTgen
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.cpu_ref import CpuRefBulk, CpuRefPhold, CpuRefTgen
from shadow_tpu_torch.engine.round import bootstrap, run_until
from shadow_tpu_torch.engine.state import init_state
from shadow_tpu_torch.simtime import TIME_MAX


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sorted_events(q, host: int) -> list:
    """A host's live queue entries in pop order, as the oracles' and
    shadow_tpu.equeue.debug_sorted_events list them."""
    time, tie, kind, data = (x[host].tolist() for x in (q.time, q.tie, q.kind, q.data))
    items = sorted((time[i], tie[i], kind[i], tuple(data[i]))
                   for i in range(len(time)) if time[i] != TIME_MAX)
    assert len(items) == int(q.count[host])
    return items


_ORACLES = {}


def _oracles(key, jcls, cls, jcfg, jm, jt, host_node, bw, end):
    """The reference's oracle and the port's, each run to `end` on the same
    world; their event traces must be equal. `key` names the world: the
    oracles ignore active_lanes, so worlds that differ only there share
    one run."""
    cfg, model, tables = port_world(jcfg, jm, jt)
    if key in _ORACLES:
        return _ORACLES[key], cfg, model, tables
    want = jcls(jcfg, jm, jt, host_node, tx_bytes_per_interval=bw, rx_bytes_per_interval=bw)
    got = cls(cfg, model, tables, host_node, tx_bytes_per_interval=bw, rx_bytes_per_interval=bw)
    for ref in (want, got):
        ref.bootstrap()
        ref.run_until(end)
    assert len(got.trace) == len(want.trace) > 20
    assert got.trace == want.trace
    for h in range(cfg.num_hosts):
        assert got.queue_contents(h) == want.queue_contents(h), f"host {h}"
    _ORACLES[key] = got
    return got, cfg, model, tables


def _engine_run(cfg, model, tables, bw, end):
    st = bootstrap(init_state(cfg, model.init("cpu"), bw, bw, device="cpu"), model, cfg)
    return run_until(st, end, model, tables, cfg, rounds_per_chunk=16)


def _assert_tcp_world(st, ref, counters, shaped):
    """Every TCP field, the model's counters, the engine's counters and the
    leftover queue entries of a port engine run equal the oracle's."""
    for f in TCP_FIELDS:
        dev = getattr(st.model.tcp, f).numpy()
        np.testing.assert_array_equal(dev, ref.tcp_field(f).astype(dev.dtype), err_msg=f)
    for name in counters:
        np.testing.assert_array_equal(getattr(st.model, name).numpy(), getattr(ref, name),
                                      err_msg=name)
    np.testing.assert_array_equal(st.seq.numpy(), np.array(ref.seq, np.uint32))
    np.testing.assert_array_equal(st.rng_counter.numpy(), np.array(ref.ctr, np.uint32))
    for name in ("packets_sent", "packets_dropped", "events_handled"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), getattr(ref, name), err_msg=name)
    if shaped:
        for name in ("codel_dropped", "bytes_sent", "bytes_recv"):
            np.testing.assert_array_equal(getattr(st.net, name).numpy(), getattr(ref, name),
                                          err_msg=name)
    for h in range(st.num_hosts):
        assert sorted_events(st.queue, h) == ref.queue_contents(h), f"host {h}"


@pytest.mark.parametrize(
    "loss,shaped,end_ms,lanes",
    [(0.0, False, 250, 0), (0.05, False, 400, 0), (0.02, True, 400, 0), (0.02, True, 400, 3)],
    ids=["clean", "lossy", "lossy-shaped", "lossy-shaped-compact"],
)
def test_tgen_oracle_matches_the_reference_and_the_engine(loss, shaped, end_ms, lanes):
    jcfg, jm, jt, host_node, bw = tgen_world(8, loss, shaped, seed=13)
    if lanes:
        jcfg = dataclasses.replace(jcfg, active_lanes=lanes)
    end = end_ms * NS_PER_MS
    ref, cfg, model, tables = _oracles(
        ("tgen", loss, shaped, end_ms), JCpuRefTgen, CpuRefTgen, jcfg, jm, jt, host_node, bw, end)
    st = _engine_run(cfg, model, tables, bw, end)
    _assert_tcp_world(st, ref, ("streams_started", "streams_done", "bytes_down", "resets"),
                      shaped)
    assert sum(ref.streams_done) > 0
    assert sum(ref.bytes_down) >= sum(ref.streams_done) * jm.resp_bytes


@pytest.mark.parametrize(
    "loss,shaped,end_ms",
    [(0.0, False, 60), (0.05, False, 200), (0.02, True, 200)],
    ids=["clean", "lossy", "lossy-shaped"],
)
def test_bulk_oracle_matches_the_reference_and_the_engine(loss, shaped, end_ms):
    jcfg, jm, jt, host_node, bw = bulk_world(8, loss, shaped, seed=11)
    end = end_ms * NS_PER_MS
    ref, cfg, model, tables = _oracles(
        ("bulk", loss, shaped, end_ms), JCpuRefBulk, CpuRefBulk, jcfg, jm, jt, host_node, bw, end)
    st = _engine_run(cfg, model, tables, bw, end)
    _assert_tcp_world(st, ref, ("conns_established", "conns_closed", "resets"), shaped)
    assert int(st.model.tcp.delivered.sum()) > 0


@pytest.mark.parametrize("loss", [0.0, 0.2])
def test_phold_oracle_matches_the_reference_and_the_engine(loss):
    jcfg, jm, _, jt, host_node, _ = phold_setup(loss=loss)
    end = 60 * NS_PER_MS
    ref, cfg, model, tables = _oracles(("phold", loss), JCpuRefPhold, CpuRefPhold, jcfg, jm,
                                       jt, host_node, None, end)
    st = _engine_run(cfg, model, tables, None, end)
    assert st.model.recv_count.tolist() == ref.recv
    assert st.model.send_count.tolist() == ref.send
    for name in ("packets_sent", "packets_dropped", "seq"):
        assert getattr(st, name).tolist() == getattr(ref, name), name
    assert st.rng_counter.tolist() == ref.ctr
    for h in range(cfg.num_hosts):
        assert sorted_events(st.queue, h) == ref.queue_contents(h), f"host {h}"
    assert sum(ref.packets_dropped) > 0 or loss == 0


def test_oracle_draw_counter_and_tables():
    """A draw counter wraps at 2**32, as the reference's u32 counter does;
    the tables are read to numpy from a tensor or an array."""
    from shadow_tpu_torch.cpu_ref.sim import draw_counter, host_array

    assert draw_counter(2**32 + 5).tolist() == [5]
    assert host_array(torch.arange(3)).tolist() == [0, 1, 2]
    assert host_array([1, 2]).tolist() == [1, 2]


def test_cli_cpu_ref_scheduler_matches_shadow_tpu_run(tmp_path):
    """`run` of examples/tgen (cut to 300 ms) with `scheduler: cpu-ref`:
    the port's sim-stats.json and hosts file equal the JAX package's, and
    its counters equal the port's device run of the same config."""
    from shadow_tpu.cli import main as j_main
    from shadow_tpu_torch.cli import main as t_main

    for name in ("ref", "port", "tpu"):
        path = _tgen_example(tmp_path, name)
        if name != "tpu":
            path.write_text(path.read_text().replace("scheduler: tpu", "scheduler: cpu-ref"))
    assert j_main(["run", str(tmp_path / "ref.yaml")]) == 0
    assert t_main(["run", "--device", "cpu", str(tmp_path / "port.yaml")]) == 0
    assert t_main(["run", "--device", "cpu", str(tmp_path / "tpu.yaml")]) == 0
    want, got, dev = (_stats(tmp_path / n / "sim-stats.json") for n in ("ref", "port", "tpu"))
    assert got == want and got["scheduler"] == "cpu-ref"
    assert (tmp_path / "port" / "hosts").read_text() == (tmp_path / "ref" / "hosts").read_text()
    assert (tmp_path / "port" / "hosts").read_text() == (tmp_path / "tpu" / "hosts").read_text()
    same = ("events_handled", "packets_sent", "packets_dropped", "packets_unroutable",
            "sim_seconds", "num_hosts")
    assert {k: got[k] for k in same} == {k: dev[k] for k in same}


def test_cli_cpu_ref_refusals_and_autotune_warning(tmp_path, capsys):
    """cpu-ref takes no checkpoints (the reference's CheckpointError), and
    `--autotune` on it is ignored with the reference's warning."""
    from shadow_tpu.runtime.cli_run import CliUserError as JCliUserError
    from shadow_tpu.runtime.cli_run import run_from_config as j_run
    from shadow_tpu_torch.runtime.cli_run import CliUserError, run_from_config

    path = _tgen_example(tmp_path, "c")
    path.write_text(path.read_text().replace("scheduler: tpu", "scheduler: cpu-ref")
                    .replace('stop_time: "300 ms"', 'stop_time: "50 ms"'))
    with pytest.raises(JCliUserError) as want:
        j_run(str(path), checkpoint_dir=str(tmp_path / "ck"))
    with pytest.raises(CliUserError) as got:
        run_from_config(str(path), device="cpu", checkpoint_dir=str(tmp_path / "ck"))
    assert str(got.value) == str(want.value) and "tpu scheduler" in str(got.value)
    capsys.readouterr()
    assert run_from_config(str(path), device="cpu", autotune=30.0) == 0
    assert "experimental.autotune only applies to the tpu scheduler" in capsys.readouterr().err
    assert "autotune" not in _stats(tmp_path / "c" / "sim-stats.json")
