"""The port's first slice as a whole: `run_until` on the tgen world of
tests/test_pump.py (shaped 20 Mbit hosts, loss 0 and 0.02) equals the
JAX package's run leaf for leaf with engine="megakernel" on both sides
(the JAX kernel in Pallas interpret mode, the port's as its CPU twin);
inside the port the plain and megakernel engines agree up to queue slot
placement and iteration counts; the port's `run` entry point writes the
same sim-stats.json as `shadow-tpu run` on the tgen example; and
`python -m shadow_tpu_torch run` without a card fails loudly. Exact
equality throughout."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pump import _world

from shadow_tpu.engine.round import run_until as j_run_until
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.engine.round import run_until
from shadow_tpu_torch.engine.state import EngineConfig, state_from_numpy, state_to_numpy
from shadow_tpu_torch.graph.routing import RoutingTables
from shadow_tpu_torch.models.tgen import TgenModel
from shadow_tpu_torch.simtime import TIME_MAX


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run next to other test processes (pytest-xdist): keep
    torch to one intra-op thread so they do not crowd the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = pathlib.Path(__file__).resolve().parent.parent
END_NS = 120 * NS_PER_MS
HOSTS = 16
# pump_k=2 keeps the JAX kernel's interpret-mode compile short; the port
# runs the same microstep count
PUMP_K = 2


def _jax_leaves(st) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(st):
        if jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            leaf = jax.random.key_data(leaf)
        out[jax.tree_util.keystr(path)] = np.asarray(leaf)
    return out


def _port_world(cfg, model, tables):
    tcfg = EngineConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    tmodel = TgenModel(
        num_hosts=model.num_hosts, num_clients=model.num_clients,
        num_servers=model.num_servers, req_bytes=model.req_bytes,
        resp_bytes=model.resp_bytes, pause_ns=model.pause_ns, port=model.port,
        start_ns=model.start_ns,
    )
    ttables = RoutingTables(
        **{f: torch.from_numpy(np.asarray(getattr(tables, f)).copy())
           for f in ("lat_ns", "rel", "host_node", "lookahead_ns")}
    )
    return tcfg, tmodel, ttables


def _normalized(leaves: dict) -> dict:
    """tests/test_pump.py::_normalize on a leaf dict: queue rows sorted by
    (time, tie) with dead-slot contents zeroed; iteration counters zeroed."""
    out = dict(leaves)
    time = leaves[".queue.time"]
    dead = time >= TIME_MAX
    tie = np.where(dead, np.iinfo(np.int64).max, leaves[".queue.tie"])
    order = np.lexsort((tie, time), axis=1)
    oi = np.arange(time.shape[0])[:, None]
    out[".queue.time"] = time[oi, order]
    out[".queue.tie"] = tie[oi, order]
    for f in ("kind", "aux"):
        out[f".queue.{f}"] = np.where(dead, 0, leaves[f".queue.{f}"])[oi, order]
    out[".queue.data"] = np.where(dead[:, :, None], 0, leaves[".queue.data"])[oi, order]
    out[".iters_done"] = leaves[".iters_done"] * 0
    out[".lanes_live"] = leaves[".lanes_live"] * 0
    return out


def _assert_leaves_equal(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


_PORT_RUNS = {}


def _port_run(loss, engine):
    if (loss, engine) not in _PORT_RUNS:
        cfg, model, tables, st0 = _world(HOSTS, loss, 20_000_000)
        cfg = dataclasses.replace(cfg, engine=engine, pump_k=PUMP_K, tracker=True)
        tcfg, tmodel, ttables = _port_world(cfg, model, tables)
        st = run_until(state_from_numpy(_jax_leaves(st0)), END_NS, tmodel, ttables, tcfg,
                       rounds_per_chunk=16)
        _PORT_RUNS[(loss, engine)] = state_to_numpy(st)
    return _PORT_RUNS[(loss, engine)]


@pytest.mark.parametrize("loss", [0.0, 0.02])
def test_run_until_matches_jax_megakernel(loss):
    cfg, model, tables, st0 = _world(HOSTS, loss, 20_000_000)
    cfg = dataclasses.replace(cfg, engine="megakernel", pump_k=PUMP_K, tracker=True)
    want = _jax_leaves(j_run_until(st0, END_NS, model, tables, cfg, rounds_per_chunk=16))
    got = _port_run(loss, "megakernel")
    assert want[".model.streams_done"].sum() > 0  # real traffic flowed
    if loss:
        assert want[".packets_dropped"].sum() > 0  # and the loss path fired
    _assert_leaves_equal(want, got)


@pytest.mark.parametrize("loss", [0.0, 0.02])
def test_plain_and_megakernel_engines_agree(loss):
    plain, mega = _port_run(loss, "plain"), _port_run(loss, "megakernel")
    assert mega[".iters_done"].sum() < plain[".iters_done"].sum()
    _assert_leaves_equal(_normalized(plain), _normalized(mega))


def _stats(path) -> dict:
    """sim-stats.json minus the fields tests/test_sweep_cli.py::_stats
    drops (wall clock and execution shape) and the port's `execution`
    record (engine, device, kernel launches: execution shape too)."""
    s = json.loads(pathlib.Path(path).read_text())
    s.pop("wall_seconds")
    s.pop("memory", None)
    s.pop("execution", None)
    if "tracker" in s:
        s["tracker"].pop("phases", None)
        for k in ("iters", "lanes_live", "occupancy"):
            s["tracker"].get("window", {}).pop(k, None)
    return s


def _tgen_example(tmp_path, name) -> pathlib.Path:
    src = (REPO / "examples" / "tgen" / "shadow.yaml").read_text()
    src = src.replace('stop_time: "4 s"', 'stop_time: "300 ms"')
    src = src.replace("data_directory: shadow.data", f"data_directory: {tmp_path / name}")
    path = tmp_path / f"{name}.yaml"
    path.write_text(src)
    return path


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(OMP_NUM_THREADS="1", **kw)
    return env


def test_cli_sim_stats_match_shadow_tpu_run(tmp_path):
    """Both packages' `run` entry points in this process (the `-m` entry
    of the port runs as a subprocess in the test below)."""
    from shadow_tpu.cli import main as j_main
    from shadow_tpu_torch.cli import main as t_main

    assert j_main(["run", str(_tgen_example(tmp_path, "ref"))]) == 0
    assert t_main(["run", "--device", "cpu", str(_tgen_example(tmp_path, "port"))]) == 0
    want = _stats(tmp_path / "ref" / "sim-stats.json")
    got = _stats(tmp_path / "port" / "sim-stats.json")
    assert want["events_handled"] > 0
    assert got == want
    execution = json.loads((tmp_path / "port" / "sim-stats.json").read_text())["execution"]
    assert execution["device"] == "cpu" and execution["engine"] == "plain"


def test_cli_without_device_needs_cuda(tmp_path):
    """The CLI runs on the card unless asked for the CPU: without a card
    it fails loudly instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    out = subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch", "run", str(_tgen_example(tmp_path, "nodev"))],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "CUDA not available" in out.stderr
    assert not (tmp_path / "nodev" / "sim-stats.json").exists()
