"""The port's `run --replicas N --replica-seed-stride K` entry point: on
tests/test_ensemble_cli.py's phold config (without `tracker: true`: the
host-side tracker plane is not ported yet) it writes the same
sim-stats.json as the JAX package's `shadow-tpu run` with the same
flags, minus the wall-clock and execution-shape fields
(tests/test_torch_slice.py::_stats) and the `ensemble` section's
wall-clock figures; it refuses what the reference refuses, with the
reference's messages. Exact equality."""

import json
import pathlib

import pytest
import torch

from test_torch_slice import _stats

CONFIG = """
general:
  stop_time: 120 ms
  seed: 1
  data_directory: {data_dir}
  heartbeat_interval: null
  parallelism: {parallelism}
network:
  graph:
    type: 1_gbit_switch
experimental:
  rounds_per_chunk: 4
  scheduler: {scheduler}
hosts:
  peer:
    network_node_id: 0
    quantity: 8
    processes:
      - path: phold
        args:
          min_delay: "2 ms"
          max_delay: "12 ms"
"""
# the ensemble section's wall-clock figures
_WALL = ("wall_seconds", "wall_seconds_per_replica", "sim_sec_per_wall_sec_per_replica")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(tmp_path, name, parallelism=1, scheduler="tpu") -> pathlib.Path:
    path = tmp_path / f"{name}.yaml"
    path.write_text(CONFIG.format(data_dir=tmp_path / name, parallelism=parallelism,
                                  scheduler=scheduler))
    return path


def _ensemble_stats(path) -> dict:
    s = _stats(path)
    for k in _WALL:
        s["ensemble"].pop(k)
    s["ensemble"]["aggregate"].pop("events_per_wall_second")
    return s


def test_cli_replicas_sim_stats_match_shadow_tpu_run(tmp_path):
    from shadow_tpu.cli import main as j_main
    from shadow_tpu_torch.cli import main as t_main

    flags = ["--replicas", "2", "--replica-seed-stride", "3"]
    assert j_main(["run", *flags, str(_config(tmp_path, "ref"))]) == 0
    assert t_main(["run", "--device", "cpu", *flags, str(_config(tmp_path, "port"))]) == 0
    want = _ensemble_stats(tmp_path / "ref" / "sim-stats.json")
    got = _ensemble_stats(tmp_path / "port" / "sim-stats.json")
    assert got["scheduler"] == "tpu-ensemble"
    per = got["ensemble"]["per_replica"]
    assert [p["seed"] for p in per] == [1, 4]
    assert got["events_handled"] == sum(p["events_handled"] for p in per)
    assert per[0]["events_handled"] != per[1]["events_handled"]
    assert got == want
    raw = json.loads((tmp_path / "port" / "sim-stats.json").read_text())
    assert raw["memory"]["replicas"] == 2 and raw["execution"]["device"] == "cpu"
    assert set(_WALL) <= set(raw["ensemble"])


@pytest.mark.parametrize("what", ["parallelism", "scheduler"])
def test_replicas_refusals_match_the_reference(tmp_path, what):
    """An ensemble with host sharding, or on a scheduler other than the
    device engine, is refused with the reference's message."""
    from shadow_tpu.runtime.cli_run import CliUserError as JCliUserError
    from shadow_tpu.runtime.cli_run import run_from_config as j_run
    from shadow_tpu_torch.runtime.cli_run import CliUserError, run_from_config

    kw = {"parallelism": 2} if what == "parallelism" else {"scheduler": "cpu-ref"}
    with pytest.raises(JCliUserError) as want:
        j_run(str(_config(tmp_path, "ref", **kw)), replicas=2)
    with pytest.raises(CliUserError) as got:
        run_from_config(str(_config(tmp_path, "port", **kw)), device="cpu", replicas=2)
    assert "general.replicas > 1" in str(want.value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flag", ["replicas", "replica_seed_stride"])
def test_bad_replica_flags_refused_like_the_reference(tmp_path, flag):
    from shadow_tpu.runtime.cli_run import CliUserError as JCliUserError
    from shadow_tpu.runtime.cli_run import run_from_config as j_run
    from shadow_tpu_torch.runtime.cli_run import CliUserError, run_from_config

    with pytest.raises(JCliUserError) as want:
        j_run(str(_config(tmp_path, "ref")), **{flag: 0})
    with pytest.raises(CliUserError) as got:
        run_from_config(str(_config(tmp_path, "port")), device="cpu", **{flag: 0})
    assert str(got.value) == str(want.value)
