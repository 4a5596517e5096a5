"""The execution planes through the front door: examples/phold/shadow.yaml
(stop time cut as chip_smoke.py cuts it) with experimental.active_lanes
and experimental.use_dynamic_runahead set, through both packages' `run`
entry points: the same sim-stats.json minus the wall-clock and
execution-shape fields (tests/test_torch_slice.py::_stats); and the
port's config check no longer refuses either key."""

import json
import pathlib

import pytest
import torch

from test_torch_models import chip_smoke
from test_torch_slice import _stats

from shadow_tpu_torch.config.options import load_config_str
from shadow_tpu_torch.runtime.manager import _reject_unported

REPO = pathlib.Path(__file__).resolve().parent.parent
PLANES = "  active_lanes: 16\n  use_dynamic_runahead: true\n"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes_example(tmp_path=None, name="") -> str:
    stop, short = chip_smoke.PHOLD_EXAMPLE_STOP
    src = (REPO / "examples" / "phold" / "shadow.yaml").read_text()
    assert stop in src and "  rounds_per_chunk: 256\n" in src
    src = src.replace(stop, short)
    src = src.replace("  rounds_per_chunk: 256\n", "  rounds_per_chunk: 256\n" + PLANES)
    if tmp_path is not None:
        src = src.replace("data_directory: shadow.data",
                          f"data_directory: {tmp_path / name}")
    return src


def test_port_config_accepts_compaction_and_dynamic_runahead():
    config = load_config_str(_planes_example())
    assert config.experimental.active_lanes == 16
    assert config.experimental.use_dynamic_runahead
    _reject_unported(config)


def test_port_cli_planes_sim_stats_match_shadow_tpu_run(tmp_path):
    from shadow_tpu.cli import main as j_main
    from shadow_tpu_torch.cli import main as t_main

    for name in ("ref", "port"):
        (tmp_path / f"{name}.yaml").write_text(_planes_example(tmp_path, name))
    assert j_main(["run", str(tmp_path / "ref.yaml")]) == 0
    assert t_main(["run", "--device", "cpu", str(tmp_path / "port.yaml")]) == 0
    want = _stats(tmp_path / "ref" / "sim-stats.json")
    got = _stats(tmp_path / "port" / "sim-stats.json")
    assert want["events_handled"] > 0 and want["packets_sent"] > 0
    assert got == want
    # every path of 1_gbit_switch has the graph's minimum latency, so the
    # window dynamic runahead sets is the configured one: the events are
    # those of the example without the planes
    assert want["events_handled"] == chip_smoke.PHOLD_EXAMPLE_STATS["events_handled"]
    execution = json.loads((tmp_path / "port" / "sim-stats.json").read_text())["execution"]
    assert execution["device"] == "cpu"
