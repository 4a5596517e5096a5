"""The port's `run` entry point on the phold and onion examples (stop
times shortened) writes the same sim-stats.json as the JAX package's
`shadow-tpu run` on the same configs, minus the wall-clock and
execution-shape fields (tests/test_torch_slice.py::_stats)."""

import json
import pathlib

import pytest
import torch

from test_torch_models import chip_smoke
from test_torch_slice import _stats

REPO = pathlib.Path(__file__).resolve().parent.parent
# the examples, cut as chip_smoke.py cuts them
EXAMPLES = {
    "phold": ("phold/shadow.yaml", *chip_smoke.PHOLD_EXAMPLE_STOP),
    "onion": ("onion/onion.yaml", *chip_smoke.ONION_EXAMPLE_STOP),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(tmp_path, example, name) -> pathlib.Path:
    rel, stop, short = EXAMPLES[example]
    src = (REPO / "examples" / rel).read_text()
    assert stop in src
    src = src.replace(stop, short)
    src = src.replace("data_directory: shadow.data", f"data_directory: {tmp_path / name}")
    path = tmp_path / f"{name}.yaml"
    path.write_text(src)
    return path


@pytest.mark.parametrize("example", sorted(EXAMPLES))
def test_cli_sim_stats_match_shadow_tpu_run(tmp_path, example):
    from shadow_tpu.cli import main as j_main
    from shadow_tpu_torch.cli import main as t_main

    assert j_main(["run", str(_example(tmp_path, example, "ref"))]) == 0
    assert t_main(["run", "--device", "cpu", str(_example(tmp_path, example, "port"))]) == 0
    want = _stats(tmp_path / "ref" / "sim-stats.json")
    got = _stats(tmp_path / "port" / "sim-stats.json")
    assert want["events_handled"] > 0 and want["packets_sent"] > 0
    assert got == want
    execution = json.loads((tmp_path / "port" / "sim-stats.json").read_text())["execution"]
    assert execution["device"] == "cpu"
