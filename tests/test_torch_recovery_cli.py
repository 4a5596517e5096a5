"""The port's `run` entry point with capacity recovery and checkpoints, in
this process, against the JAX package's `shadow-tpu run` on
tests/test_checkpoint_cli.py's phold config (12 peers on the 1 Gbit
switch to 200 ms; without `tracker: true`, the host-side tracker plane
is not ported yet; one device, as the port runs: the JAX package would
shard over this process's host devices, and its capacity error would
name shards): at queue_capacity 4 and outbox_capacity 1 both
recover three times (outbox 1 -> 2 -> 4, then queue 4 -> 8) and write the
same sim-stats.json, its `recovery` section included (minus the
wall-clock and execution-shape fields, tests/test_torch_slice.py::_stats);
`--no-recover` fails with the reference's message; `--checkpoint-dir`,
an interrupt (the reference's deterministic test knob) and `--resume`
give the uninterrupted run's stats, and the JAX package resumes from the
port's checkpoints to the same; `--resume` without a directory and on an
empty one fail with the reference's messages."""

import pathlib

import pytest
import torch

from test_torch_slice import _stats

from shadow_tpu.cli import main as j_main
from shadow_tpu_torch.cli import main as t_main

CONFIG = """
general:
  stop_time: 200 ms
  seed: {seed}
  data_directory: {data_dir}
  heartbeat_interval: null
  parallelism: 1
network:
  graph:
    type: 1_gbit_switch
experimental:
  rounds_per_chunk: 4
{capacities}hosts:
  peer:
    network_node_id: 0
    quantity: 12
    processes:
      - path: phold
        args:
          min_delay: "2 ms"
          max_delay: "12 ms"
"""
SMALL = "  queue_capacity: 4\n  outbox_capacity: 1\n"
INTERRUPT_ENV = "SHADOW_TPU_TEST_INTERRUPT_AT_NS"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(tmp_path, name, capacities="", seed=1) -> pathlib.Path:
    path = tmp_path / f"{name}.yaml"
    path.write_text(CONFIG.format(data_dir=tmp_path / name, capacities=capacities, seed=seed))
    return path


def _run(main, cfg, *flags):
    extra = ("--device", "cpu") if main is t_main else ()
    return main(["run", *extra, *flags, str(cfg)])


def _error(capsys) -> str:
    """The error both CLIs print (its lines from "error:" on), without
    the program's name."""
    err = capsys.readouterr().err
    return err[err.rindex(": error: ") + len(": error: "):].strip()


def test_recovered_run_stats_match_shadow_tpu_run(tmp_path):
    assert _run(j_main, _config(tmp_path, "ref", SMALL)) == 0
    assert _run(t_main, _config(tmp_path, "port", SMALL)) == 0
    want, got = _stats(tmp_path / "ref" / "sim-stats.json"), _stats(
        tmp_path / "port" / "sim-stats.json")
    assert [(e["queue_capacity"], e["outbox_capacity"]) for e in want["recovery"]["events"]] == [
        (4, 2), (4, 4), (8, 4)]
    assert got == want


def test_no_recover_fails_like_shadow_tpu_run(tmp_path, capsys):
    assert _run(j_main, _config(tmp_path, "ref", SMALL), "--no-recover") == 1
    want = _error(capsys)
    assert _run(t_main, _config(tmp_path, "port", SMALL), "--no-recover") == 1
    assert _error(capsys) == want
    assert want.startswith("event capacity exhausted")


def test_checkpoint_interrupt_resume_identical_stats(tmp_path, monkeypatch):
    assert _run(j_main, _config(tmp_path, "ref")) == 0
    ref = _stats(tmp_path / "ref" / "sim-stats.json")
    assert ref["events_handled"] > 0
    run_cfg, ckpt = _config(tmp_path, "run"), str(tmp_path / "ckpts")
    monkeypatch.setenv(INTERRUPT_ENV, str(100_000_000))
    assert _run(t_main, run_cfg, "--checkpoint-dir", ckpt, "--checkpoint-interval", "40 ms") == 130
    assert sorted(pathlib.Path(ckpt).glob("ckpt-*.npz"))
    assert not (tmp_path / "run" / "sim-stats.json").exists()
    monkeypatch.delenv(INTERRUPT_ENV)
    assert _run(t_main, run_cfg, "--checkpoint-dir", ckpt, "--resume") == 0
    assert _stats(tmp_path / "run" / "sim-stats.json") == ref
    # the JAX package resumes from the port's checkpoints to the same
    jax_cfg = _config(tmp_path, "jax")
    assert _run(j_main, jax_cfg, "--checkpoint-dir", ckpt, "--resume") == 0
    assert _stats(tmp_path / "jax" / "sim-stats.json") == ref


def test_resume_refusals_like_shadow_tpu_run(tmp_path, capsys):
    cfg = _config(tmp_path, "cfg")
    for flags in (("--resume",), ("--resume", "--checkpoint-dir", str(tmp_path / "none"))):
        assert _run(j_main, cfg, *flags) == 1
        want = _error(capsys)
        assert _run(t_main, cfg, *flags) == 1
        assert _error(capsys) == want
    assert "no checkpoint found" in want
