"""Managed worlds through the port's `run` (python -m shadow_tpu_torch
run --device cpu) against the JAX package's `shadow-tpu run`:
examples/http on the hybrid (`scheduler: tpu`, the device plane on the
CPU here) and on the serial kernel (`scheduler: managed`), and at
`parallelism: 2` under a worker-kill fault. The data directories (guest
stdout, strace files, hosts) are equal byte for byte, and sim-stats.json
is equal but for wall clock and the port's `execution` record. The
reference's refusals of managed worlds keep its texts."""

import json
import pathlib

import pytest

from test_torch_hostk import (
    _one_torch_thread,  # noqa: F401  (module fixture)
    data_files,
    port_guest_reason,
)

from shadow_tpu.runtime.cli_run import CliUserError as JCliUserError
from shadow_tpu.runtime.cli_run import run_from_config as j_run
from shadow_tpu_torch.config import load_config_file
from shadow_tpu_torch.runtime.cli_run import CliUserError, run_from_config
from shadow_tpu_torch.runtime.manager import Manager

REPO = pathlib.Path(__file__).resolve().parent.parent
HTTP = REPO / "examples" / "http"


@pytest.fixture(scope="module")
def http_bins(tmp_path_factory):
    """examples/http's guests, built as its shadow.yaml says. At teardown
    any guest still running one of them is killed: the reference's
    kernel leaves a killed worker's guests running."""
    import subprocess

    reason = port_guest_reason()
    if reason is not None:
        pytest.skip(reason)
    out = tmp_path_factory.mktemp("http")
    for name in ("http_server", "http_client"):
        subprocess.run(["cc", "-O2", "-o", str(out / name), str(HTTP / f"{name}.c")],
                       check=True)
    yield out
    _kill_guests_of(out)


def _kill_guests_of(bin_dir: pathlib.Path) -> None:
    import os
    import signal

    for proc in pathlib.Path("/proc").iterdir():
        if not proc.name.isdigit():
            continue
        try:
            argv0 = (proc / "cmdline").read_bytes().split(b"\0", 1)[0].decode()
        except OSError:
            continue
        if argv0.startswith(str(bin_dir)):
            try:
                os.kill(int(proc.name), signal.SIGKILL)
            except OSError:
                pass


def http_config(tmp_path, bins, name, general="", experimental="") -> pathlib.Path:
    src = (HTTP / "shadow.yaml").read_text()
    for guest in ("http_server", "http_client"):
        src = src.replace(f"examples/http/{guest}", str(bins / guest))
    src = src.replace("data_directory: shadow.data", f"data_directory: {tmp_path / name}")
    src = src.replace("general:\n", f"general:\n{general}", 1)
    if experimental:
        src += f"\nexperimental:\n{experimental}"
    path = tmp_path / f"{name}.yaml"
    path.write_text(src)
    return path


def _stats(d: pathlib.Path, drop=()) -> dict:
    s = json.loads((d / "sim-stats.json").read_text())
    for key in ("wall_seconds", "execution", *drop):
        s.pop(key, None)
    return s


def _files(d: pathlib.Path) -> dict:
    return {k: v for k, v in data_files(d).items()
            if k not in ("sim-stats.json", "processed-config.json")}


@pytest.mark.parametrize("scheduler", ["tpu", "managed"])
def test_http_example_matches_shadow_tpu_run(tmp_path, http_bins, scheduler):
    exp = f"  scheduler: {scheduler}\n"
    assert j_run(str(http_config(tmp_path, http_bins, "ref", experimental=exp))) == 0
    assert run_from_config(str(http_config(tmp_path, http_bins, "port", experimental=exp)),
                           device="cpu") == 0
    want, got = _stats(tmp_path / "ref"), _stats(tmp_path / "port")
    assert want["scheduler"] == {"tpu": "tpu-hybrid", "managed": "managed"}[scheduler]
    assert got == want
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    out = (tmp_path / "port" / "client1" / "http_client.1001.stdout").read_bytes()
    assert out.count(b"fetch ") == 3 and b"client done" in out
    execution = json.loads((tmp_path / "port" / "sim-stats.json").read_text())["execution"]
    if scheduler == "tpu":
        assert execution["device"] == "cpu" and execution["device_passes"] > 0
    else:
        assert "device" not in execution


def test_http_hybrid_equals_serial_kernel(tmp_path, http_bins):
    """The port's hybrid and its serial kernel: the same run but for the
    scheduler's name."""
    runs = {"hy": "", "se": "  scheduler: managed\n"}
    for name, exp in runs.items():
        assert run_from_config(str(http_config(tmp_path, http_bins, name, experimental=exp)),
                               device="cpu") == 0
    assert _stats(tmp_path / "hy", ("scheduler",)) == _stats(tmp_path / "se", ("scheduler",))
    assert _files(tmp_path / "hy") == _files(tmp_path / "se")


def test_http_parallel_worker_kill_matches_reference(tmp_path, http_bins):
    """parallelism: 2 and a worker-kill before window broadcast 2: the
    worker is respawned and the run equals the clean serial hybrid run;
    the chaos section equals the reference's."""
    par = "  parallelism: 2\n"
    kill = ["worker-kill@2"]
    assert j_run(str(http_config(tmp_path, http_bins, "ref", general=par)),
                 chaos_faults=kill) == 0
    metrics = tmp_path / "m.jsonl"
    assert run_from_config(str(http_config(tmp_path, http_bins, "port", general=par)),
                           device="cpu", chaos_faults=kill, metrics_file=str(metrics)) == 0
    assert run_from_config(str(http_config(tmp_path, http_bins, "clean")), device="cpu") == 0
    want, got = _stats(tmp_path / "ref"), _stats(tmp_path / "port")
    assert got == want
    assert got["scheduler"] == "tpu-hybrid-par"
    assert got["chaos"]["fired"] == [{"kind": "worker-kill", "at": 2}]
    clean = _stats(tmp_path / "clean", ("scheduler",))
    assert {k: v for k, v in got.items() if k not in ("scheduler", "chaos", "metrics")} == clean
    assert _files(tmp_path / "port") == _files(tmp_path / "clean")
    events = [json.loads(line) for line in metrics.read_text().splitlines()]
    respawns = [e for e in events if e["type"] == "event" and e["kind"] == "worker_respawn"]
    assert len(respawns) == 1 and respawns[0]["worker"] in (0, 1)
    execution = json.loads((tmp_path / "port" / "sim-stats.json").read_text())["execution"]
    assert execution["workers"] == 2
    assert set(execution["phase_wall"]) == {"worker_execute", "device_pass", "upload",
                                            "drain_records"}


def _refusal_config(tmp_path, name, case) -> pathlib.Path:
    exe = str(HTTP / "http_server")
    server = f"      - path: {exe}\n        args: 80 1\n"
    general, exp, other = "", "", server
    if case == "mixed":
        other = "      - path: phold\n        args: {}\n"
    elif case == "mapping-args":
        other = f"      - path: {exe}\n        args: {{port: 80}}\n"
    elif case == "missing-path":
        other = "      - path: /no/such/guest\n"
    elif case == "model-typo":
        other = "      - path: phlod\n"
    elif case == "checkpoint":
        general = f"  checkpoint_dir: {tmp_path / name}-ckpt\n"
    elif case == "rr-on-tpu":
        exp = "experimental:\n  interface_qdisc: rr\n"
    elif case == "replicas":
        general = "  replicas: 2\n"
    path = tmp_path / f"{name}.yaml"
    path.write_text(
        f"general:\n  stop_time: 1 s\n  data_directory: {tmp_path / name}\n{general}"
        "network:\n  graph:\n    type: 1_gbit_switch\n"
        f"hosts:\n  a:\n    network_node_id: 0\n    processes:\n{server}"
        f"  b:\n    network_node_id: 0\n    processes:\n{other}{exp}"
    )
    return path


@pytest.mark.parametrize("case", ["mixed", "mapping-args", "missing-path", "model-typo",
                                  "checkpoint", "rr-on-tpu", "replicas"])
def test_managed_refusals_match_the_reference(tmp_path, case):
    """The same text; the reference raises the qdisc refusal, found when
    the run starts, as a plain ValueError, and the port's `run` reports
    every ValueError as a user error."""
    with pytest.raises((JCliUserError, ValueError)) as want:
        j_run(str(_refusal_config(tmp_path, "ref", case)))
    with pytest.raises(CliUserError) as got:
        run_from_config(str(_refusal_config(tmp_path, "port", case)), device="cpu")
    assert str(got.value) == str(want.value).replace(str(tmp_path / "ref"),
                                                     str(tmp_path / "port"))


def test_examples_http_python_and_real_are_ported(monkeypatch):
    """The configs that named only managed processes are no longer
    refused; nor is a scripted world's parallelism > 1 (the multi-device
    plane: its hosts shard over the visible logical devices)."""
    monkeypatch.chdir(REPO)
    for name in ("http-python", "http-real"):
        m = Manager(load_config_file(str(REPO / "examples" / name / "shadow.yaml")),
                    device="cpu")
        assert m.managed_mode
    scripted = load_config_file(str(REPO / "examples" / "phold" / "shadow.yaml"))
    scripted.general.parallelism = 2
    assert not Manager(scripted, device="cpu").managed_mode
