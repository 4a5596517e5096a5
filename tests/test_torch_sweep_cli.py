"""`python -m shadow_tpu_torch sweep --device cpu SPEC` against the JAX
package's `shadow-tpu sweep SPEC` and its standalone `run` of each seed,
on tests/test_sweep_cli.py's specs (8 phold peers): the 8-seed spec, the
preempt/resume spec and the plan-only spec, a preemption storm from the
chaos plane's `preempt` kind, and the reference's refusals. Each job's
sim-stats.json equals the JAX sweep's job file and the standalone run of
its seed, modulo tests/test_sweep_cli.py::_stats's fields and the port's
`execution` section; the manifest's per-job and per-batch records, its
telemetry and its compile counts equal the JAX sweep's, apart from
wall-clock fields and the output paths. Exact equality."""

import functools
import json
import pathlib

import pytest
import torch

from test_torch_slice import _stats

BASE = """
general:
  stop_time: {stop}
  heartbeat_interval: null
  tracker: true
network:
  graph:
    type: 1_gbit_switch
experimental:
  rounds_per_chunk: 4
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

PREEMPT_JOBS = """
  jobs:
    - name: lo
      seeds: [0, 1]
      priority: 0
    - name: hi
      seeds: [7]
      priority: 10
      arrival: 40 ms
"""
EIGHT_JOBS = """
  capacity: 8
  jobs:
    - name: ph
      seed_range: [0, 8]
"""
STORM_JOBS = """
  jobs:
    - name: lo
      seeds: [0, 1]
"""
STORM_CHAOS = """
chaos:
  seed: 3
  faults:
    - kind: preempt
      at: 1
    - kind: preempt
      at: 2
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("sweep_cli")


def _spec(root: pathlib.Path, name: str, stop: str, jobs: str, chaos: str = "") -> dict:
    """The spec `name` for each package: {"ref"/"port": spec path}, each
    with its own output directory beside a shared base."""
    d = root / name
    d.mkdir(exist_ok=True)
    (d / "base.yaml").write_text(BASE.format(stop=stop) + chaos)
    out = {}
    for pkg in ("ref", "port"):
        p = d / f"{pkg}.yaml"
        p.write_text(f"sweep:\n  name: {name}\n  base: base.yaml\n"
                     f"  output_dir: {d / ('out-' + pkg)}\n{jobs}")
        out[pkg] = p
    return out


def _sweep(pkg: str, spec: pathlib.Path) -> int:
    if pkg == "ref":
        from shadow_tpu.cli import main

        return main(["sweep", str(spec)])
    from shadow_tpu_torch.cli import main

    return main(["sweep", "--device", "cpu", str(spec)])


@functools.lru_cache(maxsize=None)
def _ran(root: str, name: str, stop: str, jobs: str, chaos: str = "") -> dict:
    """Both packages' sweeps of one spec, run once per module: {pkg:
    (exit code, manifest, output directory)}."""
    specs = _spec(pathlib.Path(root), name, stop, jobs, chaos)
    got = {}
    for pkg, spec in specs.items():
        rc = _sweep(pkg, spec)
        out = spec.parent / f"out-{pkg}"
        got[pkg] = (rc, json.loads((out / "sweep-manifest.json").read_text()), out)
    return got


@functools.lru_cache(maxsize=None)
def _standalone(root: str, seed: int, stop: str) -> dict:
    """The JAX package's `run` of one seed of the base world."""
    from shadow_tpu.runtime.cli_run import run_from_config

    d = pathlib.Path(root) / f"alone-{stop.replace(' ', '')}-s{seed}"
    cfg = d.with_suffix(".yaml")
    cfg.write_text(BASE.format(stop=stop).replace(
        "general:", f"general:\n  seed: {seed}\n  data_directory: {d}"))
    assert run_from_config(str(cfg)) == 0
    return _stats(d / "sim-stats.json")


def _manifest_facts(m: dict) -> dict:
    """A manifest without its wall-clock fields and output paths, and
    with the compile cache's counts only (their walls and the XLA
    memory figures are the reference's compile's own)."""
    m = json.loads(json.dumps(m))
    for k in ("wall_seconds", "output_dir"):
        m.pop(k)
    m["compile_cache"] = {k: m["compile_cache"][k] for k in ("compiles", "hits", "hit_rate")}
    for b in m["batches"]:
        b.pop("wall_seconds")
    for j in m["jobs"]:
        j.pop("wall_seconds", None)
        j.pop("data_directory", None)
    return m


def _assert_jobs_match(got: dict, names, standalone: dict):
    for name in names:
        port = _stats(got["port"][2] / "jobs" / name / "sim-stats.json")
        assert port == _stats(got["ref"][2] / "jobs" / name / "sim-stats.json"), name
        if name in standalone:
            assert port == standalone[name], name


def test_sweep_preempt_resume_matches_shadow_tpu(work):
    """tests/test_sweep_cli.py's preempt spec: the hi job's arrival at
    40 ms preempts the lo batch through a verified final checkpoint; the
    batch resumes from it (a cache hit) and every job, preempted or not,
    ends as its standalone run."""
    got = _ran(str(work), "preempt", "120 ms", PREEMPT_JOBS)
    assert got["port"][0] == got["ref"][0] == 0
    m = got["port"][1]
    assert _manifest_facts(m) == _manifest_facts(got["ref"][1])
    assert m["preemptions"] == 1 and m["jobs_done"] == 3
    assert (m["compile_cache"]["compiles"], m["compile_cache"]["hits"]) == (2, 1)
    assert "peak_hbm_bytes" not in m["compile_cache"]  # the CPU reports no peak
    assert list((got["port"][2] / "batches").glob("b*/ckpts/ckpt-*.npz"))
    _assert_jobs_match(got, ("lo-s0", "lo-s1", "hi-s7"), {
        "lo-s0": _standalone(str(work), 0, "120 ms"),
        "hi-s7": _standalone(str(work), 7, "120 ms")})
    ex = json.loads((got["port"][2] / "jobs" / "lo-s0" / "sim-stats.json").read_text())
    assert ex["execution"] == {"package": "shadow_tpu_torch", "device": "cpu", "engine": "plain",
                               "batch": 1, "kernel_launches": {"pump_megakernel": 0}}


def test_sweep_eight_seeds_one_build_matches_shadow_tpu(work):
    """8 same-shape jobs pack into one R = 8 batch and pay one build."""
    got = _ran(str(work), "eight", "60 ms", EIGHT_JOBS)
    assert got["port"][0] == got["ref"][0] == 0
    m = got["port"][1]
    assert _manifest_facts(m) == _manifest_facts(got["ref"][1])
    assert m["jobs_done"] == 8 and len(m["batches"]) == 1 and m["batches"][0]["replicas"] == 8
    assert m["compile_cache"]["compiles"] == 1
    _assert_jobs_match(got, [f"ph-s{s}" for s in range(8)], {
        "ph-s0": _standalone(str(work), 0, "60 ms"),
        "ph-s5": _standalone(str(work), 5, "60 ms")})
    for s in range(8):
        d = got["port"][2] / "jobs" / f"ph-s{s}"
        assert json.loads((d / "processed-config.json").read_text())["general"]["seed"] == s


def test_sweep_preempt_storm_matches_shadow_tpu(work):
    """The chaos plane's `preempt` kind arms the guard with no
    higher-priority arrival: two preemptions, two resumes, the manifest's
    `chaos` report and every job as the JAX sweep's."""
    got = _ran(str(work), "storm", "120 ms", STORM_JOBS, STORM_CHAOS)
    assert got["port"][0] == got["ref"][0] == 0
    m = got["port"][1]
    assert _manifest_facts(m) == _manifest_facts(got["ref"][1])
    assert m["preemptions"] == 2 and [f["kind"] for f in m["chaos"]["fired"]] == ["preempt"] * 2
    _assert_jobs_match(got, ("lo-s0", "lo-s1"), {"lo-s0": _standalone(str(work), 0, "120 ms")})


def test_sweep_show_plan_matches_shadow_tpu(work, capsys):
    jobs = "\n  capacity: 3\n  jobs:\n    - name: ph\n      seeds: [0, 1, 2, 3, 5, 7]\n"
    specs = _spec(work, "plan", "120 ms", jobs)
    plans = {}
    for pkg, spec in specs.items():
        capsys.readouterr()
        if pkg == "ref":
            from shadow_tpu.runtime.cli_run import run_sweep

            assert run_sweep(str(spec), show_plan=True) == 0
        else:
            from shadow_tpu_torch.runtime.cli_run import run_sweep

            assert run_sweep(str(spec), show_plan=True, device="cpu") == 0
        plans[pkg] = json.loads(capsys.readouterr().out)
        assert not (spec.parent / f"out-{pkg}").exists()
    assert plans["port"] == plans["ref"]
    got = [(b["base_seed"], b["replicas"], b["seed_stride"]) for b in plans["port"]["batches"]]
    assert got == [(0, 3, 1), (3, 3, 2)]


MANAGED_BASE = """
general: {stop_time: 1 s}
hosts:
  h:
    network_node_id: 0
    processes:
      - path: /bin/true
"""
_BAD = {
    "jobs": "sweep:\n  base: base.yaml\n",
    "invalid sweep spec": "sweep:\n  base: missing.yaml\n  jobs:\n    - name: a\n      seeds: [0]\n",
    "replicas": ("sweep:\n  base: base.yaml\n  jobs:\n    - name: a\n      seeds: [0]\n"
                 "      overrides:\n        general: {replicas: 4}\n"),
    "scripted-model": "sweep:\n  base: managed.yaml\n  jobs:\n    - name: a\n      seeds: [0]\n",
}


@pytest.mark.parametrize("what", sorted(_BAD))
def test_sweep_refusals_match_shadow_tpu(work, what):
    from shadow_tpu.runtime.cli_run import CliUserError as JErr
    from shadow_tpu.runtime.cli_run import run_sweep as j_sweep
    from shadow_tpu_torch.runtime.cli_run import CliUserError as TErr
    from shadow_tpu_torch.runtime.cli_run import run_sweep as t_sweep

    d = work / "bad"
    d.mkdir(exist_ok=True)
    (d / "base.yaml").write_text(BASE.format(stop="120 ms"))
    (d / "managed.yaml").write_text(MANAGED_BASE)
    spec = d / f"{what.replace(' ', '-')}.yaml"
    spec.write_text(_BAD[what])
    with pytest.raises(JErr, match=what) as ref:
        j_sweep(str(spec))
    with pytest.raises(TErr, match=what) as port:
        t_sweep(str(spec), device="cpu")
    assert str(port.value).replace(str(d), "") == str(ref.value).replace(str(d), "")


def test_sweep_runs_on_the_card_unless_asked_for_the_cpu(work, capsys):
    from shadow_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")

    specs = _spec(work, "nocard", "120 ms", STORM_JOBS)
    assert main(["sweep", str(specs["port"])]) == 1
    assert "CUDA not available" in capsys.readouterr().err
    assert not (specs["port"].parent / "out-port").exists()
