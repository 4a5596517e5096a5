"""The compile-budget autotuner (shadow_tpu_torch/runtime/autotune.py) held
against the JAX package's: the candidate ladder, the probe-cache key (the
seed canonicalized out, one string in both packages, so one cache file
answers for both), plans made from the same cache file field for field,
plan_pump_k's four cases, the lazy state thunk never built when the plan
needs no probe, and the `run` entry point with `--autotune` on
tests/test_torch_recovery_cli.py's phold config: from a cached probe the
port's sim-stats equal the reference's, the `autotune` section included,
and equal an untuned run's but for that section; a real probe writes the
cache under the reference's key. Exact equality throughout."""

import dataclasses
import json

import pytest
import torch

from test_torch_slice import _stats

from shadow_tpu.engine import EngineConfig as JEngineConfig
from shadow_tpu.runtime import autotune as jautotune
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.runtime import autotune


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    base = dict(num_hosts=8, runahead_ns=1_000_000)
    base.update(kw)
    return JEngineConfig(**base), EngineConfig(**base)


def _seed_cache(path, key, probe_wall_s):
    path.write_text(json.dumps({key: {"probe_wall_s": probe_wall_s}}))
    return str(path)


@pytest.mark.parametrize("requested,floor", [(256, 16), (100, 16), (32, 16), (16, 16),
                                             (64, 8), (128, 32)])
def test_candidate_ladder_matches_the_reference(requested, floor):
    assert autotune.candidate_ladder(requested, floor) == jautotune.candidate_ladder(
        requested, floor)


@pytest.mark.parametrize("kw,shape_key", [
    ({}, ""), ({"seed": 2}, ""), ({"seed": 99, "exchange": "dense"}, ""),
    ({"engine": "pump", "pump_k": 8, "tracker": True}, "r2"),
    ({"queue_capacity": 128, "active_lanes": 4}, "r3"),
])
def test_cache_key_is_the_reference_string(kw, shape_key):
    """One key string in both packages, for the same config, rpc, backend
    and shape; the seed and the "dense" alias are canonicalized out."""
    jcfg, cfg = _cfgs(**kw)
    got = autotune._cache_key(cfg, 4, "cpu", shape_key)
    assert got == jautotune._cache_key(jcfg, 4, "cpu", shape_key)
    assert got == autotune._cache_key(dataclasses.replace(cfg, seed=1, exchange="all_to_all")
                                      if cfg.exchange == "dense" else
                                      dataclasses.replace(cfg, seed=1), 4, "cpu", shape_key)
    assert got != autotune._cache_key(cfg, 4, "gpu", shape_key)


@pytest.mark.parametrize("probe_wall_s,requested,budget_s,n_compiles", [
    (10.0, 128, 60.0, 1.0), (0.1, 128, 60.0, 1.0), (1.0, 128, 40.0, 6.0),
    (10.0, 64, 60.0, 1.0), (2.5, 100, 30.0, 1.5),
])
def test_plans_from_one_cache_file_match_field_for_field(tmp_path, probe_wall_s, requested,
                                                         budget_s, n_compiles):
    """The port reads a cache file that either package wrote and plans
    exactly as the reference does from it: `source` "cache", backend
    "cpu", the same walk and projection."""
    jcfg, cfg = _cfgs(seed=5)
    cache = _seed_cache(tmp_path / "autotune.json", jautotune._cache_key(jcfg, 4, "cpu"),
                        probe_wall_s)
    kw = dict(requested=requested, budget_s=budget_s, n_compiles=n_compiles, cache_path=cache)
    want = jautotune.plan_rounds_per_chunk(None, None, None, jcfg, **kw)
    got = autotune.plan_rounds_per_chunk(None, None, None, cfg, device="cpu", **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.source == "cache" and got.backend == "cpu"


@pytest.mark.parametrize("requested,budget_s,source", [(128, 0.0, "disabled"),
                                                       (16, 100.0, "floor")])
def test_early_exits_match_and_never_build_the_state(requested, budget_s, source):
    """A zero budget and a request at the floor answer before any probe:
    the lazy state thunk is never called."""
    jcfg, cfg = _cfgs()

    def boom():
        raise AssertionError("probe state built without a probe")

    want = jautotune.plan_rounds_per_chunk(boom, None, None, jcfg, requested=requested,
                                           budget_s=budget_s)
    got = autotune.plan_rounds_per_chunk(boom, None, None, cfg, requested=requested,
                                         budget_s=budget_s, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.source == source


def test_lazy_state_thunk_not_built_on_a_cache_hit(tmp_path):
    _, cfg = _cfgs()

    def boom():
        raise AssertionError("probe state built despite a warm cache")

    cache = _seed_cache(tmp_path / "autotune.json", autotune._cache_key(cfg, 4, "cpu"), 10.0)
    plan = autotune.plan_rounds_per_chunk(boom, None, None, cfg, requested=128, budget_s=60.0,
                                          cache_path=cache, device="cpu")
    assert plan.source == "cache" and plan.rounds_per_chunk == 16


def _plan(mod, **kw):
    base = dict(rounds_per_chunk=32, requested=32, budget_s=100.0, n_compiles=1.0,
                probe_rpc=4, probe_wall_s=1.0, projected_compile_s=8.0, pump_k=None,
                source="cache", backend="cpu")
    base.update(kw)
    return mod.AutotunePlan(**base)


@pytest.mark.parametrize("plan_kw,cfg_kw,want_k", [
    ({"budget_s": 10_000.0}, {"engine": "pump", "pump_k": 8}, None),
    ({"probe_wall_s": 10.0, "budget_s": 20.0}, {"engine": "pump", "pump_k": 16}, 4),
    ({"probe_wall_s": 0.5, "budget_s": 20.0}, {"engine": "pump", "pump_k": 8}, 4),
    ({"probe_wall_s": None}, {"engine": "pump", "pump_k": 8}, None),
    ({}, {"engine": "plain"}, None),
], ids=["keeps-callers", "caps-tight", "not-diluted", "no-probe", "plain"])
def test_plan_pump_k_matches_the_reference(plan_kw, cfg_kw, want_k):
    jcfg, cfg = _cfgs(**cfg_kw)
    want = jautotune.plan_pump_k(_plan(jautotune, **plan_kw), jcfg)
    got = autotune.plan_pump_k(_plan(autotune, **plan_kw), cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.pump_k == want_k


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
  rounds_per_chunk: 64
hosts:
  peer:
    network_node_id: 0
    quantity: 12
    processes:
      - path: phold
        args:
          min_delay: "2 ms"
          max_delay: "12 ms"
"""
# a cached probe wall that walks 64 down to 16 under a 60 s budget
# (64 -> 160 s, 32 -> 80 s, 16 -> 40 s projected)
CACHED_WALL_S, BUDGET = 10.0, "60"


def _config(tmp_path, name, seed=1):
    path = tmp_path / f"{name}.yaml"
    path.write_text(CONFIG.format(data_dir=tmp_path / name, seed=seed))
    return path


def _key(path) -> str:
    """The probe-cache key both packages compute for a config (their own
    Manager builds the engine config)."""
    from shadow_tpu.config import load_config_file as j_load
    from shadow_tpu.runtime.manager import Manager as JManager
    from shadow_tpu_torch.config import load_config_file
    from shadow_tpu_torch.runtime.manager import Manager

    want = jautotune._cache_key(JManager(j_load(str(path))).build_world().ecfg, 4, "cpu")
    got = autotune._cache_key(Manager(load_config_file(str(path)), device="cpu")
                              .build_world().ecfg, 4, "cpu")
    assert got == want
    return got


def test_cli_autotune_from_a_cached_probe_matches_shadow_tpu_run(tmp_path):
    """`run --autotune 60` with autotune.json in each data directory: both
    packages walk rounds_per_chunk 64 -> 16 from the cache, their
    sim-stats are equal, `autotune` section included, and equal the
    port's untuned run but for that section."""
    from shadow_tpu.cli import main as j_main
    from shadow_tpu_torch.cli import main as t_main

    for main, name in ((j_main, "ref"), (t_main, "port")):
        cfg = _config(tmp_path, name)
        (tmp_path / name).mkdir()
        _seed_cache(tmp_path / name / "autotune.json", _key(cfg), CACHED_WALL_S)
        extra = ["--device", "cpu"] if main is t_main else []
        assert main(["run", *extra, "--autotune", BUDGET, str(cfg)]) == 0
    assert t_main(["run", "--device", "cpu", str(_config(tmp_path, "untuned"))]) == 0
    want, got = (_stats(tmp_path / n / "sim-stats.json") for n in ("ref", "port"))
    assert got == want
    assert got["autotune"] == {"rounds_per_chunk": 16, "requested": 64, "budget_s": 60.0,
                               "n_compiles": 1.0, "probe_rpc": 4, "probe_wall_s": 10.0,
                               "projected_compile_s": 40.0, "source": "cache",
                               "backend": "cpu"}
    untuned = _stats(tmp_path / "untuned" / "sim-stats.json")
    assert "autotune" not in untuned
    assert {k: v for k, v in got.items() if k != "autotune"} == untuned


def test_cli_autotune_real_probe_writes_the_reference_key(tmp_path):
    """A real probe (no cache): the plan's source is "probe", the cache
    file holds the probe's wall under the key the reference computes,
    `--no-autotune` wins over the flag, and the run equals the untuned
    one but for its `autotune` section."""
    from shadow_tpu_torch.cli import main as t_main

    cfg = _config(tmp_path, "probe")
    assert t_main(["run", "--device", "cpu", "--autotune", "600", str(cfg)]) == 0
    got = _stats(tmp_path / "probe" / "sim-stats.json")
    plan = got.pop("autotune")
    assert plan["source"] == "probe" and plan["backend"] == "cpu"
    assert plan["rounds_per_chunk"] in autotune.candidate_ladder(64)
    cache = json.loads((tmp_path / "probe" / "autotune.json").read_text())
    assert cache[_key(cfg)]["probe_wall_s"] == plan["probe_wall_s"]
    off = _config(tmp_path, "off")
    assert t_main(["run", "--device", "cpu", "--autotune", "600", "--no-autotune",
                   str(off)]) == 0
    assert got == _stats(tmp_path / "off" / "sim-stats.json")
