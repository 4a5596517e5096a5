"""The port's compile cache and the ensemble plane's compile-cache seam
on the CPU: a prepared chunk (engine/ensemble.py lower_ensemble_chunk)
runs a batch leaf-equal to the chunk run_ensemble_until prepares itself,
on 8 phold peers and on examples/tgen's 16-host world through the pump
twin; the persistent tier round-trips a prepared chunk, and a corrupt,
truncated, wrong-runtime, wrong-format or undeserializable entry (also
one the `cache-corrupt` fault damaged) is evicted and rebuilt with the
reference's warning; a regrown replay keys its own entry, as the JAX
package's sweep counts it; an injected compile fault in the seam falls a
rung. On a machine with a card, the prepared chunk against the closure
it replaces, through the kernel."""

import io
import json
import pathlib

import pytest
import torch

from test_torch_slice import _stats

from shadow_tpu_torch.config import load_config_str
from shadow_tpu_torch.engine.ensemble import (
    EnsembleChunk,
    init_ensemble_state,
    lower_ensemble_chunk,
    run_ensemble_until,
)
from shadow_tpu_torch.engine.state import state_to_numpy
from shadow_tpu_torch.runtime import chaos, memtrack
from shadow_tpu_torch.runtime.compile_cache import (
    CACHE_FORMAT,
    CompileCache,
    PersistentCompileCache,
    runtime_version,
)
from shadow_tpu_torch.runtime.ensemble import EnsembleRunner
from shadow_tpu_torch.runtime.manager import Manager
from shadow_tpu_torch.utils import shadow_log

REPO = pathlib.Path(__file__).resolve().parent.parent

PHOLD = """
general:
  stop_time: 120 ms
  seed: 5
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


def _tgen_yaml(engine="pump", pump_k=3, stop="300 ms") -> str:
    src = (REPO / "examples" / "tgen" / "shadow.yaml").read_text()
    src = src.replace('stop_time: "4 s"', f'stop_time: "{stop}"')
    src = src.replace("rounds_per_chunk: 128", "rounds_per_chunk: 8")
    return src.replace("scheduler: tpu", f"scheduler: tpu\n  engine: {engine}\n  pump_k: {pump_k}")


WORLDS = {"phold": (PHOLD, 2, 3), "tgen-pump": (_tgen_yaml(), 2, 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(name):
    text, replicas, stride = WORLDS[name]
    config = load_config_str(text)
    world = Manager(config, device="cpu").build_world()
    st = init_ensemble_state(world.ecfg, world.model, replicas, stride, world.tx_refill,
                             world.rx_refill, device="cpu")
    return config, world, st


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_prepared_chunk_runs_like_the_drivers_own(name):
    """run_ensemble_until with the prepared chunk in place of the one it
    builds itself: the same final batch, leaf for leaf."""
    config, world, st = _world(name)
    end, rpc = config.general.stop_time_ns, config.experimental.rounds_per_chunk
    chunk = lower_ensemble_chunk(st, end, rpc, world.model, world.tables, world.ecfg)
    assert isinstance(chunk, EnsembleChunk) and chunk.cfg.seed == 0
    assert chunk.engine == ("pump" if name == "tgen-pump" else "plain")
    assert chunk.instance is None and memtrack.compiled_memory(chunk) is None
    own = run_ensemble_until(st, end, world.model, world.tables, world.ecfg,
                             rounds_per_chunk=rpc)
    prepared = run_ensemble_until(st, end, world.model, world.tables, world.ecfg,
                                  rounds_per_chunk=rpc, launch=chunk)
    a, b = state_to_numpy(own), state_to_numpy(prepared)
    assert a.keys() == b.keys()
    assert all((a[k] == b[k]).all() for k in a), [k for k in a if not (a[k] == b[k]).all()]
    assert int(a[".events_handled"].sum()) > 0


def _runner(world, cache, replicas=2, stride=3, rpc=4):
    return EnsembleRunner(world.model, world.tables, world.ecfg, replicas, seed_stride=stride,
                          rounds_per_chunk=rpc, tx_bytes_per_interval=world.tx_refill,
                          rx_bytes_per_interval=world.rx_refill, compile_cache=cache,
                          cache_key="phold-key", device="cpu")


@pytest.fixture
def slog_lines():
    buf = io.StringIO()
    shadow_log.set_sink(buf)
    yield lambda: (shadow_log.flush(), buf.getvalue())[1]
    shadow_log.set_sink(None)


def test_persistent_cache_round_trips_a_prepared_chunk(tmp_path):
    """A second cache on the same directory (a restarted daemon) serves
    the entry from disk: no build, the same chunk, the same run."""
    config, world, _ = _world("phold")
    end = config.general.stop_time_ns
    first = PersistentCompileCache(str(tmp_path), device="cpu")
    a = _runner(world, first).run(end)
    assert (first.misses, first.hits, first.disk_stores) == (1, 0, 1)
    again = PersistentCompileCache(str(tmp_path), device="cpu")
    b = _runner(world, again).run(end)
    stats = again.stats()
    assert (stats["compiles"], stats["hits"], stats["persistent"]["disk_hits"]) == (0, 1, 1)
    assert stats["persistent"]["runtime"] == runtime_version("cpu")
    assert "peak_hbm_bytes" not in stats
    (entry,) = tmp_path.glob("exe-*.bin")
    header = json.loads(entry.read_bytes().split(b"\n", 1)[0])
    assert header["format"] == CACHE_FORMAT and header["runtime"] == f"torch-{torch.__version__}/cpu"
    x, y = state_to_numpy(a), state_to_numpy(b)
    assert all((x[k] == y[k]).all() for k in x)


def _damage(path: pathlib.Path, how: str) -> None:
    raw = path.read_bytes()
    head, payload = raw.split(b"\n", 1)
    header = json.loads(head)
    if how == "corrupt":
        chaos.damage_file(str(path), truncate=False)
    elif how == "truncate":
        chaos.damage_file(str(path), truncate=True)
    elif how in ("runtime", "format"):
        header["runtime" if how == "runtime" else "format"] = (
            "torch-0.0/cpu" if how == "runtime" else CACHE_FORMAT + 1)
        path.write_bytes(json.dumps(header).encode() + b"\n" + payload)
    else:  # a payload whose digest holds but which does not unpickle
        import hashlib

        payload = b"not a pickle"
        header["sha256"] = hashlib.sha256(payload).hexdigest()
        path.write_bytes(json.dumps(header).encode() + b"\n" + payload)


_WARNINGS = {"corrupt": "sha-256 integrity check", "truncate": "sha-256 integrity check",
             "runtime": "was written by 'torch-0.0/cpu'", "format": f"format {CACHE_FORMAT + 1}",
             "payload": "failed to deserialize"}


@pytest.mark.parametrize("how", sorted(_WARNINGS))
def test_bad_entry_rebuilds_with_a_warning(tmp_path, slog_lines, how):
    config, world, st = _world("phold")
    end = config.general.stop_time_ns
    PersistentCompileCache(str(tmp_path), device="cpu").get(
        "k", st, "cfg", lambda: lower_ensemble_chunk(st, end, 4, world.model, world.tables,
                                                     world.ecfg))
    (entry,) = tmp_path.glob("exe-*.bin")
    _damage(entry, how)
    cache = PersistentCompileCache(str(tmp_path), device="cpu")
    built = []
    cache.get("k", st, "cfg", lambda: built.append(1) or lower_ensemble_chunk(
        st, end, 4, world.model, world.tables, world.ecfg))
    assert built == [1] and (cache.misses, cache.disk_skips, cache.disk_stores) == (1, 1, 1)
    text = slog_lines()
    assert _WARNINGS[how] in text and "rebuilding" in text
    # evicted and re-stored: a third cache hits the fresh entry
    third = PersistentCompileCache(str(tmp_path), device="cpu")
    third.get("k", st, "cfg", lambda: pytest.fail("a sound entry must not rebuild"))
    assert third.disk_hits == 1


def test_cache_corrupt_fault_damages_the_stored_entry(tmp_path, slog_lines):
    config, world, st = _world("phold")
    end = config.general.stop_time_ns
    plan = chaos.FaultPlan(seed=0, faults=[chaos.parse_fault_arg("cache-corrupt@0")])

    def build():
        return lower_ensemble_chunk(st, end, 4, world.model, world.tables, world.ecfg)

    with chaos.installed(plan):
        PersistentCompileCache(str(tmp_path), device="cpu").get("k", st, "cfg", build)
    assert plan.report()["fired"] == [{"kind": "cache-corrupt", "at": 0}]
    cache = PersistentCompileCache(str(tmp_path), device="cpu")
    cache.get("k", st, "cfg", build)
    assert (cache.misses, cache.disk_skips) == (1, 1)
    assert "failed its sha-256 integrity check; rebuilding" in slog_lines()


def test_an_entry_that_is_not_a_chunk_is_not_persisted(tmp_path, slog_lines):
    st = {"a": torch.zeros(3)}
    cache = PersistentCompileCache(str(tmp_path), device="cpu")
    assert cache.get("k", st, "cfg", lambda: "exe") == "exe"
    assert (cache.disk_stores, cache.disk_skips) == (0, 1)
    assert not list(tmp_path.glob("exe-*.bin"))
    assert "does not serialize" in slog_lines()


def test_key_holds_the_device_and_the_cpu_reports_no_memory():
    cache = CompileCache()
    st = {"a": torch.zeros(3)}
    assert cache.get("k", st, "cfg", lambda: "cpu-exe") == "cpu-exe"
    assert cache.get("k", {"a": torch.zeros(3, device="meta")}, "cfg", lambda: "meta-exe") == (
        "meta-exe")
    assert cache.misses == 2 and cache.compile_peaks == []
    assert memtrack.compiled_memory("cpu-exe") is None
    assert runtime_version("cpu") == f"torch-{torch.__version__}/cpu"


def test_injected_compile_fault_in_the_seam_falls_a_rung(tmp_path):
    """The cache lookup runs in the compile seam: an injected fault on
    the pump engine falls to plain, which the cache then builds; the
    batch ends as the fault-free one."""
    config, world, _ = _world("tgen-pump")
    end = 100_000_000
    clean = _runner(world, CompileCache(), stride=1, rpc=8).run(end)
    cache = CompileCache()
    runner = _runner(world, cache, stride=1, rpc=8)
    plan = chaos.FaultPlan(seed=0, faults=[chaos.parse_fault_arg("compile:target=pump")])
    with chaos.installed(plan):
        got = runner.run(end)
    assert [(f["from"], f["to"]) for f in runner.engine_fallbacks] == [("pump", "plain")]
    assert cache.misses == 1 and next(iter(cache._entries.values())).engine == "plain"
    a, b = state_to_numpy(clean), state_to_numpy(got)
    # the engines are leaf-exact but for how many drain iterations they take
    differ = [k for k in a if not (a[k] == b[k]).all()]
    assert differ and set(differ) <= {".iters_done", ".lanes_live"}


REGROW_JOBS = "\n  jobs:\n    - name: ph\n      seeds: [0, 1]\n"
REGROW_CHAOS = "chaos:\n  faults:\n    - kind: capacity\n      at: 1\n"


def test_regrown_replay_keys_its_own_entry_as_shadow_tpu(tmp_path):
    """A capacity fault regrows the batch's queue: the replay at the
    grown shapes is a second build (never the first entry), as the JAX
    package's sweep counts it, and the jobs end as the JAX sweep's."""
    from shadow_tpu.cli import main as j_main
    from shadow_tpu_torch.cli import main as t_main

    (tmp_path / "base.yaml").write_text(PHOLD.replace("  seed: 5\n", "") + REGROW_CHAOS)
    manifests = {}
    for pkg, main, extra in (("ref", j_main, []), ("port", t_main, ["--device", "cpu"])):
        spec = tmp_path / f"{pkg}.yaml"
        spec.write_text(f"sweep:\n  base: base.yaml\n  output_dir: {tmp_path / pkg}"
                        + REGROW_JOBS)
        assert main(["sweep", *extra, str(spec)]) == 0
        manifests[pkg] = json.loads((tmp_path / pkg / "sweep-manifest.json").read_text())
    counts = {k: {c: m["compile_cache"][c] for c in ("compiles", "hits")}
              for k, m in manifests.items()}
    assert counts["port"] == counts["ref"] == {"compiles": 2, "hits": 0}
    assert manifests["port"]["batches"][0]["recoveries"] == 1
    for pkg_field in ("recoveries", "status", "preemptions"):
        assert manifests["port"]["batches"][0][pkg_field] == manifests["ref"]["batches"][0][
            pkg_field]
    for job in ("ph-s0", "ph-s1"):
        port = _stats(tmp_path / "port" / "jobs" / job / "sim-stats.json")
        assert port == _stats(tmp_path / "ref" / "jobs" / job / "sim-stats.json")
        assert port["recovery"]["count"] == 1


@pytest.mark.cuda
def test_prepared_chunk_matches_the_closure_on_the_card():
    """On the card, tgen's prepared chunk (the kernel's library loaded,
    its launch checked at the batch's shapes) runs the batch through the
    kernel leaf-equal to the chunk the driver prepares itself."""
    from shadow_tpu_torch.engine import megakernel as mk

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")

    config = load_config_str(_tgen_yaml(engine="auto", pump_k=8))
    world = Manager(config, device="cuda").build_world()
    st = init_ensemble_state(world.ecfg, world.model, 2, 1, world.tx_refill, world.rx_refill,
                             device="cuda")
    end, rpc = config.general.stop_time_ns, config.experimental.rounds_per_chunk
    chunk = lower_ensemble_chunk(st, end, rpc, world.model, world.tables, world.ecfg)
    assert chunk.engine == "megakernel" and chunk.instance == "tgen"
    assert chunk.library_tag == mk.PUMP_KERNEL.tag()
    launches0 = mk.PUMP_KERNEL.launches
    own = run_ensemble_until(st, end, world.model, world.tables, world.ecfg, rounds_per_chunk=rpc)
    mid = mk.PUMP_KERNEL.launches
    prepared = run_ensemble_until(st, end, world.model, world.tables, world.ecfg,
                                  rounds_per_chunk=rpc, launch=chunk)
    assert mk.PUMP_KERNEL.launches - mid == mid - launches0 > 0
    a, b = state_to_numpy(own), state_to_numpy(prepared)
    assert all((a[k] == b[k]).all() for k in a)
    mem = memtrack.compiled_memory(chunk)
    assert mem["peak_bytes"] >= mem["launch_peak_bytes"] > 0
