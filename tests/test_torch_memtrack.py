"""The port's memory observatory (shadow_tpu_torch/runtime/memtrack.py and
the `mem` subcommand) held against the JAX package's on the CPU: the
price_state report of the port's state against the reference's report of
the JAX state, grid for grid, on examples/tgen as one world, as an
R = 2 ensemble and with the segment exchange; the only grids allowed to
differ are the three the port widens (WIDENED: `seq`, `rng_counter` and
`rng_key`, int64 here where the reference holds uint32 words, 16 B a
host more). Also: a state built on the `meta` device prices exactly as
the one built on the CPU, render_report's table and max_hosts_for_budget
against the reference's, and `mem --json` on examples/tgen,
examples/phold and examples/onion against `shadow-tpu mem --json`."""

import dataclasses
import json
import pathlib

import jax
import pytest
import torch

from shadow_tpu.cli import main as j_main
from shadow_tpu.config import load_config_file as j_load_config_file
from shadow_tpu.engine.ensemble import init_ensemble_state as j_init_ensemble_state
from shadow_tpu.engine.state import init_state as j_init_state
from shadow_tpu.runtime import memtrack as j_memtrack
from shadow_tpu.runtime.manager import Manager as JManager
from shadow_tpu_torch.cli import main as t_main
from shadow_tpu_torch.config import load_config_file
from shadow_tpu_torch.engine.ensemble import init_ensemble_state
from shadow_tpu_torch.engine.round import bootstrap
from shadow_tpu_torch.engine.state import init_state
from shadow_tpu_torch.runtime import memtrack
from shadow_tpu_torch.runtime.cli_run import priced_state
from shadow_tpu_torch.runtime.manager import Manager

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = {"tgen": "tgen/shadow.yaml", "phold": "phold/shadow.yaml", "onion": "onion/onion.yaml"}
# the leaves the port holds as int64, and what the reference holds them as
WIDENED = {"seq": "uint32", "rng_counter": "uint32", "rng_key": "key<fry>"}
# examples/tgen/shadow.yaml's state in the port (16 hosts): the
# reference's 313,400 B and 16 B a host for the widened leaves
TGEN_TOTAL = 313_656


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _worlds(example: str):
    """The JAX package's and the port's worlds of an example config."""
    path = REPO / "examples" / EXAMPLES[example]
    jworld = JManager(j_load_config_file(str(path))).build_world()
    world = Manager(load_config_file(str(path)), device="cpu").build_world()
    return jworld, world


def _jax_report(jworld, replicas: int, cfg=None) -> dict:
    """The reference's report of its state, priced under jax.eval_shape
    as `shadow-tpu mem` prices it."""
    ecfg, m, tx, rx = jworld.ecfg, jworld.model, jworld.tx_refill, jworld.rx_refill
    if replicas > 1:
        st = jax.eval_shape(lambda: j_init_ensemble_state(ecfg, m, replicas, 1, tx, rx))
    else:
        st = jax.eval_shape(lambda: j_init_state(ecfg, m.init(), tx, rx))
    return j_memtrack.price_state(st, cfg or ecfg)


def _port_state(world, replicas: int):
    """The bootstrapped state a run of the port starts from, on the CPU."""
    ecfg, m, tx, rx = world.ecfg, world.model, world.tx_refill, world.rx_refill
    if replicas > 1:
        return init_ensemble_state(ecfg, m, replicas, 1, tx, rx, device="cpu")
    return bootstrap(init_state(ecfg, m.init("cpu"), tx, rx, device="cpu"), m, ecfg)


def assert_same_but_widened(want: dict, got: dict) -> None:
    """The port's report equals the reference's but for the WIDENED
    grids, each twice the reference's bytes in int64 (rng_key's two key
    words as an [.., 2] grid), and the totals they move."""
    hosts, r = got["num_hosts"], got["replicas"]
    assert (hosts, r) == (want["num_hosts"], want["replicas"])
    extra = 16 * hosts * r
    assert got["total_bytes"] == want["total_bytes"] + extra
    assert got["bytes_per_host"] == round(got["total_bytes"] / hosts, 2)
    assert got["dominant"] == want["dominant"]
    assert got.get("exchange_pool_transient_bytes") == want.get("exchange_pool_transient_bytes")
    assert sorted(got["groups"]) == sorted(want["groups"])
    for name, g in got["groups"].items():
        w = want["groups"][name]
        moved = extra if name == "rng" else 0
        assert g["bytes"] == w["bytes"] + moved, name
        wide = [x for x in g["grids"] if x["name"] in WIDENED]
        assert [x for x in g["grids"] if x["name"] not in WIDENED] == [
            x for x in w["grids"] if x["name"] not in WIDENED], name
        for x in wide:
            y = next(y for y in w["grids"] if y["name"] == x["name"])
            assert y["dtype"] == WIDENED[x["name"]] and x["dtype"] == "int64"
            assert x["bytes"] == 2 * y["bytes"]
            assert x["shape"] == y["shape"] + ([2] if x["name"] == "rng_key" else [])
    assert {x["name"] for x in got["groups"]["rng"]["grids"]} == set(WIDENED)


@pytest.mark.parametrize("plane", ["single", "replicas-2", "segment"])
def test_price_state_matches_jax_but_widened_leaves(plane):
    jworld, world = _worlds("tgen")
    replicas = 2 if plane == "replicas-2" else 1
    jcfg, cfg = jworld.ecfg, world.ecfg
    if plane == "segment":
        # the exchange's transient pool, at a pool of 40 slots
        jcfg = dataclasses.replace(jcfg, exchange="segment", pool_capacity=40)
        cfg = dataclasses.replace(cfg, exchange="segment", pool_capacity=40)
    want = _jax_report(jworld, replicas, jcfg)
    got = memtrack.price_state(_port_state(world, replicas), cfg)
    assert_same_but_widened(want, got)
    if plane == "single":
        assert got["total_bytes"] == TGEN_TOTAL
    if plane == "segment":
        assert got["exchange_pool_transient_bytes"] > 0


@pytest.mark.parametrize("replicas", [1, 2])
def test_meta_state_prices_as_the_cpu_state(replicas):
    """`mem` builds its state on the meta device: no storage, and the
    report of the state a run starts from."""
    _, world = _worlds("onion")
    meta = priced_state(world, replicas)
    assert meta.queue.time.device.type == "meta"
    assert memtrack.price_state(meta, world.ecfg) == memtrack.price_state(
        _port_state(world, replicas), world.ecfg)
    assert memtrack.price_state(priced_state(world, replicas, device="cpu"), world.ecfg) == (
        memtrack.price_state(meta, world.ecfg))


def test_render_report_and_budget_match_jax():
    """On the reference's own report: the same table, but for the
    projection line's note of what comes on top of the state, and the
    same hosts for every budget, monotone in the budget."""
    jworld, _ = _worlds("tgen")
    report = _jax_report(jworld, 2)
    for gb in (None, 0.5, 16):
        want = j_memtrack.render_report(report, hbm_gb=gb).splitlines()
        got = memtrack.render_report(report, hbm_gb=gb).splitlines()
        if gb:
            assert got[-1].split(" (")[0] == want[-1].split(" (")[0]
            assert got[-1].endswith("(state only; the run's temporaries and kernel scratch "
                                    "come on top)")
            got, want = got[:-1], want[:-1]
        assert got == want
    fits = [memtrack.max_hosts_for_budget(report, b) for b in (0, 10**6, 10**9, 10**12)]
    assert fits == [j_memtrack.max_hosts_for_budget(report, b)
                    for b in (0, 10**6, 10**9, 10**12)]
    assert fits == sorted(fits) and fits[-1] > 0


@pytest.mark.parametrize("example", sorted(EXAMPLES))
def test_mem_json_matches_shadow_tpu_mem(example, capsys):
    path = str(REPO / "examples" / EXAMPLES[example])
    assert j_main(["mem", path, "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert t_main(["mem", path, "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert_same_but_widened(want, got)
    if example == "tgen":
        assert got["total_bytes"] == TGEN_TOTAL


def test_mem_table_replicas_and_refusals(tmp_path, capsys):
    path = str(REPO / "examples" / EXAMPLES["tgen"])
    assert t_main(["mem", path, "--hbm-gb", "16"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("memory: 16 hosts, total 306.30 KiB")
    assert "dominant grid: queue.data [16x256x8] int32" in out
    assert "hosts fit in 16 GiB HBM" in out
    assert t_main(["mem", path, "--replicas", "3", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["total_bytes"] == 3 * TGEN_TOTAL
    # the mesh plane stays refused, user mistakes are one-line errors
    assert t_main(["mem", path, "--mesh", "2x1"]) == 1
    assert "general.mesh (the 2-D mesh plane) is not yet ported" in capsys.readouterr().err
    assert t_main(["mem", str(tmp_path / "nope.yaml")]) == 1
    assert "shadow-tpu-torch: error:" in capsys.readouterr().err


def test_device_memory_is_none_off_the_card():
    assert memtrack.device_memory(torch.device("cpu")) is None
    assert memtrack.device_memory(torch.device("meta")) is None
    _, world = _worlds("phold")
    section = memtrack.memory_section(_port_state(world, 1), world.ecfg)
    assert "device" not in section
    assert section["total_bytes"] == sum(section["groups"].values())
