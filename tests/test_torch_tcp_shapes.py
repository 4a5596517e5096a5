"""The pump kernel at any TCP shape (out-of-order ranges, segments per
flush), register_model and the `shm-cleanup` command
(shadow_tpu_torch/engine/megakernel.py, models/registry.py, cli.py).

On the CPU, megakernel_stage runs the kernel's plain twin
(engine/pump.py::pump_stage), which is generic over the shape: at (8, 8),
(2, 2) and (1, 1) one stage must equal the JAX package's jitted
pump_stage, every leaf and the rejected flag, on a mid-run state of a
small lossy tgen world (chip_smoke.lossy_world: loss between nodes, so
segments arrive out of order and the ranges fill). chip_smoke.py's
SHAPE_MODELS, registered in both packages' registries, run end to end
through both packages' `run` on small lossy worlds, and their
sim-stats.json must be equal but for the execution-shape fields. The
wrapper's per-shape libraries, its checks and instance names, and its
refusal of a model whose pump rules no instance carries are checked
here; the CUDA instances themselves run on the card
(tests/test_torch_shape_kernel.py, chip_smoke.py). Exact equality
throughout: times, ties, counters and RNG counters are integers."""

import dataclasses
import mmap
import os
import time

import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from test_torch_models import assert_leaves_equal, chip_smoke, jax_leaves, worlds
from test_torch_megakernel import _jax_state
from test_torch_slice import _stats

import shadow_tpu.models.registry as j_registry
import shadow_tpu_torch.models.registry as t_registry
from shadow_tpu.engine.pump import pump_stage as j_pump_stage
from shadow_tpu_torch import equeue
from shadow_tpu_torch.config.options import NotYetPorted
from shadow_tpu_torch.engine import megakernel as mk
from shadow_tpu_torch.engine.pump import pump_stage
from shadow_tpu_torch.engine.round import _next_window_end, run_until
from shadow_tpu_torch.engine.state import state_to_numpy
from shadow_tpu_torch.models.tgen import TGEN_TCP, TgenModel
from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill
from shadow_tpu_torch.simtime import NS_PER_MS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def shape_models():
    """SHAPE_MODELS registered in both packages' registries for one
    test, and removed after it (the registries are process-global)."""
    for registry in (j_registry, t_registry):
        chip_smoke.register_shape_models(registry)
    yield sorted(chip_smoke.SHAPE_MODELS)
    for registry in (j_registry, t_registry):
        for name in chip_smoke.SHAPE_MODELS:
            registry._REGISTRY.pop(name, None)


# ---- the twin at other shapes against the JAX package ----------------

HOSTS = 128
LOSS = 0.05
PUMP_K = 3
# per shape, a time at which P1, P2 and P3 fire in the next stage and
# sockets hold out-of-order ranges (at (8, 8) three, past a (2, 2) set)
MID_NS = {(8, 8): 35 * NS_PER_MS, (2, 2): 30 * NS_PER_MS, (1, 1): 24 * NS_PER_MS}
SHAPES = list(MID_NS)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_twin_matches_jax_pump_stage_at_shape(shape, monkeypatch):
    """chip_smoke.lossy_world at HOSTS hosts with TGEN_TCP at `shape`,
    run by the port's plain engine to MID_NS[shape]: one stage of the twin
    equals the JAX package's jitted pump_stage on the same state."""
    import test_torch_models
    from shadow_tpu.models.tgen import TgenModel as JTgenModel

    # test_torch_models.worlds builds the JAX package's tgen too
    monkeypatch.setitem(test_torch_models._PORT_CLASSES, JTgenModel, TgenModel)
    cfg, model, _, _ = chip_smoke.lossy_world(HOSTS, torch.device("cpu"), loss=LOSS,
                                              tcp_shape=shape)
    assert (model.tcp_params.ooo_ranges, model.tcp_params.segs_per_flush) == shape
    assert dataclasses.replace(model.tcp_params, ooo_ranges=4, segs_per_flush=4) == TGEN_TCP
    bw = bw_bits_per_sec_to_refill(20_000_000)
    cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name not in ("num_hosts", "runahead_ns")}
    cfg_kw["pump_k"] = PUMP_K
    (jcfg, jm, jtables, jst), (tcfg, tables, st0) = worlds(
        model, LOSS, chip_smoke.lossy_gml(5, LOSS, 11), [i % 5 for i in range(HOSTS)],
        cfg_kw, bw, bw)
    st = run_until(st0, MID_NS[shape], model, tables, dataclasses.replace(tcfg, engine="plain"))
    we = _next_window_end(st, 10**9, tcfg, equeue.next_time(st.queue).amin(), tables)

    # what the stage exercises, from the twin (held equal to JAX below)
    steps = []
    got, got_rej = pump_stage(st.clone(), we, model, tables, tcfg, debug_out=steps)
    taken = {k: sum(d[k] for d in steps) for k in ("p1", "p2", "p3", "rejected")}
    assert taken["p1"] > 0 and taken["p2"] > 0 and taken["p3"] > 0, taken
    in_use = (st.model.tcp.ooo[..., 0] >= 0).sum(-1)
    assert int(in_use.max()) >= min(shape[0], 3)

    want, want_rej = jax.jit(lambda s, w: j_pump_stage(s, w, jm, jtables, jcfg))(
        _jax_state(jst, state_to_numpy(st)), jnp.asarray(int(we), jnp.int64))
    assert bool(got_rej) == bool(want_rej)
    assert_leaves_equal(jax_leaves(want), state_to_numpy(got))
    # megakernel_stage on the CPU is that twin, at any shape
    same, _ = mk.megakernel_stage(st.clone(), we, model, tables, tcfg)
    assert_leaves_equal(state_to_numpy(got), state_to_numpy(same))


# ---- registered models through both packages' front doors ------------

RUN_HOSTS = 24
RUN_STOP_NS = {"tgen_ooo8": 60 * NS_PER_MS, "onion_r2s2": 60 * NS_PER_MS}
ONION_ARGS = {"relays": RUN_HOSTS // 2, "hops": 2, "cell": 256, "resp_cells": 8,
              "circuits": 4, "tick": "200 us"}


def _config(tmp_path, name, data) -> str:
    """chip_smoke.services_world at RUN_HOSTS hosts with process path
    `name`, one device, written to a file whose data directory is
    `data`."""
    world = chip_smoke.services_world(
        RUN_HOSTS, RUN_STOP_NS[name], path=name,
        args=ONION_ARGS if name == "onion_r2s2" else None)
    world["general"].update(parallelism=1, data_directory=str(tmp_path / data))
    path = tmp_path / f"{data}.yaml"
    path.write_text(yaml.safe_dump(world))
    return str(path)


@pytest.mark.parametrize("name", sorted(chip_smoke.SHAPE_MODELS))
def test_registered_model_runs_through_both_front_doors(tmp_path, shape_models, name):
    """A SHAPE_MODELS model through `shadow-tpu run` and `python -m
    shadow_tpu_torch run --device cpu`: equal sim-stats.json but for the
    wall clock and the execution shape, and the model at its shape."""
    from shadow_tpu.cli import main as j_main
    from shadow_tpu_torch.cli import main as t_main
    from shadow_tpu_torch.config.options import load_config_file
    from shadow_tpu_torch.runtime.manager import Manager

    cfg_path = _config(tmp_path, name, "port")
    world = Manager(load_config_file(cfg_path), device="cpu").build_world()
    assert mk.tcp_shape(world.model) == chip_smoke.SHAPE_MODELS[name][1]
    assert j_main(["run", _config(tmp_path, name, "ref")]) == 0
    assert t_main(["run", "--device", "cpu", cfg_path]) == 0
    want = _stats(tmp_path / "ref" / "sim-stats.json")
    got = _stats(tmp_path / "port" / "sim-stats.json")
    assert want["events_handled"] > 0 and want["packets_dropped"] > 0
    assert got == want


def test_register_model_matches_the_reference(shape_models):
    """After the registrations, both registries list the same names,
    build the same model (field for field) from the same args, and name
    an unknown model alike."""
    assert t_registry.registered_models() == j_registry.registered_models()
    assert set(shape_models) <= set(t_registry.registered_models())
    for name in shape_models:
        args = ONION_ARGS if name == "onion_r2s2" else {"clients": 4, "pause": "30 ms"}
        a = t_registry.build_model(name, RUN_HOSTS, dict(args))
        b = j_registry.build_model(name, RUN_HOSTS, dict(args))
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert mk.tcp_shape(a) == chip_smoke.SHAPE_MODELS[name][1]
    for bad in ("tgen_ooo9", "nosuch"):
        assert t_registry.unknown_model_error(bad) == j_registry.unknown_model_error(bad)
        with pytest.raises(ValueError) as t_err:
            t_registry.build_model(bad, 4, {})
        with pytest.raises(ValueError) as j_err:
            j_registry.build_model(bad, 4, {})
        assert str(t_err.value) == str(j_err.value)
    # a registration replaces the builder under its name, as the reference's
    t_registry.register_model("tgen_ooo8", t_registry._build_tgen)
    assert mk.tcp_shape(t_registry.build_model("tgen_ooo8", 8, {})) == mk.TCP_SHAPE


# ---- the wrapper at any shape ----------------------------------------

def _burst(shape, hosts=16):
    cfg, model, tables, st0 = chip_smoke.lossy_world(hosts, torch.device("cpu"),
                                                     tcp_shape=shape)
    st = run_until(st0, 22 * NS_PER_MS, model, tables, dataclasses.replace(cfg, engine="plain"))
    we = _next_window_end(st, 10**9, cfg, equeue.next_time(st.queue).amin(), tables)
    return mk.resolve_stage_cfg(cfg), model, tables, st, we


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (8, 8), (16, 16), (1, 16), (16, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_args_take_every_shape_within_the_limit(shape):
    """kernel_args takes a shape up to MAX_TCP_SHAPE: R and
    segs_per_flush in the struct name the library; ooo and sacked are
    checked at the shape's R ranges and the outbox at its lanes."""
    cfg, model, tables, st, we = _burst(shape)
    rej = torch.zeros((1,), dtype=torch.int32)
    codel = mk.PUMP_KERNEL.codel_table("cpu")
    args, _ = mk.kernel_args(st, torch.tensor(int(we)), model, tables, cfg, rej, codel)
    assert (args.R, args.segs_per_flush, args.S) == (*shape, TGEN_TCP.num_sockets)
    assert args.packet_emits == shape[1] + 1 and args.wide == 0
    tcp = st.model.tcp
    other = 2 if shape[0] == 1 else shape[0] - 1
    for leaf in ("ooo", "sacked"):
        bad = dataclasses.replace(tcp, **{leaf: getattr(tcp, leaf)[:, :, :1].expand(
            -1, -1, other, -1).contiguous()})
        with pytest.raises(ValueError, match=leaf):
            mk.kernel_args(dataclasses.replace(st, model=dataclasses.replace(st.model, tcp=bad)),
                           torch.tensor(int(we)), model, tables, cfg, rej, codel)
    ob = st.outbox
    short = dataclasses.replace(ob, data=ob.data[:, :, :4].contiguous())
    with pytest.raises(ValueError, match="ob_data"):
        mk.kernel_args(dataclasses.replace(st, outbox=short), torch.tensor(int(we)), model,
                       tables, cfg, rej, codel)


@pytest.mark.parametrize("shape", [(17, 4), (4, 17), (0, 4), (4, 0)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_shape_past_the_limit_is_refused_with_the_limit(shape):
    model = chip_smoke.with_tcp_shape(
        TgenModel(num_hosts=16, num_clients=8, num_servers=8), shape)
    with pytest.raises(NotYetPorted, match=f"1 to {mk.MAX_TCP_SHAPE[0]} ranges"):
        mk.check_tcp_shape(mk.tcp_shape(model))
    with pytest.raises(NotYetPorted, match="registers"):
        mk.PUMP_KERNEL.library(mk.tcp_shape(model))


def test_one_library_per_shape():
    """A library per shape: its tag and file name carry the shape; the
    default shape's nvcc command is the plain one (the source's own
    defaults, PUMP_NR and PUMP_NSEG), any other adds the two defines."""
    k = mk.PUMP_KERNEL
    shapes = [(1, 1), (2, 2), (4, 4), (8, 8), (16, 16)]
    paths = {k.library_path(s) for s in shapes}
    assert len(paths) == len(shapes)
    for s in shapes:
        assert k.tag(s).startswith(f"{s[0]}x{s[1]}-")
        assert k.library_path(s).name == f"pump_megakernel_{k.tag(s)}.so"
    assert k.tag() == k.tag(mk.TCP_SHAPE) and k.library_path() == k.library_path((4, 4))
    assert k.nvcc_command("nvcc", "out.so") == [
        "nvcc", *mk.NVCC_FLAGS, "-o", "out.so", str(mk.SOURCE)]
    assert k.nvcc_command("nvcc", "out.so", (8, 2)) == [
        "nvcc", *mk.NVCC_FLAGS, "-DPUMP_NR=8", "-DPUMP_NSEG=2", "-o", "out.so", str(mk.SOURCE)]


def test_instances_are_named_per_shape():
    """kernel_instance, the name launches count under: INSTANCES at the
    default shape, "@<ranges>x<segments>" at another."""
    from test_torch_onion import MODEL as ONION

    cfg = mk.resolve_stage_cfg(chip_smoke.lossy_world(16, torch.device("cpu"))[0])
    wide = dataclasses.replace(cfg, pump_k=40)
    tgen = TgenModel(num_hosts=16, num_clients=8, num_servers=8)
    assert mk.kernel_instance(tgen, cfg) == "tgen"
    assert mk.kernel_instance(chip_smoke.with_tcp_shape(tgen, (8, 8)), cfg) == "tgen@8x8"
    assert mk.kernel_instance(chip_smoke.with_tcp_shape(tgen, (8, 8)), wide) == "tgen_wide@8x8"
    assert mk.kernel_instance(chip_smoke.with_tcp_shape(ONION, (2, 2)), cfg) == "onion@2x2"
    assert mk.kernel_instance(ONION, wide) == "onion_wide"
    assert mk.instance_name("onion", True, (1, 1)) == "onion_wide@1x1"


def test_kernel_model_refuses_a_model_with_its_own_pump_rules():
    """A TgenModel subclass whose pump_spec.block differs is not run with
    tgen's rules on the card: kernel_model and kernel_args refuse it,
    naming the model and the explicit way to run its rules there."""

    @dataclasses.dataclass(frozen=True)
    class NeverPumpTgen(TgenModel):
        @property
        def pump_spec(self):
            spec = super().pump_spec
            return dataclasses.replace(
                spec, block=lambda ms, host_id, *a: torch.ones_like(host_id, dtype=torch.bool))

    cfg, model, tables, st, we = _burst(mk.TCP_SHAPE)
    sub = NeverPumpTgen(**{f.name: getattr(model, f.name) for f in dataclasses.fields(model)})
    with pytest.raises(NotYetPorted, match="NeverPumpTgen.*engine: pump"):
        mk.kernel_model(sub)
    with pytest.raises(NotYetPorted, match="NeverPumpTgen"):
        mk.kernel_args(st, torch.tensor(int(we)), sub, tables, cfg,
                       torch.zeros((1,), dtype=torch.int32), mk.PUMP_KERNEL.codel_table("cpu"))
    # the twin runs each model's own rules: tgen's take P2 and P3 steps
    # here, the subclass's veto every one
    for m, took in ((model, True), (sub, False)):
        steps = []
        pump_stage(st.clone(), we, m, tables, cfg, debug_out=steps)
        assert (sum(d["p2"] + d["p3"] for d in steps) > 0) == took
    assert mk.kernel_model(model) == "tgen"


# ---- shm-cleanup --------------------------------------------------------

def _shm_blocks(tmp_path):
    stale = tmp_path / "shadow-tpu-h0p1000-dead"
    stale.write_bytes(b"x" * 4096)
    os.utime(stale, (time.time() - 60, time.time() - 60))  # past the grace
    live = tmp_path / "shadow-tpu-h0p1001-live"
    live.write_bytes(b"x" * 4096)
    other = tmp_path / "unrelated"
    other.write_bytes(b"x")
    return stale, live, other


def test_shm_cleanup(tmp_path):
    """tests/test_tools.py::test_shm_cleanup against the port's copy."""
    from shadow_tpu_torch.cli import shm_cleanup

    stale, live, other = _shm_blocks(tmp_path)
    fd = os.open(live, os.O_RDWR)
    mm = mmap.mmap(fd, 4096)  # mapped, as a running simulation maps it
    os.close(fd)
    try:
        assert shm_cleanup(str(tmp_path)) == 0
        assert not stale.exists()  # nobody maps it: crash debris, removed
        assert live.exists()  # mapped by a live process: kept
        assert other.exists()  # not ours
    finally:
        mm.close()


def test_cli_shm_cleanup_dispatches_as_the_reference(tmp_path, monkeypatch, capsys):
    """`python -m shadow_tpu_torch shm-cleanup` reaches shm_cleanup and
    exits as `shadow-tpu shm-cleanup` does; both pointed at tmp_path."""
    import shadow_tpu.cli as j_cli
    import shadow_tpu_torch.cli as t_cli

    outs = []
    for cli in (j_cli, t_cli):
        real = cli.shm_cleanup
        monkeypatch.setattr(cli, "shm_cleanup", lambda real=real: real(str(tmp_path)))
        stale, live, other = _shm_blocks(tmp_path)  # live: inside the 5 s grace
        assert cli.main(["shm-cleanup"]) == 0
        assert not stale.exists() and live.exists() and other.exists()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == f"shm-cleanup: removed 1 stale block(s) from {tmp_path}\n"
