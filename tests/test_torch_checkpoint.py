"""Checkpoints (shadow_tpu_torch/runtime/checkpoint.py) held against the
JAX package: the file round trip with the reference's meta, the
reference's CheckpointError texts (fingerprint mismatch, template shape
mismatch), interrupt-and-resume reaching the JAX package's uninterrupted
final state for phold and for tgen through the kernel's twin (the pump
engine at pump_k 3), an R = 2 ensemble resumed from a checkpoint taken
between its replicas' quiescence (the reference's straddling world), and
files crossing between the packages both ways: the port resumes from a
file the JAX package wrote, and the JAX package loads and resumes the
port's. Worlds: tests/test_pipeline.py's phold world, tests/test_pump.py's
tgen world. Exact equality throughout."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_pipeline import _phold_world
from test_pump import _world as _tgen_world
from test_torch_ensemble import port_world
from test_torch_slice import _assert_leaves_equal as assert_leaves_equal
from test_torch_slice import _jax_leaves as jax_leaves

from shadow_tpu.engine.ensemble import init_ensemble_state as j_init_ensemble_state
from shadow_tpu.engine.ensemble import run_ensemble_until as j_run_ensemble_until
from shadow_tpu.engine.round import RunInterrupted as JRunInterrupted
from shadow_tpu.engine.round import run_until as j_run_until
from shadow_tpu.engine.state import state_to_host as j_state_to_host
from shadow_tpu.runtime import checkpoint as jck
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.engine.ensemble import init_ensemble_state, run_ensemble_until
from shadow_tpu_torch.engine.round import RunInterrupted, run_until
from shadow_tpu_torch.engine.state import state_from_numpy, state_to_host, state_to_numpy
from shadow_tpu_torch.runtime.checkpoint import (
    CheckpointError,
    CheckpointManager,
    InterruptGuard,
    StateTap,
    load_checkpoint,
    peek_checkpoint_meta,
    save_checkpoint,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _phold(**kw):
    jcfg, jm, jt, jst = _phold_world(**kw)
    jcfg = dataclasses.replace(jcfg, tracker=True)
    cfg, model, tables = port_world(jcfg, jm, jt)
    return jcfg, jm, jt, jst, cfg, model, tables, state_from_numpy(jax_leaves(jst))


def _error_text(excinfo, path):
    return str(excinfo.value).replace(str(path), "<path>")


def test_file_roundtrip_and_errors_like_jax(tmp_path):
    """A port checkpoint round-trips leaf for leaf with the reference's
    meta; a different fingerprint is refused with the reference's text;
    the JAX package's load_checkpoint reads the port's file."""
    jcfg, jm, jt, jst, cfg, model, tables, st0 = _phold()
    st = run_until(st0, 10 * NS_PER_MS, model, tables, cfg, rounds_per_chunk=4)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state_to_host(st), {"fingerprint": "fp", "now_ns": 1})
    restored, meta = load_checkpoint(path, st0, "fp")
    assert_leaves_equal(state_to_numpy(st), state_to_numpy(restored))
    assert meta["fingerprint"] == "fp" and meta["queue_capacity"] == cfg.queue_capacity
    assert meta["leaf_paths"] == list(jax_leaves(jst))  # the reference's leaf order
    assert peek_checkpoint_meta(path)["num_leaves"] == meta["num_leaves"]
    j_restored, j_meta = jck.load_checkpoint(path, jst, "fp")
    assert_leaves_equal(state_to_numpy(st), jax_leaves(j_restored))
    assert j_meta["sha256"] == meta["sha256"]
    with pytest.raises(CheckpointError, match="different config") as got:
        load_checkpoint(path, st0, "other-fp")
    jck.save_checkpoint(path, j_state_to_host(jst), {"fingerprint": "fp", "now_ns": 1})
    with pytest.raises(jck.CheckpointError) as want:
        jck.load_checkpoint(path, jst, "other-fp")
    assert _error_text(got, path) == _error_text(want, path)


def test_template_shape_mismatch_like_jax(tmp_path):
    """A checkpoint restores only into the world it came from: 6 hosts
    into a 4-host template is refused with the reference's text."""
    jst6 = _phold(num_hosts=6)[3]
    *_, jst4, _c, _m, _t, st4 = _phold(num_hosts=4)
    path = str(tmp_path / "ckpt.npz")
    jck.save_checkpoint(path, j_state_to_host(jst6), {"fingerprint": "fp"})
    with pytest.raises(jck.CheckpointError) as want:
        jck.load_checkpoint(path, jst4, "fp")
    save_checkpoint(path, state_to_host(state_from_numpy(jax_leaves(jst6))), {"fingerprint": "fp"})
    with pytest.raises(CheckpointError) as got:
        load_checkpoint(path, st4, "fp")
    assert "snapshot leaf shape" in str(got.value)
    assert _error_text(got, path) == _error_text(want, path)


def _interrupt(run, st0, end, model, tables, cfg, ckpt_dir, interval_ns, at_ns, rpc):
    """Drive `run` with a checkpoint tap until the deterministic test
    interrupt fires; return the newest checkpoint's path."""
    ck = CheckpointManager(str(ckpt_dir), interval_ns, "fp")
    tap = StateTap(checkpoints=ck, guard=InterruptGuard(test_interrupt_at_ns=at_ns))
    with pytest.raises(RunInterrupted):
        run(st0, end, model, tables, cfg, rounds_per_chunk=rpc, on_state=tap)
    path = CheckpointManager.latest_path(str(ckpt_dir))
    assert path is not None
    return path


def _tgen_pump3():
    jcfg, jm, jt, jst = _tgen_world(8, 0.02, 20_000_000, seed=3)
    jcfg = dataclasses.replace(jcfg, engine="pump", pump_k=3)
    cfg, model, tables = port_world(jcfg, jm, jt)
    return jcfg, jm, jt, jst, cfg, model, tables, state_from_numpy(jax_leaves(jst))


# name: (world, end, rounds per chunk, checkpoint interval, interrupt at)
RESUMES = {
    "phold": (_phold, 40 * NS_PER_MS, 4, 8 * NS_PER_MS, 20 * NS_PER_MS),
    "tgen-pump3": (_tgen_pump3, 30 * NS_PER_MS, 2, 4 * NS_PER_MS, 10 * NS_PER_MS),
}


@pytest.mark.parametrize("name", list(RESUMES))
def test_interrupt_resume_matches_jax(tmp_path, name):
    """Interrupted at a chunk boundary and resumed from the newest
    checkpoint, the port reaches the JAX package's uninterrupted final
    state."""
    build, end, rpc, interval, at = RESUMES[name]
    jcfg, jm, jt, jst, cfg, model, tables, st0 = build()
    want = jax_leaves(j_run_until(jst, end, jm, jt, jcfg, rounds_per_chunk=rpc))
    path = _interrupt(run_until, st0, end, model, tables, cfg, tmp_path, interval, at, rpc)
    restored, meta = load_checkpoint(path, st0, "fp")
    assert 0 < meta["now_ns"] < end and meta["final"]
    resumed = run_until(restored, end, model, tables, cfg, rounds_per_chunk=rpc)
    assert want[".events_handled"].sum() > 0
    assert_leaves_equal(want, state_to_numpy(resumed))


def test_files_cross_between_packages(tmp_path):
    """The port resumes from a checkpoint the JAX package wrote at its
    interrupt and reaches the JAX package's final state; the JAX package
    resumes from the port's and reaches the same."""
    jcfg, jm, jt, jst, cfg, model, tables, st0 = _phold()
    end, rpc = 40 * NS_PER_MS, 4
    want = jax_leaves(j_run_until(jst, end, jm, jt, jcfg, rounds_per_chunk=rpc))
    jdir = tmp_path / "jax"
    ck = jck.CheckpointManager(str(jdir), 8 * NS_PER_MS, "fp")
    tap = jck.StateTap(checkpoints=ck, guard=jck.InterruptGuard(test_interrupt_at_ns=20 * NS_PER_MS))
    with pytest.raises(JRunInterrupted):
        j_run_until(jst, end, jm, jt, jcfg, rounds_per_chunk=rpc, on_state=tap)
    restored, _ = load_checkpoint(jck.CheckpointManager.latest_path(str(jdir)), st0, "fp")
    assert_leaves_equal(want, state_to_numpy(run_until(restored, end, model, tables, cfg,
                                                       rounds_per_chunk=rpc)))
    path = _interrupt(run_until, st0, end, model, tables, cfg, tmp_path / "port",
                      8 * NS_PER_MS, 20 * NS_PER_MS, rpc)
    # the two packages interrupt at the same chunk and write the same file
    assert os.path.basename(path) == os.path.basename(jck.CheckpointManager.latest_path(str(jdir)))
    j_restored, _ = jck.load_checkpoint(path, jst, "fp")
    assert_leaves_equal(want, jax_leaves(j_run_until(j_restored, end, jm, jt, jcfg,
                                                     rounds_per_chunk=rpc)))


STRIDE = 2  # the ensemble's seed stride


def test_ensemble_resumes_across_a_replicas_quiescence(tmp_path):
    """The reference's straddling world (phold seed 11, R = 2, one round
    per chunk, a checkpoint every 2 ms), at seed stride 2, where replica 1
    goes quiet six chunks before replica 0 (at stride 1 both quiesce in
    one chunk with this jax, and no checkpoint straddles): a checkpoint
    taken after one replica quiesced and before the other did resumes
    to the uninterrupted run's final state, the JAX ensemble's."""
    jcfg, jm, jt, _, cfg, model, tables, _ = _phold(seed=11)
    end = 40 * NS_PER_MS
    want = jax_leaves(j_run_ensemble_until(j_init_ensemble_state(jcfg, jm, 2, STRIDE), end, jm,
                                           jt, jcfg, rounds_per_chunk=1))
    ens0 = init_ensemble_state(cfg, model, 2, STRIDE, device="cpu")
    ck = CheckpointManager(str(tmp_path), 2 * NS_PER_MS, "fp", keep=50)
    straight = run_ensemble_until(ens0, end, model, tables, cfg, rounds_per_chunk=1,
                                  on_state=StateTap(checkpoints=ck))
    assert_leaves_equal(want, state_to_numpy(straight))
    straddling = []
    for p in ck.written:
        st, _ = load_checkpoint(p, ens0, "fp")
        quiet = st.queue.head_time.amin(dim=1).numpy() >= end
        if quiet.any() and not quiet.all():
            straddling.append(st)
    assert straddling, "no checkpoint straddles the replicas' quiescence"
    resumed = run_ensemble_until(straddling[-1], end, model, tables, cfg, rounds_per_chunk=1)
    assert_leaves_equal(want, state_to_numpy(resumed))
    assert np.asarray(want[".now"]).shape == (2,)
