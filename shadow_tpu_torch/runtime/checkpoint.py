"""Deterministic checkpoint/restore for device runs (port of
shadow_tpu/runtime/checkpoint.py).

A checkpoint is the complete run cursor: the chunk loop is memoryless
given the SimState (engine/round.py), so a state captured at a chunk
boundary plus the config fingerprint is everything resume needs — RNG
keys and draw counters, scheduler progress (`now`) and the tracker plane
all live on the state. A run resumed from a checkpoint re-executes
exactly the chunk sequence the uninterrupted run would have run from
that boundary, so the final state is bit-identical.

On-disk format (versioned, the reference's): one .npz per checkpoint
holding the state_to_host leaves (the PRNG keys as their raw uint32
words, the u32 leaves as uint32) as ``leaf_00000..`` entries in the
reference's leaf order, plus a ``__meta__`` JSON string with the format
version, the config fingerprint (and its key-by-key fingerprint_detail),
the sim time, the leaf key paths, the sha-256 payload digest and the
buffer capacities. A checkpoint either package writes loads in the
other. Writes are atomic (tmp + os.replace), so a kill mid-write never
leaves a truncated "latest" checkpoint. Restore validates version,
fingerprint, digest, and every leaf's shape against a freshly built
template state: a checkpoint can only resume the world it was saved
from.

The chunk loops tap states through StateTap (engine/round.py run_until's
`on_state`): snapshots are committed only after a probe has verified
them free of overflow, so a checkpoint never contains silently dropped
events. InterruptGuard turns SIGINT/SIGTERM into a final verified
checkpoint and RunInterrupted instead of a lost run.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import signal
import threading
import time

import numpy as np

from shadow_tpu_torch.config.fingerprint import (  # noqa: F401
    config_fingerprint,
    fingerprint_diff,
)
from shadow_tpu_torch.engine.state import SimState, state_from_host
from shadow_tpu_torch.runtime import flightrec
from shadow_tpu_torch.utils.shadow_log import slog

CHECKPOINT_VERSION = 1


class CheckpointError(ValueError):
    """A checkpoint could not be used: wrong version, wrong config
    fingerprint, a failed integrity check, or a corrupt/truncated
    file."""


def _payload_digest(leaves) -> str:
    """SHA-256 over the leaf payload in leaf order (dtype + shape + bytes
    per leaf, so a reinterpretation can never collide). Written into the
    meta by save_checkpoint, re-derived and compared on load."""
    h = hashlib.sha256()
    for leaf in leaves:
        a = np.ascontiguousarray(np.asarray(leaf))
        h.update(f"{a.dtype}:{a.shape}:".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def save_checkpoint(path: str, host_state: "dict[str, np.ndarray]", meta: dict) -> str:
    """Write a host (state_to_host) snapshot atomically. `meta` must carry
    at least the fingerprint; version/leaf bookkeeping and the payload
    integrity digest are added here."""
    paths = list(host_state)
    leaves = [host_state[p] for p in paths]
    full_meta = dict(meta)
    full_meta.update(
        version=CHECKPOINT_VERSION,
        num_leaves=len(leaves),
        leaf_paths=paths,
        sha256=_payload_digest(leaves),
        # resume rebuilds the template at these widths, which rollback-
        # and-regrow may have grown past the config's (shape[-1] is the
        # capacity axis for single [H, Q] and ensemble [R, H, Q] states)
        queue_capacity=int(host_state[".queue.time"].shape[-1]),
        outbox_capacity=int(host_state[".outbox.valid"].shape[-1]),
    )
    arrays = {f"leaf_{i:05d}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    arrays["__meta__"] = np.asarray(json.dumps(full_meta, default=str))
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def peek_checkpoint_meta(path: str) -> dict:
    """Read only the meta record (no leaf arrays): resume uses this to
    learn the saved buffer capacities before building the template. A
    truncated or corrupt file raises a CheckpointError naming it."""
    try:
        with np.load(path, allow_pickle=False) as z:
            return json.loads(str(z["__meta__"][()]))
    except Exception as e:
        raise CheckpointError(
            f"checkpoint {path} is unreadable (corrupt or truncated): "
            f"{type(e).__name__}: {e}"
        ) from e


def verify_checkpoint(path: str) -> "str | None":
    """Full integrity check: structural readability plus the sha-256
    payload digest. None when the file is sound, else a short reason."""
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"][()]))
            leaves = [z[f"leaf_{i:05d}"] for i in range(meta["num_leaves"])]
    except Exception as e:
        return f"unreadable (corrupt or truncated): {type(e).__name__}"
    digest = meta.get("sha256")
    if digest is not None and _payload_digest(leaves) != digest:
        return "payload failed its sha-256 integrity check"
    return None


def grid_label(grid: "str | None") -> str:
    """One rendering of a layout-metadata grid for logs and errors (None:
    single device)."""
    return grid or "single-device"


def _mismatch_message(path: str, meta: dict, fingerprint: str,
                      detail: "dict | None", layout: "str | None") -> str:
    """The resume-refusal message: both grids and the offending
    trajectory keys instead of two opaque hashes."""
    saved_grid = grid_label(meta.get("mesh"))
    cur_grid = grid_label(layout)
    msg = (
        f"checkpoint {path} was written for a different config "
        f"(saved on grid {saved_grid}, resuming on grid {cur_grid})"
    )
    saved_detail = meta.get("fingerprint_detail")
    if saved_detail is not None and detail is not None:
        keys = fingerprint_diff(saved_detail, detail)
        if keys:
            shown = "; ".join(keys[:8])
            if len(keys) > 8:
                shown += f"; … ({len(keys) - 8} more)"
            return f"{msg}; differing keys: {shown}"
    return (
        f"{msg}; fingerprint {str(meta.get('fingerprint'))[:12]}… != "
        f"{fingerprint[:12]}… — resume must use the exact world config "
        "the checkpoint was saved from (grid layout may differ freely)"
    )


def load_checkpoint(
    path: str, like: SimState, fingerprint: "str | None" = None,
    check_digest: bool = True, detail: "dict | None" = None,
    layout: "str | None" = None,
) -> "tuple[SimState, dict]":
    """Load a checkpoint into a SimState on `like`'s device, shaped like
    the template (a freshly built initial state of the same config).
    Validates the format version, the config fingerprint (when given),
    the sha-256 payload digest (unless `check_digest` is False, for a
    path that CheckpointManager.latest_path just verified), and every
    leaf's shape via state_from_host. `detail` (the caller's
    fingerprint_dict) and `layout` only improve the mismatch error."""
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"][()]))
            if meta.get("version") != CHECKPOINT_VERSION:
                raise CheckpointError(
                    f"checkpoint {path} has format version {meta.get('version')}, "
                    f"this build reads version {CHECKPOINT_VERSION}"
                )
            if fingerprint is not None and meta.get("fingerprint") != fingerprint:
                raise CheckpointError(
                    _mismatch_message(path, meta, fingerprint, detail, layout)
                )
            leaves = [z[f"leaf_{i:05d}"] for i in range(meta["num_leaves"])]
    except CheckpointError:
        raise
    except Exception as e:
        raise CheckpointError(
            f"checkpoint {path} is unreadable (corrupt or truncated): "
            f"{type(e).__name__}: {e}"
        ) from e
    digest = meta.get("sha256")
    if check_digest and digest is not None and _payload_digest(leaves) != digest:
        raise CheckpointError(
            f"checkpoint {path} failed its sha-256 integrity check: the "
            "payload was modified or corrupted after it was written"
        )
    from shadow_tpu_torch.utils.tree import tree_leaves_with_path

    t_paths = [p for p, _ in tree_leaves_with_path(like)]
    if len(leaves) != len(t_paths):
        raise CheckpointError(
            f"checkpoint {path} holds {len(leaves)} leaves, the template "
            f"state has {len(t_paths)} — state layout changed"
        )
    # the template's leaf order is the reference's: leaf i is path i
    host = dict(zip(t_paths, leaves))
    try:
        st = state_from_host(host, like)
    except ValueError as e:
        raise CheckpointError(f"checkpoint {path}: {e}") from e
    return st, meta


class CheckpointManager:
    """Writes checkpoints on a sim-time cadence and prunes old ones.
    Filenames embed the zero-padded sim time (``ckpt-<now>.npz``), so the
    lexically-last file is always the newest; `keep` bounds disk use."""

    def __init__(
        self,
        directory: str,
        interval_ns: int,
        fingerprint: str,
        keep: int = 2,
        layout: "str | None" = None,
        detail: "dict | None" = None,
    ):
        self.directory = directory
        self.interval_ns = int(interval_ns)
        self.fingerprint = fingerprint
        self.keep = keep
        # layout metadata (the mesh grid a run dispatches on, or None);
        # recorded in the meta, never validated on load
        self.layout = layout
        # the fingerprint_dict behind `fingerprint`: a mismatched resume
        # names the offending keys
        self.detail = detail
        self.written: "list[str]" = []
        self._next = self.interval_ns if self.interval_ns > 0 else None
        # the live engine config (set per recovery attempt by
        # run_until_recovering): regrowth also widens deliver_lanes, a
        # config knob not derivable from state shapes, which resume must
        # restore too or the replay re-hits the same overflow
        self.engine_cfg = None
        os.makedirs(directory, exist_ok=True)

    def due(self, probe) -> bool:
        return self._next is not None and probe.now >= self._next

    def write(self, host_state: "dict[str, np.ndarray]", final: bool = False) -> str:
        # ensemble states carry a [R] `now`; the cadence follows the
        # slowest replica, as the aggregate probe's `now` does
        now = int(np.min(np.asarray(host_state[".now"])))
        if self._next is not None:
            self._next = (now // self.interval_ns + 1) * self.interval_ns
        path = os.path.join(self.directory, f"ckpt-{now:020d}.npz")
        meta = {"fingerprint": self.fingerprint, "now_ns": now, "final": final}
        if self.layout is not None:
            meta["mesh"] = self.layout
        if self.detail is not None:
            meta["fingerprint_detail"] = self.detail
        if self.engine_cfg is not None:
            meta["deliver_lanes"] = self.engine_cfg.deliver_lanes
            meta["a2a_capacity"] = self.engine_cfg.a2a_capacity
            meta["pool_capacity"] = self.engine_cfg.pool_capacity
        t0 = time.perf_counter()
        save_checkpoint(path, host_state, meta)
        # checkpoint walls are part of the metrics stream (a run stalling
        # on serialization must be visible there)
        flightrec.record_event(
            "checkpoint", wall_s=round(time.perf_counter() - t0, 4),
            now_ns=now, final=final, path=path,
        )
        self.written.append(path)
        slog("info", now, "checkpoint",
             f"wrote {'final ' if final else ''}checkpoint {path}")
        self._prune()
        return path

    def _prune(self) -> None:
        existing = sorted(glob.glob(os.path.join(self.directory, "ckpt-*.npz")))
        for stale in existing[: -self.keep] if self.keep > 0 else []:
            try:
                os.remove(stale)
            except OSError:
                pass

    @staticmethod
    def latest_path(directory: str, verify: bool = True) -> "str | None":
        """Newest usable checkpoint: candidates are walked newest-first and
        each is integrity-checked (structure + sha-256 digest); a corrupt
        or truncated file is skipped with a warning and the next older
        one is tried. `verify=False` gives the lexically newest."""
        found = sorted(glob.glob(os.path.join(directory, "ckpt-*.npz")))
        for path in reversed(found):
            if not verify:
                return path
            reason = verify_checkpoint(path)
            if reason is None:
                return path
            slog("warning", 0, "checkpoint",
                 f"skipping checkpoint {path}: {reason}; "
                 "falling back to the previous one")
        return None


class InterruptGuard:
    """SIGINT/SIGTERM → "write a final checkpoint, then stop" instead of a
    lost run. The handler only sets a flag; the chunk loop notices it at the
    next probe (engine/round.py run_until), commits the best verifiable
    snapshot, and raises RunInterrupted. A second signal restores the
    previous handlers, so a double Ctrl-C still kills a wedged run.

    `test_interrupt_at_ns` (or the SHADOW_TPU_TEST_INTERRUPT_AT_NS env
    var) arms the same code path deterministically from sim time."""

    def __init__(self, test_interrupt_at_ns: "int | None" = None):
        if test_interrupt_at_ns is None:
            env = os.environ.get("SHADOW_TPU_TEST_INTERRUPT_AT_NS")
            test_interrupt_at_ns = int(env) if env else None
        self.test_interrupt_at_ns = test_interrupt_at_ns
        self._flag = False
        self._prev: dict = {}

    def fired(self, now_ns: int) -> bool:
        if self._flag:
            return True
        return (
            self.test_interrupt_at_ns is not None
            and now_ns >= self.test_interrupt_at_ns
        )

    def _handle(self, signum, frame):
        self._flag = True
        self._restore()  # a second signal falls through to the old handler

    def __enter__(self) -> "InterruptGuard":
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGINT, signal.SIGTERM):
                self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        self._restore()

    def _restore(self) -> None:
        for sig, prev in list(self._prev.items()):
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()


class StateTap:
    """The on_state hook the chunk loops call: composes the checkpoint
    cadence, the recovery retainer (runtime/recovery.py StateRetainer)
    and the interrupt guard over one shared snapshot per due point — the
    full-state copy to the host is paid once no matter how many
    consumers want the state."""

    def __init__(self, checkpoints=None, retainer=None, guard=None):
        self.checkpoints = checkpoints
        self.retainer = retainer
        self.guard = guard
        self._last_now = 0
        self._ckpt_due = False
        self._retain_due = False

    def due(self, probe, chunk_idx: int) -> bool:
        self._last_now = probe.now
        self._ckpt_due = self.checkpoints is not None and self.checkpoints.due(probe)
        self._retain_due = self.retainer is not None and self.retainer.due(chunk_idx)
        return self._ckpt_due or self._retain_due

    def interrupted(self) -> bool:
        return self.guard is not None and self.guard.fired(self._last_now)

    def commit(self, host_state) -> None:
        final = self.interrupted()
        if self.retainer is not None and (self._retain_due or final):
            self.retainer.commit(host_state)
        if self.checkpoints is not None and (self._ckpt_due or final):
            self.checkpoints.write(host_state, final=final)
        self._ckpt_due = self._retain_due = False
