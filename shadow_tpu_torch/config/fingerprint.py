"""The config fingerprint: ONE definition of "same simulated world".

Three subsystems must agree on what makes two configs the same
trajectory, or their contracts silently diverge:

  * checkpoint validation (runtime/checkpoint.py) — a checkpoint may
    only resume the exact config it was saved from;
  * the sweep scheduler's job packing (runtime/sweep.py) — jobs that
    differ ONLY in seed are the same compiled world and batch into one
    ensemble program;
  * the compile cache (runtime/compile_cache.py) — executables are
    keyed by the fingerprint modulo seed, because the seed enters the
    simulation exclusively through the initial PRNG key grid
    (rng.host_keys/replica_keys), never the traced chunk program.

Hence this lives in `shadow_tpu/config`, below all three. The hash
covers the full processed config minus the knobs that only affect where
outputs land or how the run is displayed/checkpointed. `tracker` stays
IN (it changes the TrackerState leaves); `stop_time` stays in (resume
must target the same horizon for chunk boundaries to line up);
`replicas`/`replica_seed_stride` stay in (they change the state's
leading axis and every replica's derived seed — a resume with a
mismatched replica count must fail HERE with a clear error, never as a
shape mismatch deep in jax); `engine`/`pump_k` stay in (the engines are
bit-identical by contract, but pinning them keeps a resumed run on the
exact executable the checkpoint was written under).

`general.mesh` is OUT (the elastic-mesh contract, docs/parallelism.md
"Elastic mesh"): the grid is execution geometry, not a trajectory knob
— every replica slice is leaf-identical to its single-device run on any
RxS layout, so a checkpoint written on one grid must resume on any
other (including pure ensemble / pure sharded / single-device). What
the mesh DOES pin is the effective replica count — a bare `mesh: 2x4`
runs R=2 replicas — so fingerprint_dict normalizes `general.replicas`
to the effective count before dropping the grid: a resume that would
change the number of simulated worlds still refuses loudly, while one
that only re-lays the same worlds out does not. The grid a checkpoint
was written under travels as layout METADATA instead
(runtime/checkpoint.py `mesh` meta key).
"""

from __future__ import annotations

import hashlib
import json

# general-section keys that only steer output/display/checkpoint
# plumbing — excluded from the hash (tests/test_config_fingerprint.py
# pins both directions)
_DISPLAY_GENERAL_KEYS = (
    "data_directory",
    "progress",
    "log_level",
    "trace_file",
    "metrics_file",
    "metrics_prom",
    "metrics_max_mb",
    "metrics_keep",
    "heartbeat_interval_ns",
    "checkpoint_dir",
    "checkpoint_interval_ns",
    "resume",
)
# experimental-section keys that steer the recovery loop or the dispatch
# shape, not the trajectory (rollback-and-regrow replays are leaf-exact
# by contract; the chunk-dispatch watchdog re-dispatches the same chunks;
# the autotuner only re-chunks the same rounds — runtime/autotune.py —
# so a resumed run may re-tune freely)
_RECOVERY_EXPERIMENTAL_KEYS = (
    "recover",
    "recovery_max_retries",
    "recovery_snapshot_chunks",
    "chunk_watchdog_s",
    "autotune",
    "autotune_budget_s",
    # observability-only (runtime/flightrec.py): the recorder reads the
    # probe the driver already fetched, never the trajectory
    "xprof_dir",
    "xprof_chunks",
)


def fingerprint_dict(config) -> dict:
    """The processed-config dict the fingerprint actually hashes (the
    trajectory-pinning subset). Exposed so tests and tools can see WHAT
    is covered without reverse-engineering the hash."""
    d = config.to_dict()
    g = d.get("general", {})
    for k in _DISPLAY_GENERAL_KEYS:
        g.pop(k, None)
    # the 2-D mesh grid is execution GEOMETRY (module docstring):
    # normalize it to None — NOT pop it — after folding its one
    # trajectory-relevant effect (a bare `mesh: RxS` runs R replicas,
    # Manager._resolve_mesh) into general.replicas. "2x4" and
    # "--replicas 2 --mesh 1x2" then hash as the same two simulated
    # worlds while "--replicas 3" still refuses; and because every
    # pre-elastic config already serialized `mesh: null`, normalizing
    # (rather than removing) the key keeps every NON-mesh fingerprint
    # byte-identical across the upgrade — existing checkpoints, daemon
    # spools, and persistent compile-cache keys stay valid.
    mesh = g.get("mesh")
    if mesh is not None and g.get("replicas", 1) <= 1:
        from shadow_tpu_torch.config.options import parse_mesh

        g["replicas"] = parse_mesh(mesh)[0]
    g["mesh"] = None
    e = d.get("experimental", {})
    for k in _RECOVERY_EXPERIMENTAL_KEYS:
        e.pop(k, None)
    # the chaos plane injects host-side faults, never a trajectory: a
    # chaos run that completes is leaf-identical to the fault-free run,
    # so its checkpoints must resume under either config
    d.pop("chaos", None)
    return d


def fingerprint_diff(saved: dict, current: dict, prefix: str = "") -> "list[str]":
    """Dotted paths whose values differ between two fingerprint_dicts —
    the resume-refusal UX seam (runtime/checkpoint.py): a mismatch names
    the offending keys (`general.seed: 1 != 2`) instead of dumping two
    opaque hashes. Lists compare wholesale (host specs); missing keys
    print as `<absent>`."""
    out = []
    for k in sorted(set(saved) | set(current)):
        path = f"{prefix}{k}"
        a = saved.get(k, "<absent>")
        b = current.get(k, "<absent>")
        if isinstance(a, dict) and isinstance(b, dict):
            out.extend(fingerprint_diff(a, b, prefix=f"{path}."))
        elif a != b:
            out.append(f"{path}: {a!r} != {b!r}")
    return out


def config_fingerprint(config, *, exclude_seed: bool = False) -> str:
    """Hash of everything that pins the simulated trajectory.

    `exclude_seed=True` drops `general.seed` from the hash — the
    "same world modulo seed" key the sweep scheduler packs jobs by and
    the compile cache keys executables by (the seed never enters the
    traced chunk program; see module docstring). Checkpoint validation
    always uses the full hash.
    """
    d = fingerprint_dict(config)
    if exclude_seed:
        d.get("general", {}).pop("seed", None)
    return hashlib.sha256(
        json.dumps(d, sort_keys=True, default=str).encode()
    ).hexdigest()
