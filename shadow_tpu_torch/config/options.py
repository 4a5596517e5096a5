"""Typed simulation configuration: YAML file ⊕ overrides.

Mirrors the reference's config architecture (reference:
src/main/core/support/configuration.rs:96-455): one source of truth with
`general` / `network` / `experimental` / `hosts` sections, typed units
("10 Mbit", "2 sec"), per-host defaults with overrides, YAML merge keys
(pyyaml handles `<<:` natively) and ignored `x-...` extension fields
(reference main.rs:272-291). The `experimental.scheduler` knob is the
Scheduler seam (reference scheduler/mod.rs:31): `tpu` (the device engine,
sharded over all visible devices) or `cpu-ref` (the Python conformance
oracle).

Where the reference runs real executables per host
(`hosts.<name>.processes[].path`), this build currently runs *scripted
host models* on device; `path` therefore names a registered model
(e.g. "phold") — the managed-process layer will widen this seam.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import yaml

from shadow_tpu_torch.simtime import parse_time_ns
from shadow_tpu_torch.units import parse_bandwidth_bits_per_sec


class NotYetPorted(ValueError):
    """A configured feature that the PyTorch port does not carry yet.
    Raised while the config is loaded or the world is built, never
    mid-run, so a run that starts is a run the port can finish."""

    def __init__(self, feature: str):
        super().__init__(f"{feature} is not yet ported to shadow_tpu_torch")
        self.feature = feature


# the chaos plane's injectable fault catalog (runtime/chaos.py builds
# FaultPlans from these; defined here so runtime/chaos.py and this
# module share one catalog without a circular top-level import —
# ChaosOptions.from_dict lazily borrows FaultSpec for value validation)
FAULT_KINDS = (
    "capacity",
    "stall",
    "compile",
    "ckpt-corrupt",
    "ckpt-truncate",
    "worker-kill",
    "worker-hang",
    "preempt",
    # daemon-plane faults (runtime/daemon.py; docs/robustness.md):
    # SIGKILL the serve process at an admission/batch/chunk/checkpoint
    # ordinal, corrupt a just-written spool journal record, corrupt a
    # just-written persistent compile-cache entry
    "daemon-kill",
    "spool-corrupt",
    "cache-corrupt",
    # elastic-mesh fault (docs/robustness.md "Device loss"): simulate a
    # device dropping out at chunk-launch ordinal `at` (`target=N` names
    # the lost jax device id) — exercises mesh degradation: roll back,
    # re-plan onto the surviving grid, replay leaf-exact
    "device-loss",
    # front-door faults (runtime/httpapi.py, runtime/daemon.py;
    # docs/service.md "HTTP front door"): drop an HTTP request with a
    # structured 503 at request ordinal `at`; rewrite a daemon's own
    # batch claim to a foreign owner at lease-renewal ordinal `at` — the
    # daemon must detect the loss, park the batch, and reclaim later
    "http-drop",
    "lease-steal",
)


def parse_mesh(spec: str) -> "tuple[int, int]":
    """Parse the user-facing `--mesh RxS` / `general.mesh` grid spec
    into (replica rows, host shards). Accepts 'x', 'X' or the Unicode
    multiplication sign as the separator. Lives in the config layer (no
    device imports) so config validation and the engine's MeshPlan
    (engine/mesh.py) share one definition."""
    s = str(spec).strip().lower().replace("×", "x")
    parts = s.split("x")
    if len(parts) != 2 or not all(p.strip().isdigit() for p in parts):
        raise ValueError(
            f"mesh spec {spec!r} must be 'RxS' (replica rows x host "
            "shards), e.g. '2x4'"
        )
    rows, shards = (int(p) for p in parts)
    if rows < 1 or shards < 1:
        raise ValueError(f"mesh spec {spec!r}: both grid sizes must be >= 1")
    return rows, shards


def canonical_mesh(spec: str) -> str:
    """Validate and canonicalize a mesh grid spec to "RxS" — the ONE
    form config fingerprints, compile-cache keys, and batch configs
    store (every entry point canonicalizes through here, so the same
    grid can never hash two ways)."""
    rows, shards = parse_mesh(spec)
    return f"{rows}x{shards}"


def deep_merge(base: dict, overrides: dict) -> dict:
    """Recursive dict merge, overrides winning: nested mappings merge
    key-by-key, anything else (scalars, lists) replaces wholesale. Used
    by the sweep spec (config/sweep.py) to derive per-job configs from a
    base scenario; returns a new dict, inputs untouched."""
    out = dict(base)
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _drop_extension_fields(obj):
    """Strip `x-...` keys anywhere in the tree (reference main.rs:272-291)."""
    if isinstance(obj, dict):
        return {k: _drop_extension_fields(v) for k, v in obj.items() if not str(k).startswith("x-")}
    if isinstance(obj, list):
        return [_drop_extension_fields(v) for v in obj]
    return obj


@dataclasses.dataclass
class GeneralOptions:
    stop_time_ns: int = 0  # required > 0
    seed: int = 1
    bootstrap_end_time_ns: int = 0
    heartbeat_interval_ns: int = 1_000_000_000
    parallelism: int = 0  # 0 = all visible devices
    log_level: str = "info"
    data_directory: str = "shadow.data"
    progress: bool = False
    # Tracker plane (docs/observability.md): `tracker` turns on the
    # device-side counters (per-kind events, byte classes, high-water
    # marks -> heartbeat lines + a richer sim-stats.json); `trace_file`
    # writes a Chrome-trace JSON of the dispatch pipeline (and implies
    # span recording even without `tracker`). CLI: --tracker/--trace-file.
    tracker: bool = False
    trace_file: Optional[str] = None
    # Flight recorder / metrics plane (docs/observability.md):
    # `metrics_file` streams per-chunk JSONL samples live (tailable;
    # flushed at heartbeat cadence), `metrics_prom` rewrites a
    # Prometheus textfile snapshot for scraping. Both read the probe the
    # driver already fetched — zero extra device syncs. The post-mortem
    # black box (flight-recorder.json) is always on. CLI:
    # --metrics-file / --metrics-prom.
    metrics_file: Optional[str] = None
    metrics_prom: Optional[str] = None
    # Rolling retention for the metrics stream (runtime/flightrec.py):
    # when metrics_max_mb > 0 the JSONL file rotates at that size cap
    # (file -> file.1 -> ... -> file.N) keeping metrics_keep rotated
    # segments, so a week-long daemon soak cannot fill the disk.
    # 0 = unbounded (the pre-daemon behavior).
    metrics_max_mb: float = 0.0
    metrics_keep: int = 3
    # Fault tolerance (docs/robustness.md): `checkpoint_dir` turns on
    # versioned chunk-boundary checkpoints at `checkpoint_interval`
    # sim-time cadence (SIGINT/SIGTERM also write a final one); `resume`
    # restores the newest checkpoint in the dir and continues to
    # stop_time, bit-exact vs an uninterrupted run. CLI:
    # --checkpoint-dir/--checkpoint-interval/--resume.
    checkpoint_dir: Optional[str] = None
    checkpoint_interval_ns: int = 30_000_000_000
    resume: bool = False
    # Ensemble plane (docs/ensemble.md): `replicas` runs R independent
    # seeded copies of the scenario in ONE device program (scripted
    # models on the tpu scheduler; vmapped over a leading replica axis);
    # replica r is leaf-identical to a single run seeded
    # seed + r * replica_seed_stride. sim-stats.json gains per-replica
    # sections plus an aggregate mean/stddev/CI block. CLI: --replicas /
    # --replica-seed-stride.
    replicas: int = 1
    replica_seed_stride: int = 1
    # 2-D mesh plane (docs/parallelism.md "2-D mesh"): "RxS" lays the
    # replica batch over a Mesh(replica, hosts) device grid — R replica
    # rows x S host-shards, hosts block-sharded inside each row. The
    # run's replica count is general.replicas when > 1 (must be a
    # multiple of R; each row vmaps replicas/R locally), else R. Slice r
    # stays leaf-identical to a single-device run seeded
    # seed + r * stride. CLI: --mesh RxS. None = no mesh (the
    # single-device ensemble / parallelism sharding planes).
    mesh: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "GeneralOptions":
        out = cls()
        if "stop_time" in d:
            out.stop_time_ns = parse_time_ns(d.pop("stop_time"))
        if "bootstrap_end_time" in d:
            out.bootstrap_end_time_ns = parse_time_ns(d.pop("bootstrap_end_time"))
        if "heartbeat_interval" in d:
            hb = d.pop("heartbeat_interval")
            out.heartbeat_interval_ns = 0 if hb is None else parse_time_ns(hb)
        if "checkpoint_interval" in d:
            ci = d.pop("checkpoint_interval")
            # null = no periodic cadence (final/interrupt checkpoints
            # only), mirroring heartbeat_interval's null handling
            out.checkpoint_interval_ns = 0 if ci is None else parse_time_ns(ci)
        for k in (
            "seed",
            "parallelism",
            "log_level",
            "data_directory",
            "progress",
            "tracker",
            "trace_file",
            "metrics_file",
            "metrics_prom",
            "metrics_max_mb",
            "metrics_keep",
            "checkpoint_dir",
            "resume",
            "replicas",
            "replica_seed_stride",
            "mesh",
        ):
            if k in d:
                setattr(out, k, d.pop(k))
        _reject_unknown("general", d)
        if out.mesh is not None:
            out.mesh = canonical_mesh(out.mesh)  # loud on a bad spec
        out.metrics_max_mb = float(out.metrics_max_mb)
        if out.metrics_max_mb < 0:
            raise ValueError("general.metrics_max_mb must be >= 0 (0 = unbounded)")
        out.metrics_keep = int(out.metrics_keep)
        if out.metrics_keep < 1:
            raise ValueError("general.metrics_keep must be >= 1")
        if out.replicas < 1:
            raise ValueError("general.replicas must be >= 1")
        if out.replica_seed_stride < 1:
            raise ValueError(
                "general.replica_seed_stride must be >= 1 (stride 0 would "
                "alias every replica onto the same PRNG streams)"
            )
        return out


@dataclasses.dataclass
class GraphSource:
    kind: str = "1_gbit_switch"  # "1_gbit_switch" | "gml"
    inline: Optional[str] = None
    path: Optional[str] = None


@dataclasses.dataclass
class NetworkOptions:
    graph: GraphSource = dataclasses.field(default_factory=GraphSource)
    use_shortest_path: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "NetworkOptions":
        out = cls()
        g = d.pop("graph", None)
        if g is not None:
            kind = g.get("type", "1_gbit_switch")
            src = GraphSource(kind=kind)
            if kind == "gml":
                if "inline" in g:
                    src.inline = g["inline"]
                elif "file" in g:
                    src.path = g["file"]["path"] if isinstance(g["file"], dict) else g["file"]
                else:
                    raise ValueError("network.graph type 'gml' needs 'inline' or 'file'")
            elif kind != "1_gbit_switch":
                raise ValueError(f"unknown graph type {kind!r}")
            out.graph = src
        if "use_shortest_path" in d:
            out.use_shortest_path = bool(d.pop("use_shortest_path"))
        _reject_unknown("network", d)
        return out


@dataclasses.dataclass
class ExperimentalOptions:
    # "tpu": device engine for scripted models; hybrid (CPU guests, device
    # network plane) for managed executables. "managed": serial CPU kernel
    # for managed executables. "cpu-ref": the pure-Python conformance oracle.
    scheduler: str = "tpu"
    runahead_ns: Optional[int] = None  # None = min graph latency
    use_dynamic_runahead: bool = False
    # Adaptive conservative windows (engine/state.py adaptive_window,
    # docs/architecture.md "Lookahead & compaction"): extend each round to
    # the LBTS bound min(next_event + per-node lookahead) instead of the
    # fixed start + runahead width. Leaf-identical to fixed-width runs;
    # off only for A/B debugging of the window policy itself. Ignored
    # under use_dynamic_runahead, where window width moves delivery
    # times (engine/round.py _next_window_end).
    adaptive_window: bool = True
    # Live-host compaction (engine/state.py active_lanes): cap each drain
    # iteration to this many gathered live host lanes (0 = full width).
    # Bit-identical results at any value.
    active_lanes: int = 0
    # Round-engine selection (engine/state.py EngineConfig.engine): all
    # four values are bit-identical on every model; determinism-relevant
    # only in that the config fingerprint pins a resumed run to the exact
    # executable its checkpoints were written under.
    engine: str = "auto"  # "auto" | "plain" | "pump" | "megakernel"
    pump_k: int = 0  # microsteps per pump/megakernel iteration (0 = off)
    queue_capacity: int = 64
    outbox_capacity: int = 16
    record_capacity: int = 128  # hybrid per-host outcome-record ring
    rounds_per_chunk: int = 256
    max_iters_per_round: int = 1_000_000
    # managed-process options (reference: configuration.rs:298-455)
    strace_logging_mode: str = "standard"  # "off" | "standard" | "deterministic"
    interface_qdisc: str = "fifo"  # "fifo" | "rr" (reference QDiscMode)
    use_tcp_sack: bool = True  # SACK scoreboard retransmission
    use_tcp_autotune: bool = True  # receive-window/send-buffer autotuning
    # bulk-memory IO tier (reference use_memory_manager,
    # memory_copier.rs:64-170): large stream IO copies guest memory
    # directly via process_vm_readv/writev instead of the shm channel
    use_memory_manager: bool = True
    use_pcap: bool = False
    syscall_latency_ns: int = 1_000
    vdso_latency_ns: int = 10
    max_unapplied_cpu_latency_ns: int = 1_000_000
    # Rollback-and-regrow capacity recovery (docs/robustness.md): on a
    # CapacityError the scripted device run rolls back to the last clean
    # chunk-boundary snapshot, doubles the saturated buffer, recompiles,
    # and replays — leaf-exact vs starting with the larger capacity.
    # `recover: false` (CLI --no-recover) restores fail-fast.
    recover: bool = True
    recovery_max_retries: int = 4
    recovery_snapshot_chunks: int = 32
    # Compile-budget autotuner (runtime/autotune.py, docs/usage.md): when
    # true, a tiny-chunk compile probe walks rounds_per_chunk down before
    # the main compile so one config knob can never blow the whole run's
    # wall budget. Trajectory-neutral (chunking only groups rounds), so
    # the keys are excluded from the config fingerprint. CLI:
    # --autotune SECONDS / --no-autotune.
    autotune: bool = False
    autotune_budget_s: float = 120.0
    # Chunk-dispatch watchdog (docs/robustness.md): wall-clock seconds a
    # single chunk dispatch (launch + probe fetch) may take before the
    # driver abandons the in-flight chunk and re-dispatches from the
    # retained clean snapshot (counted like a recovery in sim-stats).
    # 0 = off. CLI: --chunk-watchdog.
    chunk_watchdog_s: float = 0.0
    # jax.profiler capture window (docs/observability.md): write an
    # xprof trace of the chunk dispatches in [start, end) of
    # xprof_chunks into xprof_dir. Best-effort — a backend without
    # profiler support records an event and continues. CLI:
    # --xprof-dir / --xprof-chunks.
    xprof_dir: Optional[str] = None
    xprof_chunks: str = "1:3"

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentalOptions":
        out = cls()
        if "runahead" in d:
            ra = d.pop("runahead")
            out.runahead_ns = None if ra is None else parse_time_ns(ra)
        for lat_key, attr in (
            ("syscall_latency", "syscall_latency_ns"),
            ("vdso_latency", "vdso_latency_ns"),
            ("max_unapplied_cpu_latency", "max_unapplied_cpu_latency_ns"),
        ):
            if lat_key in d:
                setattr(out, attr, parse_time_ns(d.pop(lat_key)))
        for k in (
            "scheduler",
            "use_dynamic_runahead",
            "adaptive_window",
            "active_lanes",
            "autotune",
            "autotune_budget_s",
            "engine",
            "pump_k",
            "queue_capacity",
            "outbox_capacity",
            "record_capacity",
            "rounds_per_chunk",
            "max_iters_per_round",
            "strace_logging_mode",
            "use_pcap",
            "use_tcp_sack",
            "use_tcp_autotune",
            "use_memory_manager",
            "interface_qdisc",
            "recover",
            "recovery_max_retries",
            "recovery_snapshot_chunks",
            "chunk_watchdog_s",
            "xprof_dir",
            "xprof_chunks",
        ):
            if k in d:
                setattr(out, k, d.pop(k))
        if out.chunk_watchdog_s < 0:
            raise ValueError("experimental.chunk_watchdog_s must be >= 0")
        parts = str(out.xprof_chunks).split(":")
        if (
            len(parts) != 2
            or not all(p.lstrip("-").isdigit() for p in parts)
            or int(parts[0]) < 0
            or int(parts[1]) <= int(parts[0])
        ):
            raise ValueError(
                f"experimental.xprof_chunks must be 'START:END' chunk "
                f"indices with 0 <= START < END, got {out.xprof_chunks!r}"
            )
        if out.strace_logging_mode is False:  # YAML 1.1 parses bare `off` as False
            out.strace_logging_mode = "off"
        if out.strace_logging_mode not in ("off", "standard", "deterministic"):
            raise ValueError(
                f"unknown strace_logging_mode {out.strace_logging_mode!r} "
                "(expected 'off', 'standard', or 'deterministic')"
            )
        if out.interface_qdisc not in ("fifo", "rr"):
            raise ValueError(
                f"unknown interface_qdisc {out.interface_qdisc!r} "
                "(expected 'fifo' or 'rr')"
            )
        if out.scheduler not in ("tpu", "cpu-ref", "managed"):
            raise ValueError(
                f"unknown scheduler {out.scheduler!r} "
                "(expected 'tpu', 'cpu-ref', or 'managed')"
            )
        if out.engine not in ("auto", "plain", "pump", "megakernel"):
            raise ValueError(
                f"unknown engine {out.engine!r} "
                "(expected 'auto', 'plain', 'pump', or 'megakernel')"
            )
        _reject_unknown("experimental", d)
        return out


@dataclasses.dataclass
class ChaosOptions:
    """Deterministic fault injection (docs/robustness.md "Chaos
    testing"; runtime/chaos.py). `seed` feeds the plan's own PRNG
    stream (resolves `at: auto` trigger draws reproducibly); `faults`
    is a list of fault mappings: `kind` (required, one of FAULT_KINDS),
    `at` (site ordinal, int | "auto" | null = first opportunity),
    `target` (engine / worker / sweep-job name), `count` (firings,
    -1 = persistent), `stall_s` (kind=stall only). The section is
    excluded from the config fingerprint: a chaos run that completes is
    leaf-identical to the fault-free run, so its checkpoints must
    resume under either config. CLI: --chaos-seed / --chaos-fault."""

    seed: int = 0
    faults: list = dataclasses.field(default_factory=list)

    _FAULT_KEYS = ("kind", "at", "target", "count", "stall_s")

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosOptions":
        out = cls()
        out.seed = int(d.pop("seed", 0))
        faults = d.pop("faults", []) or []
        if not isinstance(faults, list):
            raise ValueError("chaos.faults must be a list of fault mappings")
        # lazy: runtime/chaos.py imports FAULT_KINDS from this module, so
        # the dependency can only run config -> runtime at call time
        from shadow_tpu_torch.runtime.chaos import FaultSpec

        for f in faults:
            if not isinstance(f, dict):
                raise ValueError("chaos.faults entries must be mappings")
            f = dict(f)
            kind = f.get("kind")
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"chaos.faults: unknown kind {kind!r} "
                    f"(expected one of {sorted(FAULT_KINDS)})"
                )
            unknown = sorted(set(f) - set(cls._FAULT_KEYS))
            if unknown:
                raise ValueError(f"unknown key(s) in chaos fault: {unknown}")
            # validate values eagerly against the one definition
            # (FaultSpec): a bad `at:`/`count:`/`stall_s:` is a one-line
            # config error at load time, not a traceback mid-run
            try:
                FaultSpec(**f)
            except (TypeError, ValueError) as e:
                raise ValueError(f"chaos.faults entry {f!r}: {e}") from e
            out.faults.append(f)
        _reject_unknown("chaos", d)
        return out


@dataclasses.dataclass
class ProcessOptions:
    """One process on a host. `path` is either a registered scripted-model
    name (on-device simulation) or a real executable path (managed process
    under the LD_PRELOAD shim — the reference's only mode,
    configuration.rs:560-640). Scripted models take `args` as a mapping;
    executables take a string or list of argv words."""

    path: str = ""
    args: "dict | list" = dataclasses.field(default_factory=dict)
    start_time_ns: int = 0
    environment: dict = dataclasses.field(default_factory=dict)
    expected_final_state: str = "exited"  # "exited" | "running"
    shutdown_time_ns: Optional[int] = None

    @classmethod
    def from_dict(cls, d: dict) -> "ProcessOptions":
        import shlex

        out = cls()
        out.path = d.pop("path")
        args = d.pop("args", {})
        if args is None:
            args = {}
        if isinstance(args, str):
            args = shlex.split(args)
        if isinstance(args, list):
            out.args = [str(a) for a in args]
        elif isinstance(args, dict):
            out.args = args
        else:
            raise ValueError(f"process.args must be a mapping, list, or string, got {type(args)}")
        if "start_time" in d:
            out.start_time_ns = parse_time_ns(d.pop("start_time"))
        if "shutdown_time" in d:
            st = d.pop("shutdown_time")
            out.shutdown_time_ns = None if st is None else parse_time_ns(st)
        env = d.pop("environment", {}) or {}
        if not isinstance(env, dict):
            raise ValueError("process.environment must be a mapping")
        out.environment = {str(k): str(v) for k, v in env.items()}
        efs = d.pop("expected_final_state", "exited")
        if efs not in ("exited", "running"):
            raise ValueError(
                f"process.expected_final_state must be 'exited' or 'running', got {efs!r}"
            )
        out.expected_final_state = efs
        if out.shutdown_time_ns is not None and out.shutdown_time_ns <= out.start_time_ns:
            raise ValueError("process.shutdown_time must be after start_time")
        _reject_unknown("process", d)
        return out


@dataclasses.dataclass
class HostOptions:
    name: str = ""
    network_node_id: int = 0
    quantity: int = 1
    ip_addr: Optional[str] = None
    bandwidth_up_bits: Optional[int] = None
    bandwidth_down_bits: Optional[int] = None
    # Simulated CPU frequency in Hz (reference host.rs:60 cpu_frequency +
    # cpu.rs:8-50): syscall/vdso time charges scale by native/simulated, so
    # a half-speed host pays double the kernel-crossing latency. None =
    # native speed (ratio 1).
    cpu_frequency_hz: Optional[int] = None
    processes: list = dataclasses.field(default_factory=list)

    @classmethod
    def from_dict(cls, name: str, d: dict, defaults: dict) -> "HostOptions":
        merged = dict(defaults)
        merged.update(d)
        out = cls(name=name)
        out.network_node_id = int(merged.pop("network_node_id", 0))
        out.quantity = int(merged.pop("quantity", 1))
        out.ip_addr = merged.pop("ip_addr", None)
        if "bandwidth_up" in merged:
            bw = merged.pop("bandwidth_up")
            out.bandwidth_up_bits = None if bw is None else parse_bandwidth_bits_per_sec(bw)
        if "bandwidth_down" in merged:
            bw = merged.pop("bandwidth_down")
            out.bandwidth_down_bits = None if bw is None else parse_bandwidth_bits_per_sec(bw)
        if "cpu_frequency" in merged:
            v = merged.pop("cpu_frequency")
            out.cpu_frequency_hz = None if v is None else int(v)
            if out.cpu_frequency_hz is not None and out.cpu_frequency_hz <= 0:
                raise ValueError(f"hosts.{name}.cpu_frequency must be > 0 Hz")
        out.processes = [ProcessOptions.from_dict(dict(p)) for p in merged.pop("processes", [])]
        _reject_unknown(f"hosts.{name}", merged)
        if out.quantity < 1:
            raise ValueError(f"hosts.{name}.quantity must be >= 1")
        return out


@dataclasses.dataclass
class ConfigOptions:
    general: GeneralOptions
    network: NetworkOptions
    experimental: ExperimentalOptions
    hosts: "list[HostOptions]"
    chaos: ChaosOptions = dataclasses.field(default_factory=ChaosOptions)

    @classmethod
    def from_dict(cls, raw: dict) -> "ConfigOptions":
        raw = _drop_extension_fields(raw)
        if "general" not in raw:
            raise ValueError("config missing required 'general' section")
        if "hosts" not in raw or not raw["hosts"]:
            raise ValueError("config missing required 'hosts' section")
        general = GeneralOptions.from_dict(dict(raw.pop("general")))
        network = NetworkOptions.from_dict(dict(raw.pop("network", {}) or {}))
        experimental = ExperimentalOptions.from_dict(dict(raw.pop("experimental", {}) or {}))
        chaos = ChaosOptions.from_dict(dict(raw.pop("chaos", {}) or {}))
        defaults = dict(raw.pop("host_option_defaults", {}) or {})
        hosts = [
            HostOptions.from_dict(name, dict(h or {}), defaults)
            for name, h in raw.pop("hosts").items()
        ]
        _reject_unknown("config", raw)
        if general.stop_time_ns <= 0:
            raise ValueError("general.stop_time must be > 0")
        return cls(general=general, network=network, experimental=experimental,
                   hosts=hosts, chaos=chaos)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _reject_unknown(section: str, leftover: dict) -> None:
    if leftover:
        raise ValueError(f"unknown key(s) in {section}: {sorted(leftover)}")


# Public face of the unknown-key discipline: every config section above
# AND every scripted model's args mapping (models/registry.py — the
# overlay pack's knobs like onion circuit length / cell size, CDN fan-in
# depth, gossip churn rate) reject typo'd keys through this one helper,
# so a misspelled knob is a one-line config error everywhere instead of
# a silently ignored default.
reject_unknown = _reject_unknown


def load_config_str(text: str) -> ConfigOptions:
    raw = yaml.safe_load(text)
    if not isinstance(raw, dict):
        raise ValueError("config YAML must be a mapping")
    return ConfigOptions.from_dict(raw)


def load_config_file(path: str) -> ConfigOptions:
    with open(path) as f:
        return load_config_str(f.read())
