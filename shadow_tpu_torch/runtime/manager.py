"""Manager: build the simulated world from config and run it (port of
shadow_tpu/runtime/manager.py, reduced to scripted single-device runs,
one world or an ensemble of seeded replicas).

Resolve the graph, expand host specs, assign IPs, map hosts to graph
nodes, build the model, run the device engine with heartbeats, and write
`sim-stats.json`, the processed config and the hosts file into the data
directory. Features of the reference that the port does not carry yet
raise NotYetPorted while the world is validated, before anything runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np

from shadow_tpu_torch.config import ConfigOptions
from shadow_tpu_torch.config.options import NotYetPorted
from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.graph import IpAssignment, NetworkGraph, compute_routing
from shadow_tpu_torch.graph.network_graph import ONE_GBIT_SWITCH_GML
from shadow_tpu_torch.models.registry import _NOT_YET_PORTED, _REGISTRY, build_model
from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill
from shadow_tpu_torch.runtime.scheduler import TpuScheduler
from shadow_tpu_torch.simtime import NS_PER_SEC, fmt_time_ns
from shadow_tpu_torch.utils.shadow_log import slog


@dataclasses.dataclass
class HostInstance:
    """One expanded simulated host."""

    index: int
    name: str
    node_index: int
    ip: int
    model_name: str
    bw_up_bits: int = -1
    bw_down_bits: int = -1
    spec: object = None


@dataclasses.dataclass
class ScriptedWorld:
    model: object
    tables: object
    ecfg: EngineConfig
    tx_refill: "object | None"
    rx_refill: "object | None"
    host_node: "list[int]"
    runahead_ns: int


@dataclasses.dataclass
class SimResults:
    hosts: "list[HostInstance]"
    events_handled: int
    packets_sent: int
    packets_dropped: int
    packets_unroutable: int
    wall_seconds: float
    sim_seconds: float
    scheduler: str
    unexpected_final_states: "list[str]" = dataclasses.field(default_factory=list)
    extra_stats: dict = dataclasses.field(default_factory=dict)

    @property
    def sim_sec_per_wall_sec(self) -> float:
        return self.sim_seconds / self.wall_seconds if self.wall_seconds > 0 else float("inf")


def _reject_ensemble(config: ConfigOptions) -> None:
    """The reference's refusals of an ensemble (general.replicas > 1),
    with its messages; a 2-D mesh stays NotYetPorted (_reject_unported)."""
    g = config.general
    if g.replicas <= 1 or g.mesh:
        return
    if config.experimental.scheduler != "tpu":
        raise ValueError(
            "general.replicas > 1 requires experimental.scheduler: "
            "tpu (the ensemble plane vmaps the device engine)"
        )
    if g.parallelism > 1:
        raise ValueError(
            "general.replicas > 1 runs on a single device (the "
            "replica axis is vmapped); it does not compose with "
            "general.parallelism > 1 host sharding yet — drop one "
            "of the two (docs/ensemble.md)"
        )


def _reject_unported(config: ConfigOptions) -> None:
    """Config-time refusal of everything outside the port's slices."""
    g, e = config.general, config.experimental
    checks = [
        (bool(g.mesh), "general.mesh (the 2-D mesh plane)"),
        (g.parallelism > 1, "general.parallelism > 1 (multi-device sharding)"),
        (e.autotune, "experimental.autotune"),
        (e.scheduler != "tpu", f"scheduler {e.scheduler!r}"),
        (e.chunk_watchdog_s > 0, "the chunk watchdog"),
    ]
    for bad, what in checks:
        if bad:
            raise NotYetPorted(what)


class Manager:
    def __init__(self, config: ConfigOptions, device="cuda"):
        self.config = config
        _reject_ensemble(config)
        _reject_unported(config)
        self.device = resolve_device(device)
        self.graph = self._load_graph()
        self.hosts = self._expand_hosts()
        if config.general.replicas > 1 and any(
            p.path not in _REGISTRY for h in self.hosts for p in h.spec.processes
        ):
            raise ValueError(
                "general.replicas > 1 supports scripted-model runs "
                "only; managed guests are live OS processes and cannot "
                "be replicated on device (docs/ensemble.md)"
            )
        self._validate_process_specs()
        self.ip = IpAssignment()
        for h in self.hosts:
            if h.ip >= 0:
                self.ip.assign_explicit(h.index, h.ip)
        for h in self.hosts:
            if h.ip < 0:
                h.ip = self.ip.assign_auto(h.index)

    def _validate_process_specs(self) -> None:
        for h in self.hosts:
            for p in h.spec.processes:
                if p.path in _NOT_YET_PORTED:
                    raise NotYetPorted(f"model {p.path!r}")
                if p.path not in _REGISTRY:
                    raise NotYetPorted(
                        f"hosts.{h.name}: process {p.path!r} (managed processes)"
                    )
            if len(h.spec.processes) != 1:
                raise ValueError(
                    f"hosts.{h.name}: scripted-model hosts take exactly one process"
                )
            if not isinstance(h.spec.processes[0].args, dict):
                raise ValueError(
                    f"hosts.{h.name}: scripted model {h.model_name!r} takes args "
                    f"as a mapping, not a string or list"
                )

    def _load_graph(self) -> NetworkGraph:
        g = self.config.network.graph
        if g.kind == "1_gbit_switch":
            return NetworkGraph.from_gml(ONE_GBIT_SWITCH_GML)
        if g.inline is not None:
            return NetworkGraph.from_gml(g.inline)
        return NetworkGraph.from_file(g.path)

    def _expand_hosts(self) -> "list[HostInstance]":
        import ipaddress

        out = []
        for spec in self.config.hosts:
            if spec.network_node_id not in self.graph.id_to_index:
                raise ValueError(
                    f"hosts.{spec.name}: network_node_id {spec.network_node_id} not in graph"
                )
            if not spec.processes:
                raise ValueError(f"hosts.{spec.name}: at least one process is required")
            for i in range(spec.quantity):
                name = spec.name if spec.quantity == 1 else f"{spec.name}{i + 1}"
                ip = -1
                if spec.ip_addr is not None:
                    if spec.quantity != 1:
                        raise ValueError(f"hosts.{spec.name}: ip_addr with quantity > 1")
                    ip = int(ipaddress.IPv4Address(spec.ip_addr))
                node_index = self.graph.id_to_index[spec.network_node_id]
                bw_up = spec.bandwidth_up_bits
                if bw_up is None:
                    bw_up = int(self.graph.bw_up_bits[node_index])
                bw_down = spec.bandwidth_down_bits
                if bw_down is None:
                    bw_down = int(self.graph.bw_down_bits[node_index])
                out.append(
                    HostInstance(
                        index=len(out), name=name, node_index=node_index, ip=ip,
                        model_name=spec.processes[0].path, bw_up_bits=bw_up,
                        bw_down_bits=bw_down, spec=spec,
                    )
                )
        return out

    def build_world(self) -> ScriptedWorld:
        """Validate the model specs, compute routing, resolve the runahead
        window and shaping refills, and assemble the EngineConfig."""
        cfgo = self.config
        num_hosts = len(self.hosts)
        model_names = {h.model_name for h in self.hosts}
        if len(model_names) != 1:
            raise ValueError(
                f"all hosts must run the same model currently, got {sorted(model_names)}"
            )
        arg_sets = {json.dumps(spec.processes[0].args, sort_keys=True) for spec in cfgo.hosts}
        if len(arg_sets) != 1:
            raise ValueError(
                "all hosts must run the model with identical args currently, got "
                f"{sorted(arg_sets)}"
            )
        model = build_model(model_names.pop(), num_hosts, cfgo.hosts[0].processes[0].args)
        host_node = [h.node_index for h in self.hosts]
        tables = compute_routing(
            self.graph, use_shortest_path=cfgo.network.use_shortest_path, device=self.device
        ).with_hosts(host_node)
        runahead = cfgo.experimental.runahead_ns
        if runahead is None:
            runahead = min(self.graph.min_latency_ns(), tables.min_path_latency_ns())

        bw_up = np.array([max(h.bw_up_bits, 0) for h in self.hosts], dtype=np.int64)
        bw_down = np.array([max(h.bw_down_bits, 0) for h in self.hosts], dtype=np.int64)
        use_netstack = bool((bw_up > 0).any() or (bw_down > 0).any())
        tx_refill = bw_bits_per_sec_to_refill(bw_up) if use_netstack else None
        rx_refill = bw_bits_per_sec_to_refill(bw_down) if use_netstack else None

        ecfg = EngineConfig(
            num_hosts=num_hosts,
            queue_capacity=cfgo.experimental.queue_capacity,
            outbox_capacity=cfgo.experimental.outbox_capacity,
            runahead_ns=runahead,
            seed=cfgo.general.seed,
            max_iters_per_round=cfgo.experimental.max_iters_per_round,
            use_netstack=use_netstack,
            bootstrap_end_ns=cfgo.general.bootstrap_end_time_ns,
            use_dynamic_runahead=cfgo.experimental.use_dynamic_runahead,
            adaptive_window=cfgo.experimental.adaptive_window,
            active_lanes=cfgo.experimental.active_lanes,
            engine=cfgo.experimental.engine,
            pump_k=cfgo.experimental.pump_k,
            tracker=cfgo.general.tracker,
        )
        return ScriptedWorld(
            model=model, tables=tables, ecfg=ecfg, tx_refill=tx_refill,
            rx_refill=rx_refill, host_node=host_node, runahead_ns=runahead,
        )

    def _setup_checkpointing(self, ecfg: EngineConfig):
        """Build the checkpoint manager and interrupt guard when
        general.checkpoint_dir asks for them, and resolve a --resume to
        the newest checkpoint. Resume validates the config fingerprint
        and rebuilds the engine config at the checkpoint's recorded
        buffer capacities, which may exceed the config values when the
        interrupted run had already regrown them. Returns (ecfg,
        ckpt_manager, guard, resume_path)."""
        from shadow_tpu_torch.config.fingerprint import fingerprint_dict
        from shadow_tpu_torch.runtime.checkpoint import (
            CheckpointError,
            CheckpointManager,
            InterruptGuard,
            config_fingerprint,
            peek_checkpoint_meta,
        )

        g = self.config.general
        if not g.checkpoint_dir:
            if g.resume:
                raise CheckpointError(
                    "--resume requires --checkpoint-dir (general.checkpoint_dir)"
                )
            return ecfg, None, None, None
        fingerprint = config_fingerprint(self.config)
        resume_path = None
        if g.resume:
            resume_path = CheckpointManager.latest_path(g.checkpoint_dir)
            if resume_path is None:
                raise CheckpointError(
                    f"--resume: no checkpoint found in {g.checkpoint_dir}"
                )
            meta = peek_checkpoint_meta(resume_path)
            # rebuild at the checkpoint's recorded widths: the interrupted
            # run may have regrown them past the config values, and the
            # grid knobs grown alongside must follow or the resumed replay
            # re-hits the very overflow that was recovered
            overrides = {}
            qc, oc = meta.get("queue_capacity"), meta.get("outbox_capacity")
            if qc and oc:
                overrides.update(queue_capacity=qc, outbox_capacity=oc)
            for knob in ("deliver_lanes", "a2a_capacity", "pool_capacity"):
                if knob in meta:
                    overrides[knob] = meta[knob]
            if any(overrides.get(k) != getattr(ecfg, k) for k in overrides):
                ecfg = dataclasses.replace(ecfg, **overrides)
        ckpt = CheckpointManager(
            g.checkpoint_dir, g.checkpoint_interval_ns, fingerprint,
            detail=fingerprint_dict(self.config),
        )
        return ecfg, ckpt, InterruptGuard(), resume_path

    def run(self) -> SimResults:
        from shadow_tpu_torch.runtime import flightrec

        try:
            return self._run()
        finally:
            # belt-and-braces: _run uninstalls the flight recorder, but an
            # exception between its install and the run (a world
            # construction error) must never leak a recorder into the
            # next run of this process
            flightrec.uninstall()

    def _run(self) -> SimResults:
        from shadow_tpu_torch.engine.megakernel import PUMP_KERNEL
        from shadow_tpu_torch.engine.round import RunInterrupted
        from shadow_tpu_torch.runtime import flightrec
        from shadow_tpu_torch.utils.progress import ProgressLine

        cfgo = self.config
        world = self.build_world()
        ecfg, ckpt, guard, resume_path = self._setup_checkpointing(world.ecfg)
        replicas = cfgo.general.replicas
        progress = ProgressLine(cfgo.general.progress)
        tracker = self._build_tracker(progress)
        # the flight recorder is always on: the bounded ring costs nothing
        # per chunk (it reads the probe the chunk loop already read), and
        # the black box must exist on every failure path, not only when
        # --metrics-file was passed
        recorder = self._build_recorder(tracker)
        flightrec.install(recorder)
        common = dict(
            rounds_per_chunk=cfgo.experimental.rounds_per_chunk,
            tx_bytes_per_interval=world.tx_refill,
            rx_bytes_per_interval=world.rx_refill,
            device=self.device,
        )
        if replicas > 1:
            # the ensemble plane: R seeded replicas as one batch
            from shadow_tpu_torch.runtime.ensemble import EnsembleRunner

            sched = EnsembleRunner(
                world.model, world.tables, ecfg, replicas,
                seed_stride=cfgo.general.replica_seed_stride, **common,
            )
        else:
            sched = TpuScheduler(world.model, world.tables, ecfg, **common)
        end = cfgo.general.stop_time_ns
        hb_ns = cfgo.general.heartbeat_interval_ns
        last_hb = [0]
        # occupancy denominator, set before the run so heartbeat lines and
        # mid-run metrics divide correctly: an ensemble's iteration count
        # sums R drain loops of H lanes each
        num_shards = replicas if replicas > 1 else 1
        if tracker is not None:
            tracker.num_shards = num_shards
        recorder.num_shards = num_shards

        def on_chunk(probe):
            progress.update(probe.now, end, events=probe.events_handled)
            if tracker is not None:
                tracker.record_probe(probe)
            if hb_ns > 0 and probe.now - last_hb[0] >= hb_ns:
                last_hb[0] = probe.now
                progress.clear()
                extra = ""
                if tracker is not None:
                    # the probe's tracker lanes: aggregate drop detail on
                    # the manager heartbeat, still sync-free
                    extra = (
                        f", drops loss={probe.drop_loss} "
                        f"codel={probe.drop_codel} "
                        f"unroutable={probe.drop_unroutable}"
                    )
                slog(
                    "info", probe.now, "manager",
                    f"heartbeat: {probe.events_handled} events, "
                    f"{probe.packets_sent} packets, sim time "
                    f"{fmt_time_ns(probe.now)}{extra}",
                )

        rep_note = f"{replicas} replicas, " if replicas > 1 else ""
        slog("info", 0, "manager",
             f"starting: {len(self.hosts)} hosts, {rep_note}scheduler={sched.name}, "
             f"engine={sched.engine}, device={self.device}, "
             f"runahead={world.runahead_ns}ns, stop={fmt_time_ns(end)}")
        launches0 = PUMP_KERNEL.launches
        t0 = time.perf_counter()
        try:
            resume_state = None
            if resume_path is not None:
                from shadow_tpu_torch.runtime.checkpoint import load_checkpoint

                # resume_path came from latest_path, which verified the
                # sha-256 digest moments ago: skip the second full hash
                resume_state, meta = load_checkpoint(
                    resume_path, sched.initial_state(), ckpt.fingerprint,
                    check_digest=False, detail=ckpt.detail,
                )
                slog("info", meta["now_ns"], "manager",
                     f"resuming from checkpoint {resume_path} "
                     f"(sim time {fmt_time_ns(meta['now_ns'])})")
            recovery = None
            if cfgo.experimental.recover:
                from shadow_tpu_torch.runtime.recovery import RecoveryPolicy

                recovery = RecoveryPolicy(
                    max_recoveries=cfgo.experimental.recovery_max_retries,
                    snapshot_interval_chunks=cfgo.experimental.recovery_snapshot_chunks,
                )
            try:
                with guard if guard is not None else contextlib.nullcontext():
                    final = sched.run(
                        end, on_chunk=on_chunk, start_state=resume_state,
                        checkpoints=ckpt, guard=guard, recovery=recovery,
                        tracker=tracker,
                    )
            except RunInterrupted:
                progress.clear()
                slog("info", 0, "manager",
                     f"interrupted; checkpoints are in {cfgo.general.checkpoint_dir} — "
                     "rerun with --resume to continue to a bit-identical final state")
                raise
            if self.device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.device)
        except RunInterrupted:
            raise  # not a failure: a final checkpoint was committed
        except Exception as err:
            # the black box on every failure path, plain exceptions
            # included: the ring already holds the failing chunk's sample
            recorder.dump(failure=flightrec.failure_record(err))
            raise
        finally:
            recorder.close()
            flightrec.uninstall()
        wall = time.perf_counter() - t0
        progress.finish(end)

        results = SimResults(
            hosts=self.hosts,
            events_handled=int(final.events_handled.sum()),
            packets_sent=int(final.packets_sent.sum()),
            packets_dropped=int(final.packets_dropped.sum()),
            packets_unroutable=int(final.packets_unroutable.sum()),
            wall_seconds=wall,
            sim_seconds=end / NS_PER_SEC,
            scheduler=sched.name,
        )
        report = getattr(sched, "recovery_report", [])
        if report:
            # rollback-and-regrow happened: surface it in sim-stats.json
            results.extra_stats["recovery"] = {"count": len(report), "events": report}
        host_tensors = None
        if replicas > 1:
            # per-replica sections and the aggregate mean/stddev/CI block,
            # folded from one bulk host_stats fetch shared with the
            # tracker fold below
            from shadow_tpu_torch.engine.round import host_stats
            from shadow_tpu_torch.runtime.ensemble import ensemble_stats

            host_tensors = host_stats(final)
            results.extra_stats["ensemble"] = ensemble_stats(
                final, sched.seeds, wall, end / NS_PER_SEC,
                seed_stride=cfgo.general.replica_seed_stride,
                host_tensors=host_tensors,
            )
        # the memory observatory: the final state prices the run's device
        # footprint (after any regrow), with the allocator's numbers on
        # the card. Best-effort: sim-stats never fails over telemetry.
        try:
            from shadow_tpu_torch.runtime import memtrack

            results.extra_stats["memory"] = memtrack.memory_section(final, ecfg)
        except Exception:  # noqa: BLE001
            pass
        if recorder.metrics_path or recorder.prom_path:
            # a metrics-streamed run names its outputs in sim-stats
            results.extra_stats["metrics"] = {
                "samples": len(recorder.samples),
                "events": len(recorder.events),
                **({"file": recorder.metrics_path} if recorder.metrics_path else {}),
                **({"prom": recorder.prom_path} if recorder.prom_path else {}),
            }
        self._fold_tracker(tracker, results, end, final, host_tensors)
        # how the trajectory was executed (like `memory`, not the trajectory)
        results.extra_stats["execution"] = {
            "package": "shadow_tpu_torch",
            "device": str(self.device),
            "engine": sched.engine,
            "kernel_launches": {"pump_megakernel": PUMP_KERNEL.launches - launches0},
        }
        slog("info", end, "manager",
             f"finished: {results.events_handled} events in {wall:.2f}s wall "
             f"({results.sim_sec_per_wall_sec:.2f} sim-s/wall-s)")
        self._write_outputs(results)
        return results

    def _fold_tracker(self, tracker, results, end, final_state, host_tensors=None):
        """Fold the tracker registry into sim-stats' `tracker` section and
        write the dispatch trace. With the device counters on, this is
        the run's one bulk per-host fetch (heartbeats fetch only at their
        cadence); `host_tensors` passes the ensemble fold's fetch, so the
        run never pays it twice. A span-only tracker (--trace-file
        without --tracker) publishes phases only."""
        if tracker is None:
            return
        if tracker.counters:
            from shadow_tpu_torch.engine.round import host_stats

            hs = host_tensors if host_tensors is not None else host_stats(final_state)
            if self.config.general.replicas > 1:
                # an ensemble's [R, H] tensors, flattened for the fold
                # (exact per-replica splits are in the `ensemble` block)
                from shadow_tpu_torch.runtime.ensemble import flatten_host_stats

                hs = flatten_host_stats(hs)
            tracker.finalize(hs)
        results.extra_stats["tracker"] = tracker.stats_dict()
        trace_path = tracker.write_trace()
        if trace_path:
            slog("info", end, "manager", f"wrote dispatch trace: {trace_path}")

    def _build_tracker(self, progress=None):
        """The host-side tracker registry (utils/tracker.py), or None when
        neither general.tracker nor general.trace_file asks for it.
        trace_file alone records dispatch spans; per-host heartbeats and
        the sim-stats fold need the device counters (general.tracker)."""
        g = self.config.general
        if not (g.tracker or g.trace_file):
            return None
        from shadow_tpu_torch.utils.tracker import Tracker

        return Tracker(
            host_names=[h.name for h in self.hosts],
            heartbeat_ns=g.heartbeat_interval_ns if g.tracker else 0,
            trace_path=g.trace_file,
            clear_line=progress.clear if progress is not None else None,
            # per-host heartbeat lines name one host per row; an
            # ensemble's per-host tensors are [R, H], so heartbeats stay
            # off there (aggregates still ride the probe)
            host_heartbeats=g.tracker and g.replicas <= 1,
            counters=g.tracker,
        )

    def _build_recorder(self, tracker=None):
        """The flight recorder (runtime/flightrec.py): always built — the
        bounded ring is free and the black-box dump must exist on every
        failure path — with the streaming, scrape and profiler outputs
        wired only when the config asks for them (--metrics-file,
        --metrics-prom, --xprof-dir)."""
        from shadow_tpu_torch.runtime.flightrec import FlightRecorder

        g = self.config.general
        e = self.config.experimental
        blackbox = (
            os.path.join(g.data_directory, "flight-recorder.json")
            if g.data_directory
            else None
        )
        xprof_chunks = None
        if e.xprof_chunks:
            a, _, b = e.xprof_chunks.partition(":")
            xprof_chunks = (int(a), int(b))
        return FlightRecorder(
            num_hosts=len(self.hosts),
            metrics_path=g.metrics_file,
            metrics_max_bytes=int(g.metrics_max_mb * 1_000_000),
            metrics_keep=g.metrics_keep,
            prom_path=g.metrics_prom,
            blackbox_path=blackbox,
            heartbeat_ns=g.heartbeat_interval_ns,
            config_dict=self.config.to_dict(),
            tracker=tracker,
            xprof_dir=e.xprof_dir,
            xprof_chunks=xprof_chunks,
            device=self.device,
        )

    def _write_outputs(self, results: SimResults) -> None:
        data_dir = self.config.general.data_directory
        os.makedirs(data_dir, exist_ok=True)
        with open(os.path.join(data_dir, "sim-stats.json"), "w") as f:
            json.dump(
                {
                    "events_handled": results.events_handled,
                    "packets_sent": results.packets_sent,
                    "packets_dropped": results.packets_dropped,
                    "packets_unroutable": results.packets_unroutable,
                    "wall_seconds": results.wall_seconds,
                    "sim_seconds": results.sim_seconds,
                    "scheduler": results.scheduler,
                    "num_hosts": len(results.hosts),
                    "unexpected_final_states": results.unexpected_final_states,
                    **results.extra_stats,
                },
                f,
                indent=2,
            )
        with open(os.path.join(data_dir, "processed-config.json"), "w") as f:
            json.dump(self.config.to_dict(), f, indent=2, default=str)
        with open(os.path.join(data_dir, "hosts"), "w") as f:
            for h in self.hosts:
                f.write(f"{self.ip.ip_str(h.index)} {h.name}\n")
