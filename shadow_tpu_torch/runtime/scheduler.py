"""The Scheduler seam (port of shadow_tpu/runtime/scheduler.py): which
engine steps the simulation.

  * TpuScheduler — the device engine: on one device, or with the hosts
    block-sharded over the visible logical devices (device.py) by
    engine/sharded.py ShardedRunner. The config value `scheduler: tpu`
    names it, so the repo's YAML files run unchanged.
  * CpuRefScheduler — the pure-Python conformance oracle (cpu_ref/;
    slow, and independent of the engine's code, so device results can be
    diffed against it).
"""

from __future__ import annotations

from shadow_tpu_torch.device import resolve_device, visible_devices
from shadow_tpu_torch.engine.round import (
    bootstrap,
    effective_engine,
    model_pump_capable,
    run_until,
)
from shadow_tpu_torch.engine.sharded import ShardedRunner
from shadow_tpu_torch.engine.state import EngineConfig, init_state
from shadow_tpu_torch.graph.routing import RoutingTables


class TpuScheduler:
    """The device engine (`cuda` unless asked for `cpu`): on one device,
    or over `parallelism` logical devices (0: all visible), as the
    reference shards over its jax devices. The count shrinks to the
    largest one that divides the hosts; with one device visible (no
    SHADOW_TPU_TORCH_LOGICAL_DEVICES) every run is a single-device run.
    The shards run the engine the single-device run would: the pump
    kernel on the card, on each shard's rows."""

    name = "tpu"

    def __init__(self, model, tables: RoutingTables, cfg: EngineConfig, *, parallelism: int = 0,
                 rounds_per_chunk: int = 256, tx_bytes_per_interval=None,
                 rx_bytes_per_interval=None, watchdog_s: float = 0.0, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.tables = tables.to(self.device)
        self.cfg = cfg
        self.rounds_per_chunk = rounds_per_chunk
        self.tx_bytes_per_interval = tx_bytes_per_interval
        self.rx_bytes_per_interval = rx_bytes_per_interval
        self.watchdog_s = watchdog_s
        devices = visible_devices(self.device)
        n = parallelism if parallelism > 0 else len(devices)
        n = min(n, len(devices))
        # shard only when it divides evenly; otherwise fewer devices
        while n > 1 and cfg.num_hosts % n != 0:
            n -= 1
        self.num_devices = n
        self.devices = devices[:n]
        # the engine run_round actually executes for this model here
        self.engine = (
            effective_engine(cfg, self.device) if model_pump_capable(model) else "plain"
        )
        self._runner = None
        if n > 1:
            self._runner = ShardedRunner(self.devices, model, self.tables, cfg, rounds_per_chunk)

    def initial_state(self):
        """The bootstrapped t=0 state: also the template a resume loads a
        checkpoint into (same config, same shapes)."""
        st = init_state(
            self.cfg,
            self.model.init(self.device),
            tx_bytes_per_interval=self.tx_bytes_per_interval,
            rx_bytes_per_interval=self.rx_bytes_per_interval,
            device=self.device,
        )
        return bootstrap(st, self.model, self.cfg)

    def _runner_factory(self, end_time_ns: int, on_chunk, max_chunks, tracker=None):
        """run(st, on_state=...) per engine config: the seam
        rollback-and-regrow replays through at a regrown capacity, and the
        fallback ladder at a lower engine."""

        def factory(cfg):
            if self._runner is not None:
                # the config as given reuses the runner built for it; a
                # regrown or lower-rung config gets its own
                runner = self._runner if cfg == self.cfg else ShardedRunner(
                    self.devices, self.model, self.tables, cfg, self.rounds_per_chunk)

                def run(st, on_state=None):
                    return runner.run_until(
                        st, end_time_ns, max_chunks=max_chunks, on_chunk=on_chunk,
                        tracker=tracker, on_state=on_state, watchdog_s=self.watchdog_s,
                    )

                return run

            def run(st, on_state=None):
                return run_until(
                    st, end_time_ns, self.model, self.tables, cfg,
                    rounds_per_chunk=self.rounds_per_chunk, max_chunks=max_chunks,
                    on_chunk=on_chunk, on_state=on_state,
                    tracker=tracker, watchdog_s=self.watchdog_s,
                )

            return run

        return factory

    def run(self, end_time_ns: int, on_chunk=None, max_chunks: int = 100_000,
            start_state=None, checkpoints=None, guard=None, recovery=None, tracker=None):
        """Run to end_time_ns. `start_state` (a restored checkpoint)
        replaces the bootstrapped t=0 state; `checkpoints`/`guard` tap
        chunk-boundary states (runtime/checkpoint.py); `recovery` (a
        RecoveryPolicy, None = fail-fast) turns a CapacityError or a
        WatchdogExpired into a rollback and replay. An injected compile
        fault walks the fallback ladder (megakernel -> pump -> plain,
        bit-identical results; runtime/chaos.py). The fallback records of
        the last run are left on self.engine_fallbacks and its recovery
        report on self.recovery_report (also when the run fails)."""
        return _run_guarded(self, end_time_ns, on_chunk, max_chunks, start_state, checkpoints,
                            guard, recovery, tracker)


def _run_guarded(sched, end_time_ns, on_chunk, max_chunks, start_state, checkpoints, guard,
                 recovery, tracker, grow_fn=None, replan_fn=None):
    """TpuScheduler.run, EnsembleRunner.run and MeshRunner.run: the
    recovery loop inside the engine fallback ladder."""
    from shadow_tpu_torch.runtime.chaos import run_with_engine_ladder
    from shadow_tpu_torch.runtime.recovery import RecoveryPolicy, run_until_recovering

    st = start_state if start_state is not None else sched.initial_state()
    sched.recovery_report = []
    factory = sched._runner_factory(end_time_ns, on_chunk, max_chunks, tracker)

    def attempt(cfg):
        if recovery is None and checkpoints is None and guard is None:
            # the plain path: no taps, no recovery wrapper
            return factory(cfg)(st), []
        return run_until_recovering(
            st, end_time_ns, cfg=cfg,
            policy=recovery or RecoveryPolicy(max_recoveries=0),
            checkpoints=checkpoints, guard=guard, tracker=tracker,
            runner_factory=factory, grow_fn=grow_fn, replan_fn=replan_fn,
        )

    sched.engine_fallbacks = []
    try:
        (final, report), _ = run_with_engine_ladder(
            sched.cfg, attempt, on_fallback=sched.engine_fallbacks.append,
            device=sched.device,
        )
    except Exception as err:
        # keep the partial degradation record on failure: recoveries ride
        # the terminal exception, fallbacks accumulated through on_fallback
        sched.recovery_report = list(getattr(err, "recoveries", []))
        raise
    sched.recovery_report = report
    return final


class CpuRefScheduler:
    """The scalar oracle (cpu_ref/) for phold, bulk-tcp and tgen. It runs
    in Python on the host: the tables are read to numpy and its draws
    come from rng on CPU tensors."""

    name = "cpu-ref"

    def __init__(self, model, tables: RoutingTables, cfg: EngineConfig, host_node,
                 tx_bytes_per_interval=None, rx_bytes_per_interval=None, **_):
        from shadow_tpu_torch.cpu_ref import CpuRefBulk, CpuRefPhold, CpuRefTgen
        from shadow_tpu_torch.models.bulk import BulkTcpModel
        from shadow_tpu_torch.models.phold import PholdModel
        from shadow_tpu_torch.models.tgen import TgenModel

        if isinstance(model, PholdModel):
            ref_cls = CpuRefPhold
        elif isinstance(model, BulkTcpModel):
            ref_cls = CpuRefBulk
        elif isinstance(model, TgenModel):
            ref_cls = CpuRefTgen
        else:
            raise ValueError(
                "cpu-ref scheduler supports the phold, bulk-tcp, and tgen models"
            )
        self.ref = ref_cls(cfg, model, tables, host_node,
                           tx_bytes_per_interval=tx_bytes_per_interval,
                           rx_bytes_per_interval=rx_bytes_per_interval)

    def run(self, end_time_ns: int, on_chunk=None, max_chunks: int = 100_000,
            tracker=None):
        # the oracle has no chunk loop: tracker spans and device counters
        # do not apply here
        self.ref.bootstrap()
        self.ref.run_until(end_time_ns)
        return self.ref


def make_scheduler(name: str, model, tables, cfg, host_node, parallelism=0,
                   rounds_per_chunk=256, tx_bytes_per_interval=None,
                   rx_bytes_per_interval=None, watchdog_s=0.0, device="cuda"):
    if name == "tpu":
        return TpuScheduler(model, tables, cfg, parallelism=parallelism,
                            rounds_per_chunk=rounds_per_chunk,
                            tx_bytes_per_interval=tx_bytes_per_interval,
                            rx_bytes_per_interval=rx_bytes_per_interval,
                            watchdog_s=watchdog_s, device=device)
    if name == "cpu-ref":
        return CpuRefScheduler(model, tables, cfg, host_node,
                               tx_bytes_per_interval=tx_bytes_per_interval,
                               rx_bytes_per_interval=rx_bytes_per_interval)
    raise ValueError(f"unknown scheduler {name!r}")
