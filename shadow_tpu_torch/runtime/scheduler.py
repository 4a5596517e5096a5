"""The Scheduler seam (port of shadow_tpu/runtime/scheduler.py, reduced
to the single-device device engine). The config value `scheduler: tpu`
names this engine, so the repo's YAML files run unchanged."""

from __future__ import annotations

from shadow_tpu_torch.engine.round import (
    bootstrap,
    effective_engine,
    model_pump_capable,
    run_until,
)
from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.engine.state import EngineConfig, init_state
from shadow_tpu_torch.graph.routing import RoutingTables


class TpuScheduler:
    """The device engine on one device (`cuda` unless asked for `cpu`)."""

    name = "tpu"

    def __init__(self, model, tables: RoutingTables, cfg: EngineConfig, *,
                 rounds_per_chunk: int = 256, tx_bytes_per_interval=None,
                 rx_bytes_per_interval=None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.tables = tables.to(self.device)
        self.cfg = cfg
        self.rounds_per_chunk = rounds_per_chunk
        self.tx_bytes_per_interval = tx_bytes_per_interval
        self.rx_bytes_per_interval = rx_bytes_per_interval
        # the engine run_round actually executes for this model here
        self.engine = (
            effective_engine(cfg, self.device) if model_pump_capable(model) else "plain"
        )

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
        rollback-and-regrow replays through at a regrown capacity."""

        def factory(cfg):
            def run(st, on_state=None):
                return run_until(
                    st, end_time_ns, self.model, self.tables, cfg,
                    rounds_per_chunk=self.rounds_per_chunk, max_chunks=max_chunks,
                    on_chunk=on_chunk, on_state=on_state,
                    tracker=tracker,
                )

            return run

        return factory

    def run(self, end_time_ns: int, on_chunk=None, max_chunks: int = 100_000,
            start_state=None, checkpoints=None, guard=None, recovery=None, tracker=None):
        """Run to end_time_ns. `start_state` (a restored checkpoint)
        replaces the bootstrapped t=0 state; `checkpoints`/`guard` tap
        chunk-boundary states (runtime/checkpoint.py); `recovery` (a
        RecoveryPolicy, None = fail-fast) turns a CapacityError into
        rollback-and-regrow. The recovery report of the last run is left
        on self.recovery_report (also when the run fails)."""
        from shadow_tpu_torch.runtime.recovery import RecoveryPolicy, run_until_recovering

        st = start_state if start_state is not None else self.initial_state()
        self.recovery_report = []
        factory = self._runner_factory(end_time_ns, on_chunk, max_chunks, tracker)
        try:
            if recovery is None and checkpoints is None and guard is None:
                # the plain path: no taps, no recovery wrapper
                return factory(self.cfg)(st)
            final, self.recovery_report = run_until_recovering(
                st, end_time_ns, cfg=self.cfg,
                policy=recovery or RecoveryPolicy(max_recoveries=0),
                checkpoints=checkpoints, guard=guard, tracker=tracker,
                runner_factory=factory,
            )
        except Exception as err:
            self.recovery_report = list(getattr(err, "recoveries", []))
            raise
        return final
