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
        """The bootstrapped t=0 state."""
        st = init_state(
            self.cfg,
            self.model.init(self.device),
            tx_bytes_per_interval=self.tx_bytes_per_interval,
            rx_bytes_per_interval=self.rx_bytes_per_interval,
            device=self.device,
        )
        return bootstrap(st, self.model, self.cfg)

    def run(self, end_time_ns: int, on_chunk=None, max_chunks: int = 100_000):
        return run_until(
            self.initial_state(), end_time_ns, self.model, self.tables, self.cfg,
            rounds_per_chunk=self.rounds_per_chunk, max_chunks=max_chunks,
            on_chunk=on_chunk,
        )
