"""MeshRunner: the runtime face of the 2-D mesh plane (port of
shadow_tpu/runtime/mesh.py; engine/mesh.py).

A drop-in for EnsembleRunner on scripted runs with `general.mesh` set
(`--mesh RxS`): the same run() surface (start_state, checkpoints, guard,
recovery), so the Manager's run loop composes unchanged. What the mesh
adds:

  * the state is init_ensemble_state's [R, ...] stack laid out over a
    rows x shards grid of logical devices at dispatch, so checkpoints
    are ensemble checkpoints and portable across grids: the grid rides
    as layout metadata, and the config fingerprint hashes the replica
    count, not the grid (config/fingerprint.py);
  * device loss is a recovery rung: a DeviceLossError (the chaos plane's
    `device-loss` fault at a chunk launch, or a CUDA failure at a probe
    read) rolls back to the retained snapshot, _replan_device_loss
    degrades the grid onto the surviving logical devices
    (MeshPlan.degraded: R x S -> R x S/2 -> 1 x S -> one device), and
    the batch replays leaf-exact; `mesh_degradations` carries the
    reshape to sim-stats. On one card every logical device shares the
    card's fate: a real loss there takes them all, and only an injected
    loss names a device the others survive;
  * recovery regrows the whole batch (grow_mesh_state), and a
    (replica, shard) CapacityError names both coordinates;
  * the sweep and daemon services batch through this runner when their
    spec sets `mesh:`: the compile cache keys the prepared grid chunk
    under (fingerprint modulo seed, "mesh", rows, shards,
    rounds_per_chunk).
"""

from __future__ import annotations

from shadow_tpu_torch.device import resolve_device, visible_devices
from shadow_tpu_torch.engine.ensemble import grow_ensemble_state, replica_seeds
from shadow_tpu_torch.engine.mesh import (
    MeshPlan,
    init_mesh_state,
    lower_mesh_chunk,
    mesh_engine_cfg,
    run_mesh_until,
)
from shadow_tpu_torch.engine.round import effective_engine, model_pump_capable
from shadow_tpu_torch.engine.state import EngineConfig

# the regrow widens every replica's buffers together; the grid is
# re-applied by the next dispatch
grow_mesh_state = grow_ensemble_state


def _device_alive(device) -> bool:
    """Can this logical device still round-trip one value? A put and a
    fetch on its physical device: a card whose runtime failed fails
    either, a healthy one costs microseconds."""
    import torch

    try:
        out = torch.zeros((), dtype=torch.int32, device=device.physical)
        int(out.item())
        return True
    except Exception:  # noqa: BLE001 — any failure means "not usable"
        return False


class MeshRunner:
    name = "tpu-mesh"

    def __init__(
        self,
        model,
        tables,
        cfg: EngineConfig,
        plan: MeshPlan,
        seed_stride: int = 1,
        rounds_per_chunk: int = 256,
        tx_bytes_per_interval=None,
        rx_bytes_per_interval=None,
        compile_cache=None,
        cache_key=None,
        on_rows=None,
        watchdog_s: float = 0.0,
        device="cuda",
    ):
        if cfg.num_hosts % plan.shards:
            raise ValueError(
                f"num_hosts={cfg.num_hosts} must divide evenly over "
                f"{plan.shards} host-shard(s) (general.mesh)"
            )
        self.device = resolve_device(device)
        # resolved once, so the initial state, the cache key and every
        # recovery replay agree on the engine and the exchange
        self.cfg = mesh_engine_cfg(cfg)
        self.plan = plan
        self.model = model
        self.tables = tables.to(self.device)
        self.seed_stride = seed_stride
        self.rounds_per_chunk = rounds_per_chunk
        self.tx_bytes_per_interval = tx_bytes_per_interval
        self.rx_bytes_per_interval = rx_bytes_per_interval
        self.compile_cache = compile_cache
        self.cache_key = cache_key
        self.on_rows = on_rows
        self.watchdog_s = watchdog_s
        self.engine = (
            effective_engine(cfg, self.device) if model_pump_capable(model) else "plain"
        )
        self._mesh = None  # built lazily, reused across attempts
        # device-loss degradation history: one record per reshape
        # ({"grid_from", "grid_to", "devices", ...}), folded into
        # sim-stats' mesh section and the sweep's batch record
        self.mesh_degradations: "list[dict]" = []

    @property
    def num_replicas(self) -> int:
        return self.plan.replicas

    @property
    def seeds(self) -> "list[int]":
        return replica_seeds(self.cfg, self.plan.replicas, self.seed_stride)

    def _get_mesh(self):
        if self._mesh is None:
            self._mesh = self.plan.build_mesh(self._devices())
        return self._mesh

    def _devices(self):
        """The surviving logical devices: all visible ones minus those the
        degradation history marked lost. An injected loss names a device
        that is still there, so leaving it out is what makes the loss
        real to the grid. After a loss that named no device, every
        candidate must also pass _device_alive."""
        lost = {d["device"] for d in self.mesh_degradations if "device" in d}
        visible = visible_devices(self.device)
        devices = [d for d in visible if d.id not in lost]
        if any("device" not in d for d in self.mesh_degradations):
            devices = [d for d in devices if _device_alive(d)]
        return devices or visible  # never degrade to zero devices

    def _replan_device_loss(self, err) -> "dict | None":
        """The recovery loop's replan hook: install the next rung that
        fits the surviving devices (the factory reads self.plan and
        self._mesh at dispatch, so the next attempt runs degraded) and
        return the reshape record; None when no rung is left."""
        lost = getattr(err, "device_id", None)
        record = {"grid_from": f"{self.plan.rows}x{self.plan.shards}"}
        if lost is not None:
            record["device"] = int(lost)
            known = {d["device"] for d in self.mesh_degradations if "device" in d}
            survivors = len(self._devices()) - (1 if lost not in known else 0)
        else:
            # a loss that names no device: probe this loss's survivors now
            survivors = sum(1 for d in self._devices() if _device_alive(d))
        plan = self.plan.degraded(max(survivors, 1), self.cfg.num_hosts)
        if plan is None:
            return None
        self.mesh_degradations.append(record)
        self.plan = plan
        self._mesh = None  # rebuilt against the surviving devices
        record["grid_to"] = f"{plan.rows}x{plan.shards}"
        record["devices"] = plan.devices_needed
        return record

    def initial_state(self, cfg: "EngineConfig | None" = None):
        """The bootstrapped [R, ...] t=0 stack, also the template a resume
        loads a checkpoint into (an ensemble template: the grid is
        applied at dispatch)."""
        return init_mesh_state(
            cfg or self.cfg, self.model, self.plan, self.seed_stride,
            tx_bytes_per_interval=self.tx_bytes_per_interval,
            rx_bytes_per_interval=self.rx_bytes_per_interval,
            device=self.device,
        )

    def _launch_for(self, st, end_time_ns: int, cfg):
        """The compile-cache lookup: the prepared grid chunk for this
        (fingerprint-modulo-seed key, grid shape, state shapes, static
        cfg), or None for the chunk run_mesh_until builds itself."""
        if self.compile_cache is None:
            return None
        from shadow_tpu_torch.engine.state import trace_static_cfg
        from shadow_tpu_torch.runtime import chaos

        static_cfg = trace_static_cfg(mesh_engine_cfg(cfg))
        eng = effective_engine(static_cfg, self.device)
        with chaos.compile_seam(eng):
            return self.compile_cache.get(
                (self.cache_key, "mesh", self.plan.rows, self.plan.shards,
                 self.rounds_per_chunk),
                st,
                static_cfg,
                lambda: lower_mesh_chunk(
                    st, end_time_ns, self.rounds_per_chunk, self.model, self.tables, cfg,
                    self.plan, mesh=self._get_mesh(),
                ),
            )

    def _runner_factory(self, end_time_ns: int, on_chunk, max_chunks, tracker=None):
        def factory(cfg):
            def run(st, on_state=None):
                return run_mesh_until(
                    st, end_time_ns, self.model, self.tables, cfg, self.plan,
                    rounds_per_chunk=self.rounds_per_chunk, max_chunks=max_chunks,
                    on_chunk=on_chunk, tracker=tracker, on_state=on_state,
                    on_rows=self.on_rows, launch=self._launch_for(st, end_time_ns, cfg),
                    watchdog_s=self.watchdog_s, mesh=self._get_mesh(),
                )

            return run

        return factory

    def run(self, end_time_ns: int, on_chunk=None, max_chunks: int = 100_000,
            start_state=None, checkpoints=None, guard=None, recovery=None, tracker=None):
        """Run the whole mesh batch to end_time_ns: EnsembleRunner.run with
        the chunks on the grid and the device-loss rung armed."""
        from shadow_tpu_torch.runtime.scheduler import _run_guarded

        return _run_guarded(self, end_time_ns, on_chunk, max_chunks, start_state, checkpoints,
                            guard, recovery, tracker, grow_fn=grow_mesh_state,
                            replan_fn=self._replan_device_loss)
