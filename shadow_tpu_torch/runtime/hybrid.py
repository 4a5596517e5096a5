"""The hybrid scheduler: managed processes on the CPU kernel, their
packets on the device engine (port of shadow_tpu/runtime/hybrid.py).

This is the coupling the whole design aims at (reference: the one round
loop that serves real processes, src/main/core/manager.rs:392-478): the
serial host kernel executes guests window by window; every non-loopback
packet they emit is staged into the device engine, which applies egress
token-bucket shaping, the path loss draw, routing latency, and ingress
token-bucket + CoDel — the identical closed forms the scripted models use
— and reports each packet's outcome (delivery time / loss / AQM drop)
back through per-host record buffers drained at round boundaries.

Lockstep per grid boundary E (windows are fixed multiples of the runahead,
the engine's conservative window; worker.rs:399-402 clamp semantics):

  pass A   device drains arrival events < E (ingress shaping, records)
  drain    records -> CPU: socket delivery events, drop logs, counters
  CPU      executes guests in [E-W, E), buffering sends
  upload   buffered sends -> device queues (as KIND_MSEND events)
  pass B   device drains the new sends < E (egress + loss + latency,
           deliveries clamped to >= E), arrivals land in device queues

When nothing is in flight the CPU free-runs (no device calls, windows
skipped) until a send appears — outcomes are unchanged because the clamp
grid is fixed, not adaptive.

The device state lives on `device` (the card unless the caller asks for
the CPU). A pass is the plain round handler on that state (the managed
model's hooks keep it off the pump kernel, round.py::model_pump_capable);
its records and probe come back to the host in one copy per pass.

Determinism: the loss uniform for send (src, seq) is threefry(src_key,
counter) with the counter allocated from the src host's stream at send
time on the CPU — bit-identical to the serial kernel's _loss_draw — and
all bucket/AQM math is the same int64 closed forms on both sides, so a
hybrid run and a serial run with the same window grid produce identical
transfers, delivery times, and logs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time as _walltime

import numpy as np
import torch

from shadow_tpu_torch import equeue
from shadow_tpu_torch.cpu_ref.sim import host_array
from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.engine.round import (
    PROBE_FIELDS,
    CapacityError,
    _replace,
    _tspan,
    run_round,
    state_probe,
    validate_runahead,
)
from shadow_tpu_torch.engine.state import EngineConfig, init_state
from shadow_tpu_torch.events import pack_tie
from shadow_tpu_torch.graph.routing import RoutingTables
from shadow_tpu_torch.models.managed_net import (
    KIND_MSEND,
    LANE_CTR,
    LANE_DST,
    LANE_SEQ,
    LANE_SIZE,
    LANE_SRC,
    ManagedNetModel,
)
from shadow_tpu_torch.utils.shadow_log import slog

PROBE_OVERFLOW = PROBE_FIELDS.index("overflow")
PROBE_QUEUE_OV = PROBE_FIELDS.index("queue_overflow")
PROBE_OUTBOX_OV = PROBE_FIELDS.index("outbox_overflow")


class _WorkerDied(Exception):
    """A hybrid worker process exited/hung mid-RPC (supervision-internal:
    callers see it only after the respawn budget is exhausted)."""

    def __init__(self, worker: int, reason: str):
        super().__init__(f"hybrid worker {worker} {reason}")
        self.worker = worker
        self.reason = reason


class WorkerCrashed(RuntimeError):
    """A hybrid worker died more times than the respawn budget allows."""


# state-mutating worker commands, replayed verbatim into a respawned
# worker to rebuild its deterministic kernel state up to the last round
# boundary (read-only commands — next_time/stats/proc_info/unexpected —
# are not replayed; "exit" is terminal). Maps command -> reply tag.
_REPLAYED_CMDS = {
    "run_window": "sends",
    "apply_records": "ok",
    "finish": "ok",
    "shutdown": "ok",
    "shutdown_check": "ok",
}

# byte ceiling for a worker's replay log: apply_records batches carry
# full payload columns, so a count cap alone would not bound memory on
# high-traffic runs
_REPLAY_LOG_MAX_BYTES = 256 * 1024 * 1024
# A spawned worker imports torch and the port before it answers "ready".
# That start-up is bounded on its own, by the larger of this and the RPC
# timeout: the RPC timeout catches a worker that stopped mid-RPC, and a
# short one (a test's 5 s) must not take a worker still starting on a
# loaded machine for a hung one.
_STARTUP_TIMEOUT_S = 120.0


def _replay_msg_cost(msg) -> int:
    """Approximate retained bytes of one replay-log message: per-record
    bookkeeping plus the raw payload column bytes (the dominant term for
    apply_records batches)."""
    if msg[0] != "apply_records":
        return 128
    cols = msg[1]
    n = len(cols[0]) if cols and cols[0] else 0
    payload = sum(len(pl) for pl in cols[5] if pl) if len(cols) > 5 else 0
    return 128 + 64 * n + payload


@contextlib.contextmanager
def _card_hidden():
    """The environment a worker is spawned with hides the card
    (CUDA_VISIBLE_DEVICES=""), so that it is hidden before the worker's
    interpreter imports torch; this process's own setting is restored
    once the worker has started."""
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        yield
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old


class _SortingPcap:
    """Hybrid-mode pcap shim: frames become known out of chronological
    order (send-side frames only once the device reports the packet's
    outcome), so buffer and flush time-sorted per host at close."""

    def __init__(self, inner):
        self.inner = inner
        self._buf: "list[tuple]" = []

    def udp(self, host, t, *args):
        self._buf.append((host, t, len(self._buf), "udp", args))

    def tcp(self, host, t, *args):
        self._buf.append((host, t, len(self._buf), "tcp", args))

    def close(self):
        for host, t, _i, kind, args in sorted(self._buf, key=lambda r: (r[0], r[1], r[2])):
            getattr(self.inner, kind)(host, t, *args)
        self.inner.close()


def _pack_sends(sends: "list[tuple]"):
    """Pack buffered sends into KIND_MSEND upload arrays (padded to powers
    of two, as the reference pads them for its jit cache). Shared by the
    serial and parallel schedulers — the lane layout and tie packing must
    stay bit-identical between them. Counter and seq are u32 and cross
    the int32 payload lanes as their bits."""
    m = len(sends)
    cap = 8
    while cap < m:
        cap *= 2
    time = np.zeros(cap, np.int64)
    src = np.zeros(cap, np.int32)
    data = np.zeros((cap, equeue.PAYLOAD_LANES), np.int32)
    valid = np.zeros(cap, bool)
    tie = np.zeros(cap, np.int64)
    for i, (t, s, seq, ctr, dst, size) in enumerate(sends):
        time[i] = t
        src[i] = s
        valid[i] = True
        data[i, LANE_DST] = dst
        data[i, LANE_SRC] = s
        data[i, LANE_SIZE] = size
        data[i, LANE_CTR] = np.uint32(ctr).astype(np.int32)
        data[i, LANE_SEQ] = np.uint32(seq).astype(np.int32)
        tie[i] = pack_tie(KIND_MSEND, s, seq & 0xFFFFFFFF)
    return valid, src, time, tie, data


def _fetch_records(st, probe):
    """Pull outcome records off the device in the serial application order
    (time, src, seq): ONE copy to the host of the record tensors (and of
    the pass probe, unless the caller already holds it on the host),
    numpy slicing, then a single tolist() per column — no per-element
    int() at the round boundary. Returns (t, srcs, seqs, flags) as
    plain-int lists in application order, or None when empty; raises
    CapacityError on any device-side overflow (queue/outbox overflow
    rides the probe's overflow lane)."""
    m = st.model
    h, a = m.rec_flag.shape
    p = m.rec_data.shape[2]
    on_host = not isinstance(probe, torch.Tensor)
    parts = [] if on_host else [probe.reshape(-1)]
    parts += [
        m.rec_time.reshape(-1),
        m.rec_data.reshape(-1).to(torch.int64),
        m.rec_flag.reshape(-1).to(torch.int64),
        m.rec_overflow.to(torch.int64),
    ]
    flat = torch.cat(parts).cpu().numpy()
    off = 0
    if on_host:
        pr = np.asarray(probe)
    else:
        pr = flat[: len(PROBE_FIELDS)]
        off = len(PROBE_FIELDS)
    sizes = (h * a, h * a * p, h * a, h)
    r_time, r_data, r_flag, r_ov = np.split(flat[off:], np.cumsum(sizes)[:-1])
    r_time = r_time.reshape(h, a)
    r_data = r_data.astype(np.int32).reshape(h, a, p)
    r_flag = r_flag.astype(np.int32).reshape(h, a)
    engine_ov = int(pr[PROBE_OVERFLOW])
    if int(r_ov.sum()) or engine_ov:
        # name the saturated lane (record ring vs queue vs outbox — the
        # probe's split lanes) so the blowup is diagnosable in one run
        raise CapacityError(
            f"hybrid device capacity exhausted (records={int(r_ov.sum())}, "
            f"queue={int(pr[PROBE_QUEUE_OV])}, "
            f"outbox={int(pr[PROBE_OUTBOX_OV])}); raise "
            f"record_capacity/queue_capacity/outbox_capacity"
        )
    hh, aa = np.nonzero(r_flag > 0)
    if hh.size == 0:
        return None
    t = r_time[hh, aa]
    d = r_data[hh, aa]
    seqs = d[:, LANE_SEQ].astype(np.uint32)
    srcs = d[:, LANE_SRC]
    flags = r_flag[hh, aa]
    order = np.lexsort((seqs, srcs, t))
    return (
        t[order].tolist(),
        srcs[order].tolist(),
        seqs[order].tolist(),
        flags[order].tolist(),
    )


class _DevicePlane:
    """The device half both schedulers share: the managed model's state on
    `device`, the pass (reset the record ring, one round of the plain
    handler, the probe) and the upload of staged sends."""

    def __init__(self, tables: RoutingTables, cfg: EngineConfig, tx_bytes_per_interval,
                 rx_bytes_per_interval, record_capacity: int, device):
        self.device = resolve_device(device)
        self.tables = tables.to(self.device)
        self.cfg = cfg
        self.model = ManagedNetModel(cfg.num_hosts, record_capacity=record_capacity)
        self.st = init_state(
            cfg,
            self.model.init(self.device),
            tx_bytes_per_interval=tx_bytes_per_interval,
            rx_bytes_per_interval=rx_bytes_per_interval,
            device=self.device,
        )

    def run_pass(self, window_end: int) -> torch.Tensor:
        """One device round to `window_end`; returns its probe (on the
        device)."""
        st = _replace(self.st, model=self.model.reset_records(self.st.model))
        we = torch.tensor(window_end, dtype=torch.int64, device=self.device)
        self.st = run_round(st, we, self.model, self.tables, self.cfg)
        return state_probe(self.st)

    def upload(self, sends: "list[tuple]") -> None:
        """Stage sends as KIND_MSEND events on their source hosts' queues."""
        valid, src, time, tie, data = (
            torch.from_numpy(x).to(self.device) for x in _pack_sends(sends)
        )
        q = equeue.push_many(
            self.st.queue,
            dst=src,
            valid=valid,
            time=time,
            tie=tie,
            kind=torch.full(valid.shape, KIND_MSEND, dtype=torch.int32, device=self.device),
            data=data,
            aux=torch.zeros(valid.shape, dtype=torch.int32, device=self.device),
        )
        self.st = _replace(self.st, queue=q)


class HybridScheduler:
    """Drives a NetKernel (hybrid mode) and the device engine in lockstep."""

    name = "tpu-hybrid"

    def __init__(
        self,
        kernel,
        tables: RoutingTables,
        cfg: EngineConfig,
        tx_bytes_per_interval=None,
        rx_bytes_per_interval=None,
        record_capacity: int = 128,
        device="cuda",
    ):
        if kernel.window_ns != cfg.runahead_ns:
            raise ValueError(
                f"hybrid needs kernel.window_ns == engine runahead "
                f"({kernel.window_ns} != {cfg.runahead_ns})"
            )
        validate_runahead(cfg, tables)
        self.k = kernel
        kernel.hybrid = True
        if kernel.pcap is not None:
            kernel.pcap = _SortingPcap(kernel.pcap)
        self.plane = _DevicePlane(tables, cfg, tx_bytes_per_interval, rx_bytes_per_interval,
                                  record_capacity, device)
        self.cfg = cfg
        self.W = cfg.runahead_ns
        self.inflight = 0
        self.device_passes = 0
        self._horizon: "int | None" = None
        self._probe = None  # device probe of the latest pass
        # optional utils/tracker.py registry: records hybrid_pass/
        # hybrid_upload/hybrid_drain spans for the dispatch trace
        self.tracker = None

    @property
    def st(self):
        return self.plane.st

    # --- device interaction ------------------------------------------------

    def _upload_sends(self, sends: "list[tuple]") -> None:
        """Stage buffered sends as KIND_MSEND events on their source hosts'
        device queues."""
        with _tspan(self.tracker, "hybrid_upload", sends=len(sends)):
            self.plane.upload(sends)
        self.inflight += len(sends)

    def _run_pass(self, window_end: int) -> None:
        with _tspan(self.tracker, "hybrid_pass"):
            self._probe = self.plane.run_pass(window_end)
        self.device_passes += 1

    def _drain_records(self) -> None:
        with _tspan(self.tracker, "hybrid_drain"):
            recs = _fetch_records(self.st, self._probe)
            if recs is None:
                return
            t, srcs, seqs, flags = recs
            for flag, rec_t, src, seq in zip(flags, t, srcs, seqs):
                self.k.hybrid_apply_record(
                    flag, rec_t, src, seq, horizon_ns=self._horizon
                )
            self.inflight -= len(t)

    # --- the lockstep loop -------------------------------------------------

    def run(self, until_ns: int) -> None:
        k = self.k
        W = self.W
        self._horizon = until_ns
        k._progress_total = until_ns
        try:
            E = W
            while True:
                if self.inflight == 0 and not k.pending_sends:
                    # free-run: nothing on the wire; the grid clamp is
                    # time-based so skipping idle windows changes nothing
                    # (and no device call is made)
                    k.run_window(until_ns, inclusive=True, stop_at_send_grid=True)
                    if not k.pending_sends:
                        break
                    E = k._grid_end(k.pending_sends[0][0])
                else:
                    self._run_pass(E)  # pass A: arrivals < E
                    self._drain_records()
                    if E > until_ns:
                        k.run_window(until_ns, inclusive=True)
                    else:
                        k.run_window(E)
                if k.pending_sends:
                    self._upload_sends(k.hybrid_take_sends())
                    self._run_pass(E)  # pass B: sends < E, arrivals >= E
                    self._drain_records()
                if E > until_ns and self.inflight == 0 and not k.pending_sends:
                    break
                E += W
            k.finish(until_ns)
        finally:
            k.shutdown_check()


class ParallelHybridScheduler:
    """Managed guests sharded across worker processes, packets on device.

    The parallel analogue of HybridScheduler (and of the reference's
    thread_per_core host scheduling, thread_per_core.rs:188-206): hosts
    are statically partitioned over K kernel-shard worker processes
    (runtime/hybrid_worker.py); each round window the workers execute
    their guests concurrently while the parent owns the device engine and
    routes outcome records back to the worker owning each affected host.
    Cross-worker packet payloads ride along with the sends and records.

    Determinism: identical to the serial hybrid — per-host event order is
    fixed by the same heap keys inside each worker, records are applied in
    the same global (time, src, seq) sort order, and hosts interact only
    through the device plane, so the partition (and K) cannot change any
    host's timeline. The parallel-vs-serial equality test pins this.
    """

    name = "tpu-hybrid-par"

    def __init__(
        self,
        tables: RoutingTables,
        cfg: EngineConfig,
        *,
        host_names: "list[str]",
        host_nodes: "list[int]",
        specs: "list",
        num_workers: int = 2,
        worker_of: "list[int] | None" = None,
        seed: int = 1,
        data_dir="shadow-tpu-data",
        bw_up_bits=None,
        bw_down_bits=None,
        host_ips=None,
        tx_bytes_per_interval=None,
        rx_bytes_per_interval=None,
        record_capacity: int = 128,
        strace_mode: str = "standard",
        pcap: bool = False,
        heartbeat_ns: int = 0,
        bootstrap_end_ns: int = 0,
        tcp_sack: bool = True,
        tcp_autotune: bool = True,
        qdisc: str = "fifo",
        syscall_latency_ns: int = 1_000,
        vdso_latency_ns: int = 10,
        max_unapplied_ns: int = 1_000_000,
        cpu_freq_hz=None,
        rpc_timeout_s: float = 600.0,
        max_worker_respawns: int = 1,
        replay_log_max: int = 50_000,
        device="cuda",
    ):
        import multiprocessing as mp
        import pathlib
        import shutil

        from shadow_tpu_torch.runtime.hybrid_worker import worker_main

        validate_runahead(cfg, tables)
        h = cfg.num_hosts
        if len(host_names) != h or len(host_nodes) != h:
            raise ValueError("host_names/host_nodes must cover all cfg.num_hosts")
        self.plane = _DevicePlane(tables, cfg, tx_bytes_per_interval, rx_bytes_per_interval,
                                  record_capacity, device)
        self.cfg = cfg
        self.W = cfg.runahead_ns
        self.inflight = 0
        # wall-time decomposition: worker_execute vs device_pass vs
        # upload/drain serialization (kept off stats() so serial==parallel
        # stats equality holds)
        self.phase_wall: dict = {}
        self.device_passes = 0
        self._windows_sent = 0  # window-broadcast ordinal (chaos `at` site)
        self._horizon: "int | None" = None
        self._probe = None  # fetched probe of the latest pass
        # optional utils/tracker.py registry: every _phase interval
        # (worker_execute round-trips, device passes, upload/drain) also
        # lands in the dispatch trace as a span
        self.tracker = None
        # (src, seq) -> (dst, payload-or-None) for records in flight
        self._send_meta: "dict[tuple[int, int], tuple]" = {}

        # --- partition + workers -----------------------------------------
        k = max(1, min(num_workers, h))
        self.worker_of = (
            list(worker_of) if worker_of is not None else [i % k for i in range(h)]
        )
        if len(self.worker_of) != h or any(not 0 <= w < k for w in self.worker_of):
            raise ValueError("worker_of must map every host to a worker index")
        self.num_workers = k

        data_dir = pathlib.Path(data_dir)
        if data_dir.exists():
            shutil.rmtree(data_dir)
        data_dir.mkdir(parents=True)

        self._host_names = list(host_names)
        name_to_id = {n: i for i, n in enumerate(host_names)}
        specs_of = [[] for _ in range(k)]
        for gi, s in enumerate(specs):
            d = dataclasses.asdict(s) if dataclasses.is_dataclass(s) else dict(s)
            d["_vpid"] = 1000 + gi  # global numbering, identical to serial
            specs_of[self.worker_of[name_to_id[d["host"]]]].append(d)

        lat = host_array(tables.lat_ns)
        rel = host_array(tables.rel)
        self._ctx = mp.get_context("spawn")
        self._worker_main = worker_main
        self.rpc_timeout_s = rpc_timeout_s
        self.max_worker_respawns = max_worker_respawns
        # supervision state: the retained init dict + the per-worker log
        # of state-mutating commands are everything a respawn needs to
        # rebuild a dead worker's deterministic kernel state by replay.
        # The log holds full record batches, so it grows with simulated
        # traffic: replay_log_max bounds manager memory — past it the log
        # is dropped and a later worker death becomes fatal (a run that
        # long should be supervised at a coarser grain)
        self.replay_log_max = replay_log_max
        self._init_of: "list[dict]" = []
        self._cmd_log: "list[list]" = [[] for _ in range(k)]
        self._log_bytes = [0] * k
        self._log_dropped = [False] * k
        self._respawns = [0] * k
        self._workers: "list[tuple]" = [None] * k
        for w in range(k):
            self._init_of.append(
                dict(
                    worker_index=w,
                    lat=lat,
                    rel=rel,
                    host_names=list(host_names),
                    host_nodes=list(host_nodes),
                    seed=seed,
                    data_dir=str(data_dir),
                    window_ns=self.W,
                    bw_up_bits=list(bw_up_bits) if bw_up_bits else None,
                    bw_down_bits=list(bw_down_bits) if bw_down_bits else None,
                    host_ips=list(host_ips) if host_ips else None,
                    strace_mode=strace_mode,
                    pcap=pcap,
                    heartbeat_ns=heartbeat_ns,
                    bootstrap_end_ns=bootstrap_end_ns,
                    tcp_sack=tcp_sack,
                    tcp_autotune=tcp_autotune,
                    qdisc=qdisc,
                    syscall_latency_ns=syscall_latency_ns,
                    vdso_latency_ns=vdso_latency_ns,
                    max_unapplied_ns=max_unapplied_ns,
                    cpu_freq_hz=list(cpu_freq_hz) if cpu_freq_hz else None,
                    owned=[i for i in range(h) if self.worker_of[i] == w],
                    specs=specs_of[w],
                )
            )
            self._spawn(w)
        try:
            for w in range(k):
                self._expect(self._recv(w, self._startup_timeout_s), "ready")
        except _WorkerDied as d:
            # a worker that cannot even START is a deterministic failure:
            # no respawn — reap the whole fleet and fail cleanly instead
            # of leaking the internal marker with k-1 daemons left behind
            self.close()
            raise WorkerCrashed(
                f"hybrid worker {d.worker} failed to start ({d.reason})"
            ) from d

    # --- worker plumbing / supervision ------------------------------------

    @staticmethod
    def _expect(reply, tag):
        if reply[0] == "error":
            raise RuntimeError(f"hybrid worker failed:\n{reply[1]}")
        if reply[0] != tag:
            raise RuntimeError(f"unexpected worker reply {reply[0]!r} (wanted {tag!r})")
        return reply[1:]

    def _spawn(self, w: int) -> None:
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=self._worker_main, args=(child_conn, self._init_of[w]), daemon=True
        )
        with _card_hidden():
            proc.start()
        child_conn.close()
        self._workers[w] = (proc, parent_conn)

    def _recv(self, w: int, timeout: "float | None" = None):
        """Bounded conn.recv: polls in short steps so a worker that died
        (or hung) mid-RPC raises _WorkerDied instead of blocking the
        manager forever. A hung worker is killed before raising, so the
        process is always reaped."""
        proc, conn = self._workers[w]
        limit = timeout if timeout is not None else self.rpc_timeout_s
        deadline = _walltime.monotonic() + limit
        while True:
            try:
                if conn.poll(0.2):
                    return conn.recv()
            except (EOFError, OSError):
                raise _WorkerDied(w, "closed its pipe mid-RPC")
            if not proc.is_alive():
                # the worker may have replied and then exited: one last look
                try:
                    if conn.poll(0.05):
                        return conn.recv()
                except (EOFError, OSError):
                    pass
                raise _WorkerDied(w, f"exited with code {proc.exitcode}")
            if _walltime.monotonic() > deadline:
                proc.kill()
                proc.join(5)
                what = "start-up" if limit != self.rpc_timeout_s else "RPC"
                raise _WorkerDied(w, f"hung past the {limit}s {what} timeout")

    @property
    def _startup_timeout_s(self) -> float:
        return max(self.rpc_timeout_s, _STARTUP_TIMEOUT_S)

    def _send(self, w: int, msg) -> None:
        try:
            self._workers[w][1].send(msg)
        except (BrokenPipeError, OSError):
            raise _WorkerDied(w, "died before the command could be sent")

    def _revive(self, w: int, reason: str) -> None:
        """Respawn a dead worker and replay its command log — guests
        re-execute deterministically (the run-twice determinism contract),
        so after replay the fresh worker's kernel state is bit-identical
        to the dead one's at the last completed round boundary. Bounded by
        max_worker_respawns per worker."""
        self._respawns[w] += 1
        if self._respawns[w] > self.max_worker_respawns:
            raise WorkerCrashed(
                f"hybrid worker {w} died {self._respawns[w]} times "
                f"(last: {reason}); respawn budget "
                f"({self.max_worker_respawns}) exhausted"
            )
        if self._log_dropped[w]:
            raise WorkerCrashed(
                f"hybrid worker {w} {reason}, but its replay log exceeded "
                f"replay_log_max={self.replay_log_max} and was dropped — "
                "cannot rebuild its state deterministically"
            )
        slog("warning", 0, "hybrid",
             f"worker {w} {reason}; respawning and replaying "
             f"{len(self._cmd_log[w])} commands to the last round boundary "
             f"(respawn {self._respawns[w]}/{self.max_worker_respawns})")
        # flight recorder: supervision events ride the metrics stream so
        # a post-mortem shows the respawn history before a final crash
        from shadow_tpu_torch.runtime import flightrec

        flightrec.record_event(
            "worker_respawn", worker=w, reason=reason[:200],
            respawn=self._respawns[w], replayed=len(self._cmd_log[w]),
        )
        proc, conn = self._workers[w]
        try:
            conn.close()
        except OSError:
            pass
        if proc.is_alive():
            proc.kill()
        proc.join(5)
        self._spawn(w)
        try:
            self._expect(self._recv(w, self._startup_timeout_s), "ready")
            for m in self._cmd_log[w]:
                self._send(w, m)
                # replies are discarded: the parent already consumed the
                # originals (sends/records) the first time around
                self._expect(self._recv(w), _REPLAYED_CMDS[m[0]])
        except _WorkerDied as d:
            # dying AGAIN during its own recovery is deterministic, not
            # transient: escalate instead of leaking the internal marker
            raise WorkerCrashed(
                f"hybrid worker {w} died again during respawn replay "
                f"({d.reason})"
            ) from d

    def _command(self, msgs: list, tag: str):
        """Send one message per worker (pipelined: all sends, then all
        recvs) with dead/hung-worker recovery: a worker that dies mid-RPC
        is respawned, replayed to the last round boundary, and re-issued
        the in-flight command — the round proceeds as if nothing died.
        Completed state-mutating commands are appended to each worker's
        replay log."""
        def _retry(w, m, fn, died):
            self._revive(w, died.reason)
            try:
                self._send(w, m)  # the dead worker never completed it
                return fn()
            except _WorkerDied as d2:
                raise WorkerCrashed(
                    f"hybrid worker {w} died again right after respawn "
                    f"({d2.reason})"
                ) from d2

        replies = []
        for w, m in enumerate(msgs):
            try:
                self._send(w, m)
            except _WorkerDied as d:
                _retry(w, m, lambda: None, d)
        for w, m in enumerate(msgs):
            try:
                replies.append(self._expect(self._recv(w), tag))
            except _WorkerDied as d:
                replies.append(
                    _retry(w, m, lambda w=w: self._expect(self._recv(w), tag), d)
                )
            if m[0] in _REPLAYED_CMDS and not self._log_dropped[w]:
                self._cmd_log[w].append(m)
                self._log_bytes[w] += _replay_msg_cost(m)
                if (
                    len(self._cmd_log[w]) > self.replay_log_max
                    or self._log_bytes[w] > _REPLAY_LOG_MAX_BYTES
                ):
                    self._cmd_log[w] = []
                    self._log_bytes[w] = 0
                    self._log_dropped[w] = True
        return replies

    def _broadcast(self, msg, tag):
        return self._command([msg] * len(self._workers), tag)

    def _grid_end(self, t: int) -> int:
        return (t // self.W + 1) * self.W

    # --- device interaction (same math as HybridScheduler) ---------------

    def _phase(self, name, t0):
        t1 = _walltime.perf_counter()
        self.phase_wall[name] = self.phase_wall.get(name, 0.0) + (t1 - t0)
        if self.tracker is not None:
            self.tracker.add_span(name, t0, t1)

    @property
    def st(self):
        return self.plane.st

    def _upload_sends(self, sends: "list[tuple]") -> None:
        t0 = _walltime.perf_counter()
        self.plane.upload(sends)
        self.inflight += len(sends)
        self._phase("upload", t0)

    def _run_pass(self, window_end: int) -> None:
        t0 = _walltime.perf_counter()
        probe = self.plane.run_pass(window_end)
        # sync on the [23] probe, not the state: the phase clock still
        # measures the whole pass (the probe is computed from its
        # outputs) without pulling any [H]-shaped buffer to the host
        self._probe = probe.cpu().numpy()
        self.device_passes += 1
        self._phase("device_pass", t0)

    def _drain_records(self) -> None:
        """Fetch outcome records from the device, route each half to the
        worker(s) owning the src / dst host, preserving the serial global
        application order within every worker. Worker batches ship as
        columnar lists (which/flag/t/src/seq/payload), one tuple of
        columns per worker instead of one tuple per record."""
        t0 = _walltime.perf_counter()
        recs = _fetch_records(self.st, self._probe)
        if recs is None:
            self._phase("drain_records", t0)
            return
        t, srcs, seqs, flags = recs
        batches = [tuple([] for _ in range(6)) for _ in self._workers]

        def _append(w, which, flag, rec_t, src, seq, payload):
            cols = batches[w]
            cols[0].append(which)
            cols[1].append(flag)
            cols[2].append(rec_t)
            cols[3].append(src)
            cols[4].append(seq)
            cols[5].append(payload)

        for rec_t, src, seq, flag in zip(t, srcs, seqs, flags):
            dst, payload = self._send_meta.pop((src, seq))
            w_src = self.worker_of[src]
            w_dst = self.worker_of[dst]
            if w_src == w_dst:
                _append(w_src, "both", flag, rec_t, src, seq, None)
            else:
                _append(w_src, "src", flag, rec_t, src, seq, None)
                _append(w_dst, "dst", flag, rec_t, src, seq, payload)
        self._command(
            [("apply_records", cols, self._horizon) for cols in batches], "ok"
        )
        self.inflight -= len(t)
        self._phase("drain_records", t0)

    def _inject_worker_faults(self) -> None:
        """Chaos seam (runtime/chaos.py): a `worker-kill` fault SIGKILLs
        and a `worker-hang` fault SIGSTOPs worker `target` ("workerN")
        before window broadcast number `at` — exercising exactly the
        dead-worker (_WorkerDied → respawn + replay) and hung-worker
        (bounded recv timeout → kill + respawn) supervision paths. No
        plan installed = one global read."""
        from shadow_tpu_torch.runtime import chaos

        if chaos.active() is None:
            return
        import os as _os
        import signal as _signal

        for w, (proc, _conn) in enumerate(self._workers):
            if not proc.is_alive():
                # don't let fire() burn the fault's budget (and publish
                # it as fired) on a worker that is already dead — the
                # spec stays armed for the respawned worker instead
                continue
            for kind, sig in (
                ("worker-kill", _signal.SIGKILL),
                ("worker-hang", _signal.SIGSTOP),
            ):
                spec = chaos.fire(kind, at=self._windows_sent,
                                  tags=(f"worker{w}",))
                if spec is not None:
                    try:
                        _os.kill(proc.pid, sig)
                    except OSError:
                        pass  # raced a real death — supervisor handles it

    def _run_windows(self, end_ns: int, inclusive: bool) -> "list[tuple]":
        """All workers execute [.., end_ns) concurrently; returns the
        merged send list (metadata only; payloads cached for routing)."""
        self._inject_worker_faults()
        self._windows_sent += 1
        t0 = _walltime.perf_counter()
        replies = self._broadcast(
            ("run_window", end_ns, inclusive, self._horizon), "sends"
        )
        self._phase("worker_execute", t0)
        sends = []
        for (worker_sends,) in replies:
            for (t, src, seq, ctr, dst, size, payload) in worker_sends:
                self._send_meta[(src, seq)] = (dst, payload)
                sends.append((t, src, seq, ctr, dst, size))
        return sends

    # --- the lockstep loop -------------------------------------------------

    def run(self, until_ns: int) -> None:
        W = self.W
        self._horizon = until_ns
        try:
            E = W
            while True:
                if self.inflight == 0:
                    # free-run: jump to the window containing the earliest
                    # pending event anywhere (grid-fixed, so skipping idle
                    # windows changes nothing)
                    nts = [
                        r[0]
                        for r in self._broadcast(("next_time",), "t")
                        if r[0] is not None
                    ]
                    if not nts:
                        break
                    nt = min(nts)
                    if nt > until_ns:
                        break
                    E = self._grid_end(nt)
                    if E > until_ns:
                        sends = self._run_windows(until_ns, inclusive=True)
                    else:
                        sends = self._run_windows(E, inclusive=False)
                else:
                    self._run_pass(E)  # pass A: arrivals < E
                    self._drain_records()
                    if E > until_ns:
                        sends = self._run_windows(until_ns, inclusive=True)
                    else:
                        sends = self._run_windows(E, inclusive=False)
                if sends:
                    self._upload_sends(sends)
                    self._run_pass(E)  # pass B: sends < E, arrivals >= E
                    self._drain_records()
                if E > until_ns and self.inflight == 0 and not sends:
                    break
                E += W
            self._broadcast(("finish", until_ns), "ok")
        finally:
            self._broadcast(("shutdown_check",), "ok")

    # --- inspection / teardown --------------------------------------------

    def stats(self) -> dict:
        """Aggregate of the worker shards' stats (same shape as
        NetKernel.stats(), summed; per-host entries come from the owner)."""
        replies = self._broadcast(("stats",), "stats")
        merged = None
        self._event_log = []
        import collections

        counts: "collections.Counter[str]" = collections.Counter()
        for (stats, owned, event_log) in replies:
            self._event_log.extend(event_log)
            counts.update(stats["syscall_counts"])
            if merged is None:
                merged = dict(stats)
                merged["hosts"] = {}
                for key in (
                    "syscalls_handled", "packets_sent", "packets_dropped",
                    "codel_dropped", "bytes_sent", "bytes_recv", "processes",
                ):
                    merged[key] = 0
            for key in (
                "syscalls_handled", "packets_sent", "packets_dropped",
                "codel_dropped", "bytes_sent", "bytes_recv", "processes",
            ):
                merged[key] += stats[key]
            owned_names = {self._host_names[i] for i in owned}
            for name, entry in stats["hosts"].items():
                if name in owned_names:
                    merged["hosts"][name] = entry
        merged["syscall_counts"] = dict(sorted(counts.items()))
        merged["hosts"] = dict(sorted(merged["hosts"].items()))
        return merged

    def event_log(self) -> list:
        if not hasattr(self, "_event_log"):
            self.stats()
        return self._event_log

    def proc_info(self) -> list:
        out = []
        for (procs,) in self._broadcast(("proc_info",), "procs"):
            out.extend(procs)
        return out

    def unexpected_final_states(self) -> list:
        out = []
        for (u,) in self._broadcast(("unexpected",), "u"):
            out.extend(u)
        return out

    def shutdown(self) -> None:
        self._broadcast(("shutdown",), "ok")

    def close(self) -> None:
        """Teardown that cannot hang: every recv is bounded by a poll
        timeout and every worker process is reaped — a worker that died
        mid-RPC (or wedged) is killed and joined instead of blocking the
        manager on a pipe that will never deliver."""
        for _p, conn in self._workers:
            try:
                conn.send(("exit",))
            except (BrokenPipeError, OSError):
                pass  # already dead: reaped below
        for _p, conn in self._workers:
            try:
                if conn.poll(5):
                    conn.recv()
            except (EOFError, OSError):
                pass
            try:
                conn.close()
            except OSError:
                pass
        for p, _conn in self._workers:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2)
            if p.is_alive():
                p.kill()
                p.join(timeout=2)
