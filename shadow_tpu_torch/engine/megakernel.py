"""The pump megakernel: `pump_k` packet-pump microsteps per host in one
CUDA launch (port of shadow_tpu/engine/megakernel.py).

The TPU kernel (shadow_tpu/engine/megakernel.py::_launch, a Pallas
pallas_call over VMEM-resident host tiles) becomes a CUDA C++ kernel for
sm_90a, csrc/pump_megakernel.cu: a warp per group of host rows, which
reads each live row's queue once per launch, coalesced, and orders the
events the launch can take in shared memory; then one lane per row runs
the microsteps, updating the state in place. Its plain twin is
engine/pump.py::pump_stage.

The kernel carries the pump rules (`pump_spec.block` and `apply`) of
the models that have them, tgen and onion, as template instances: a
narrow one each, which holds a row's list, defer FIFO and socket fields
in shared memory sized at compile time (pump_k <= MAX_K, at most
MAX_SOCKETS sockets per row), and a wide one each, which takes any
pump_k and any socket count: its lists, FIFO and socket-match bits live
in dynamic shared memory sized at launch, up to WIDE_LIST_CAP list
entries per pass, WIDE_FIFO_CAP FIFO entries per row and
WIDE_MATCH_WORDS match words per warp; what is past the last two goes
to device scratch that `kernel_args` allocates. `kernel_args` picks the
instance (the narrow one wherever it fits) and refuses any other model.
`megakernel_stage` dispatches on where the state lives: on the card it
launches the kernel (or raises — there is no fallback), on the CPU it
runs the twin. An ensemble's rows view (engine/state.py::rows_view) is
one launch over all R * H rows: the window end, `min_used_lat` and the
rejected flag are [R], and each row reads and writes its replica's. The
kernel is built with nvcc from the repo's own source on first use, into
build/shadow_tpu_torch/ at the repo root, as a plain C shared library
loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from shadow_tpu_torch.config.options import NotYetPorted
from shadow_tpu_torch.engine.pump import pump_stage
from shadow_tpu_torch.engine.state import EngineConfig, SimState, replicas_of
from shadow_tpu_torch.graph.routing import RoutingTables

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pump_megakernel.cu"
BUILD_DIR = _PKG.parent / "build" / "shadow_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# (field, kind) in the order of the C struct PumpArgs. kind is the torch
# dtype a pointer field must have, or None for an int64 scalar field.
_I64, _I32, _B, _F32 = torch.int64, torch.int32, torch.bool, torch.float32
_FIELDS = (
    [("q_time", _I64), ("q_tie", _I64), ("q_kind", _I32), ("q_data", _I32),
     ("q_aux", _I32), ("q_count", _I32), ("q_overflow", _I32), ("q_head", _I64)]
    + [(n, _I64) for n in ("tx_refill", "tx_tokens", "tx_last", "rx_refill",
                           "rx_tokens", "rx_last", "codel_first_above",
                           "codel_drop_next")]
    + [("codel_count", _I32), ("codel_dropping", _B)]
    + [(n, _I64) for n in ("rx_backlog", "codel_dropped", "bytes_sent", "bytes_recv")]
    + [("st", _I32), ("lport", _I32), ("rport", _I32), ("rhost", _I32)]
    + [(n, _I64) for n in ("snd_una", "snd_nxt", "snd_max", "snd_end")]
    + [("fin_pending", _B), ("fin_sent", _B)]
    + [(n, _I64) for n in ("peer_wnd", "rcv_nxt", "rcv_fin", "delivered", "ooo",
                           "sacked", "cwnd", "ssthresh")]
    + [("dupacks", _I32), ("in_rec", _B)]
    + [(n, _I64) for n in ("srtt", "rttvar", "rto")]
    + [("rtt_pending", _B), ("rtt_seq", _I64), ("rtt_ts", _I64), ("rto_expire", _I64),
       ("backoff", _I32), ("tev_time", _I64)]
    + [(n, _I64) for n in ("retransmits", "segs_in", "segs_out", "bytes_down",
                           "streams_started", "streams_done")]
    + [("ob_valid", _B), ("ob_dst", _I32), ("ob_time", _I64), ("ob_tie", _I64),
       ("ob_data", _I32), ("ob_aux", _I32), ("ob_fill", _I32), ("ob_overflow", _I32)]
    + [(n, _I64) for n in ("seq", "rng_counter", "events_handled", "packets_sent",
                           "packets_dropped", "packets_unroutable", "trk_bytes_ctrl",
                           "trk_bytes_data", "trk_retrans", "window_end", "min_used")]
    + [("rejected", _I32)]
    + [("host_id", _I32), ("rng_key", _I64), ("host_node", _I32), ("lat_ns", _I64),
       ("rel", _F32), ("codel_table", _I64), ("fifo", _I64), ("match", _I32)]
    + [(n, None) for n in ("H", "Q", "O", "S", "R", "N", "num_global_hosts", "pump_k", "wide",
                           "rows_per_replica", "bootstrap_end_ns", "use_netstack",
                           "use_sack", "tracker", "dyn_runahead", "model", "num_clients", "num_servers",
                           "req_bytes", "num_relays", "resp_span",
                           "mss", "header_bytes", "rcv_wnd", "rto_min_ns",
                           "rto_max_ns", "granularity_ns", "segs_per_flush",
                           "draws_per_event", "packet_emits")]
)


# The kernel's compile-time layout, as csrc/pump_megakernel.cu declares
# it: host rows per warp, queue slots a row stages in shared memory, and
# the one TCP shape (out-of-order ranges, segments per flush) it is built
# for; the list entries a narrow instance holds (its pump_k limit) and
# the int64 words of a wide instance's defer-FIFO entry in device
# scratch; a wide instance's caps on its dynamic shared memory: list
# entries per pass, FIFO entries per row (pump_k past it: the rest in
# scratch) and socket-match words per warp (ROWS_PER_WARP x sockets bits;
# past it: all in scratch). tests/test_torch_megakernel.py holds these in
# step with the source.
ROWS_PER_WARP = 8
STAGE = 32
TCP_SHAPE = (4, 4)
MAX_K = 16
FIFO_WORDS = 8
WIDE_LIST_CAP = 64
WIDE_FIFO_CAP = 64
WIDE_MATCH_WORDS = 2048
# The models whose pump rules the kernel carries: its id in
# PumpArgs.model and the sockets per host row its narrow instance is
# built for (the source's MODEL_* and *_MAX_S).
MODEL_IDS = {"tgen": 0, "onion": 1}
MAX_SOCKETS = {"tgen": 8, "onion": 32}
# every template instance, by name: "<model>" (narrow), "<model>_wide"
INSTANCES = tuple(MODEL_IDS) + tuple(f"{m}_wide" for m in MODEL_IDS)
_MODEL_NAMES = {v: k for k, v in MODEL_IDS.items()}


class PumpArgs(ctypes.Structure):
    _fields_ = [
        (name, ctypes.c_void_p if kind is not None else ctypes.c_int64)
        for name, kind in _FIELDS
    ]


class PumpMegakernel:
    """The built kernel and its launch counters. `launches` counts kernel
    launches only (the CPU twin does not count); `launches_by_model`
    splits them by the template instance launched (INSTANCES)."""

    def __init__(self):
        self.launches = 0
        self.launches_by_model = dict.fromkeys(INSTANCES, 0)
        self.build_seconds = None
        self.build_log = ""
        self._lib = None
        self._codel = {}

    def library(self) -> ctypes.CDLL:
        """Build (first use) and load the shared library."""
        if self._lib is None:
            self._lib = self._build()
        return self._lib

    def _build(self) -> ctypes.CDLL:
        """nvcc's output (the -Xptxas -v resource report) is kept beside
        the library, so a later process that loads it still has it."""
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"pump_megakernel_{tag}.so"
        log = out.with_suffix(".log")
        if out.exists():
            self.build_log = log.read_text() if log.exists() else ""
        else:
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            if not os.path.exists(nvcc):
                raise RuntimeError("nvcc not found: the pump megakernel cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True,
            )
            self.build_seconds = time.perf_counter() - t0
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {SOURCE}:\n{self.build_log}")
            log.write_text(self.build_log)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.pump_megakernel_launch.argtypes = [ctypes.POINTER(PumpArgs), ctypes.c_void_p]
        lib.pump_megakernel_launch.restype = ctypes.c_int
        lib.pump_megakernel_args_size.restype = ctypes.c_int
        lib.pump_megakernel_dynamic_smem.argtypes = [ctypes.POINTER(PumpArgs)]
        lib.pump_megakernel_dynamic_smem.restype = ctypes.c_int
        if lib.pump_megakernel_args_size() != ctypes.sizeof(PumpArgs):
            raise RuntimeError("PumpArgs layout differs between Python and CUDA")
        return lib

    def codel_table(self, device) -> torch.Tensor:
        from shadow_tpu_torch.netstack import codel_table

        key = str(device)
        if key not in self._codel:
            self._codel[key] = codel_table(device)
        return self._codel[key]

    def dynamic_smem(self, args: PumpArgs) -> int:
        """Bytes of dynamic shared memory a launch with `args` takes (a
        wide instance's, sized from pump_k and the socket count; 0 for a
        narrow one)."""
        return self.library().pump_megakernel_dynamic_smem(ctypes.byref(args))

    def launch(self, args: PumpArgs, device) -> None:
        lib = self.library()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pump_megakernel_launch(ctypes.byref(args), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"pump megakernel launch failed: CUDA error {err}")
        self.launches += 1
        name = _MODEL_NAMES[args.model]
        self.launches_by_model[f"{name}_wide" if args.wide else name] += 1


PUMP_KERNEL = PumpMegakernel()


def kernel_model(model) -> str:
    """The name of the kernel instance that carries `model`'s pump rules;
    NotYetPorted for a model without one (never a silent twin run)."""
    from shadow_tpu_torch.models.overlay.onion import OnionModel
    from shadow_tpu_torch.models.tgen import TgenModel

    if isinstance(model, TgenModel):
        return "tgen"
    if isinstance(model, OnionModel):
        return "onion"
    raise NotYetPorted(f"the pump megakernel for model {type(model).__name__}")


def kernel_instance(model, cfg: EngineConfig) -> str:
    """The template instance a launch for `model` at cfg.pump_k runs: the
    model's narrow instance where its list and sockets fit, else its wide
    one (INSTANCES)."""
    name = kernel_model(model)
    narrow = cfg.pump_k <= MAX_K and model.tcp_params.num_sockets <= MAX_SOCKETS[name]
    return name if narrow else f"{name}_wide"


def kernel_args(st: SimState, window_end: torch.Tensor, model, tables: RoutingTables,
                cfg: EngineConfig, rejected: torch.Tensor, codel_table: torch.Tensor):
    """The kernel's argument struct for `st` (one world, or an ensemble's
    rows view, whose window_end and min_used are [R] and rejected [R]),
    after checking device, dtype, shape and contiguity of every tensor it
    points at. A wide instance gets its scratch here, only for what its
    shared memory does not hold: the defer-FIFO entries past
    WIDE_FIFO_CAP, and the socket-match words when a warp's are more than
    WIDE_MATCH_WORDS. Returns (args, tensors): keep `tensors` alive until
    the launch is enqueued."""
    instance = kernel_model(model)
    wide = kernel_instance(model, cfg) != instance
    p = model.tcp_params
    q, ob, net, ts, tr = st.queue, st.outbox, st.net, st.model.tcp, st.tracker
    h, cap = q.time.shape
    replicas = replicas_of(st)
    world = () if replicas is None else (replicas,)
    if replicas is not None and h % replicas:
        raise ValueError(f"pump megakernel: {h} rows do not split into {replicas} replicas")
    o = ob.valid.shape[1]
    s, r = p.num_sockets, p.ooo_ranges
    if (r, p.segs_per_flush) != TCP_SHAPE:
        raise NotYetPorted(
            f"the pump megakernel for TCP with {r} out-of-order ranges and "
            f"{p.segs_per_flush} segments per flush (it is built for {TCP_SHAPE})")
    n = tables.lat_ns.shape[0]
    g = tables.host_node.shape[0]
    words = -(-ROWS_PER_WARP * s // 32)
    fifo_shape = ((h, cfg.pump_k - WIDE_FIFO_CAP, FIFO_WORDS)
                  if wide and cfg.pump_k > WIDE_FIFO_CAP else (0,))
    match_shape = ((-(-h // ROWS_PER_WARP), words)
                   if wide and words > WIDE_MATCH_WORDS else (0,))
    shapes = {
        "q_time": (h, cap), "q_tie": (h, cap), "q_kind": (h, cap), "q_data": (h, cap, 8),
        "q_aux": (h, cap), "ooo": (h, s, r, 2), "sacked": (h, s, r, 2),
        "ob_valid": (h, o), "ob_dst": (h, o), "ob_time": (h, o), "ob_tie": (h, o),
        "ob_data": (h, o, 8), "ob_aux": (h, o), "rng_key": (h, 2), "window_end": world,
        "min_used": world, "rejected": (replicas or 1,), "host_node": (g,), "lat_ns": (n, n),
        "rel": (n, n), "codel_table": (1025,),
        "fifo": fifo_shape, "match": match_shape,
    }
    tcp_names = {f.name for f in dataclasses.fields(ts)}
    tensors = {
        "q_time": q.time, "q_tie": q.tie, "q_kind": q.kind, "q_data": q.data,
        "q_aux": q.aux, "q_count": q.count, "q_overflow": q.overflow,
        "q_head": q.head_time,
        **{k: getattr(net, k) for k in (
            "tx_refill", "tx_tokens", "tx_last", "rx_refill", "rx_tokens", "rx_last",
            "codel_first_above", "codel_drop_next", "codel_count", "codel_dropping",
            "codel_dropped", "bytes_sent", "bytes_recv")},
        "rx_backlog": net.rx_backlog_bytes,
        **{k: getattr(ts, k) for k in tcp_names},
        "bytes_down": st.model.bytes_down,
        "streams_started": st.model.streams_started,
        "streams_done": st.model.streams_done,
        "ob_valid": ob.valid, "ob_dst": ob.dst, "ob_time": ob.time, "ob_tie": ob.tie,
        "ob_data": ob.data, "ob_aux": ob.aux, "ob_fill": ob.fill,
        "ob_overflow": ob.overflow,
        "seq": st.seq, "rng_counter": st.rng_counter,
        "events_handled": st.events_handled, "packets_sent": st.packets_sent,
        "packets_dropped": st.packets_dropped,
        "packets_unroutable": st.packets_unroutable,
        "trk_bytes_ctrl": tr.bytes_ctrl, "trk_bytes_data": tr.bytes_data,
        "trk_retrans": tr.retrans_segs,
        "window_end": window_end, "min_used": st.min_used_lat, "rejected": rejected,
        "host_id": st.host_id, "rng_key": st.rng_key, "host_node": tables.host_node,
        "lat_ns": tables.lat_ns, "rel": tables.rel, "codel_table": codel_table,
        "fifo": torch.empty(fifo_shape, dtype=torch.int64, device=st.device),
        "match": torch.empty(match_shape, dtype=torch.int32, device=st.device),
    }
    args = PumpArgs()
    dev = st.device
    for name, kind in _FIELDS:
        if kind is None:
            continue
        t = tensors[name]
        want = shapes.get(name)
        if want is None:
            want = (h, s) if name in tcp_names else (h,)
        if t.device != dev or t.dtype != kind or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(
                f"pump megakernel: {name} must be a contiguous {kind} tensor of shape "
                f"{want} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}"
            )
        setattr(args, name, t.data_ptr())
    scalars = dict(
        H=h, Q=cap, O=o, S=s, R=r, N=n, num_global_hosts=g, pump_k=cfg.pump_k, wide=int(wide),
        rows_per_replica=h // (replicas or 1), bootstrap_end_ns=cfg.bootstrap_end_ns,
        use_netstack=int(cfg.use_netstack),
        use_sack=int(p.use_sack), tracker=int(cfg.tracker),
        dyn_runahead=int(cfg.use_dynamic_runahead), model=MODEL_IDS[instance],
        num_clients=model.num_clients, mss=p.mss,
        header_bytes=p.header_bytes, rcv_wnd=p.rcv_wnd, rto_min_ns=p.rto_min_ns,
        rto_max_ns=p.rto_max_ns, granularity_ns=p.granularity_ns,
        segs_per_flush=p.segs_per_flush, draws_per_event=model.DRAWS_PER_EVENT,
        packet_emits=model.PACKET_EMITS,
    )
    if instance == "tgen":
        scalars.update(num_servers=model.num_servers, req_bytes=model.req_bytes)
    else:
        scalars.update(num_relays=model.num_relays, resp_span=model.resp_span)
    for k, v in scalars.items():
        setattr(args, k, int(v))
    return args, tensors


def megakernel_stage(st: SimState, window_end, model, tables: RoutingTables,
                     cfg: EngineConfig):
    """Drop-in for pump_stage: (state, any_rejected; [R] flags on an
    ensemble's rows view). On the card this launches the kernel once
    over every row, updating `st`'s tensors IN PLACE (callers comparing
    two paths clone first); on the CPU it runs the twin."""
    if cfg.pump_k <= 0:
        raise ValueError("megakernel_stage requires pump_k > 0")
    if st.device.type == "cpu":
        return pump_stage(st, window_end, model, tables, cfg)
    if st.device.type != "cuda":
        raise RuntimeError(f"pump megakernel: unsupported device {st.device}")
    replicas = replicas_of(st)
    we = torch.as_tensor(window_end, dtype=torch.int64, device=st.device).reshape(
        () if replicas is None else (replicas,))
    rejected = torch.zeros((replicas or 1,), dtype=torch.int32, device=st.device)
    args, keep = kernel_args(
        st, we, model, tables, cfg, rejected, PUMP_KERNEL.codel_table(st.device)
    )
    PUMP_KERNEL.launch(args, st.device)
    del keep
    return st, (rejected[0] != 0 if replicas is None else rejected != 0)


def resolve_stage_cfg(cfg: EngineConfig) -> EngineConfig:
    """pump_k defaults to 8 microsteps per launch when unset."""
    if cfg.pump_k > 0:
        return cfg
    return dataclasses.replace(cfg, pump_k=8)
