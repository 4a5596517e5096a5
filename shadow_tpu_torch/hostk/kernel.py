"""The CPU-side simulation kernel for managed (real) processes (port of
shadow_tpu/hostk/kernel.py; its threefry draws run on CPU tensors).

Rebuilds the reference's managed-process control plane (reference:
src/main/host/managed_thread.rs:156-267 run-until-syscall loop;
src/main/host/process.rs spawn/resume; src/main/host/syscall/handler/*
syscall emulation + the ~160-entry dispatch seam syscall_handler.c:229-463;
src/main/host/syscall_condition.c blocked-syscall wakeups;
src/main/core/worker.rs:328-413 send_packet) as a serial discrete-event
loop over real child processes parked on futex channels.

Determinism contract shared with the device engine: packet loss draws use
the same threefry per-host counter streams (rng.py), latencies
come from the same RoutingTables, sim time starts at the same 2000-01-01
epoch (simtime.SIM_START_UNIX_NS; reference emulated_time.rs:25-34), and
all scheduling decisions derive from (time, seq) heap order — two runs of
the same config produce identical syscall traces and identical guest-
visible timestamps.

Time model: a process's clock advances by `syscall_latency_ns` per
emulated syscall plus whatever unapplied vdso-read latency the shim
accumulated locally (the reference's model_unblocked_syscall_latency,
shim_sys.c:182-217). Pure native compute does not advance sim time (the
reference models CPU time only behind an experimental flag; same stance).
"""

from __future__ import annotations

import dataclasses
import heapq
import os
import pathlib
import shutil
import struct
import subprocess
from collections import deque
from typing import Callable, Optional

import numpy as np

from shadow_tpu_torch import netstack, rng
from shadow_tpu_torch.hostk import shaping
from shadow_tpu_torch.graph.routing import RoutingTables
from shadow_tpu_torch.hostk import ipc as I
from shadow_tpu_torch.hostk import tcp as T
from shadow_tpu_torch.cpu_ref.sim import host_array
from shadow_tpu_torch.hostk.build import shim_lib_path
from shadow_tpu_torch.hostk.descriptor import (
    EAGAIN,
    EBADF,
    EADDRINUSE,
    ECONNREFUSED,
    EBUSY,
    ECHILD,
    EINTR,
    EPERM,
    ESRCH,
    ETIMEDOUT,
    EDESTADDRREQ,
    EINPROGRESS,
    EINVAL,
    EISCONN,
    EMSGSIZE,
    ENOSYS,
    EFAULT,
    ENOTCONN,
    ENOTSOCK,
    EPOLLIN,
    EPOLLOUT,
    PROTO_TCP,
    PROTO_UDP,
    DescriptorTable,
    Epoll,
    EventFd,
    File,
    PipeEnd,
    RandomFile,
    SOCK_DGRAM,
    SOCK_STREAM,
    TimerFd,
    UdpSocket,
    UnixSocket,
    make_pipe,
)
from shadow_tpu_torch.hostk.dns import Dns
from shadow_tpu_torch.hostk.strace import StraceFile
from shadow_tpu_torch.simtime import SIM_START_UNIX_NS, TIME_MAX


EPHEMERAL_PORT_BASE = 10_000
LOOPBACK_LATENCY_NS = 1_000  # same-host delivery when the graph has no self-path
LOCALHOST_NET = 127 << 24  # 127.0.0.0/8 -> the sending host itself

O_NONBLOCK = 0x800
F_GETFL = 3
F_SETFL = 4
FIONREAD = 0x541B
FIONBIO = 0x5421
SOL_SOCKET = 1
SO_ERROR = 4


def _disable_aslr() -> None:
    """Child-side pre-exec: ADDR_NO_RANDOMIZE so guest heap/stack/mmap
    addresses replay identically run to run (pointer values leak into
    guest behavior and strace; the reference disables ASLR for all
    managed processes the same way, main.rs:203-206 disable_aslr)."""
    import ctypes

    ADDR_NO_RANDOMIZE = 0x0040000
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        pers = libc.personality(0xFFFFFFFF)  # query
        if pers != -1:
            libc.personality(pers | ADDR_NO_RANDOMIZE)
    except Exception:
        pass  # ASLR stays on; determinism of pointer values degrades only


def _guest_preexec() -> None:
    """Child-side pre-exec of a guest: ASLR off (_disable_aslr), and the
    guest is killed when the kernel that spawned it dies
    (PR_SET_PDEATHSIG): a hybrid worker killed mid-run is respawned and
    its guests re-executed, so the dead worker's guests must not outlive
    it, parked on their channels for good."""
    import ctypes
    import signal

    _disable_aslr()
    PR_SET_PDEATHSIG = 1
    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    except Exception:
        pass  # the guest may outlive a crashed kernel; the run is unchanged


class SimPanic(RuntimeError):
    pass


@dataclasses.dataclass
class ProcessSpec:
    host: str
    args: list[str]
    start_ns: int = 0
    expected_final_state: str = "exited"  # "exited" | "running"
    environment: dict = dataclasses.field(default_factory=dict)
    shutdown_ns: Optional[int] = None  # kill the process at this sim time


class Waiter:
    """A blocked syscall: re-checks its wake condition on every state
    change of the files it watches, with an optional timeout (reference:
    SysCallCondition, syscall_condition.c:22-48 — trigger + Timer +
    StatusListener with edge filters; restart semantics live in check())."""

    def __init__(
        self,
        kernel: "NetKernel",
        proc: "ManagedProcess",
        files: "list[File]",
        check: "Callable[[], bool]",
        timeout_at: Optional[int] = None,
        on_timeout: Optional[Callable[[], None]] = None,
        on_interrupt: Optional[Callable[[], None]] = None,
        restartable: bool = True,
        sig_interruptible: bool = True,
    ):
        self.kernel = kernel
        self.proc = proc
        self.files = files
        self.check = check
        self.done = False
        self._checking = False  # guards re-entrant notify during check()
        self.on_timeout = on_timeout
        self.on_interrupt = on_interrupt  # custom EINTR reply (e.g. nanosleep rem)
        # pause/poll/epoll_wait are never restarted by SA_RESTART on Linux
        self.restartable = restartable
        # pthread mutex/cond/join waits never return EINTR (POSIX); a
        # queued signal is delivered once the wait completes
        self.sig_interruptible = sig_interruptible
        proc.waiter = self
        for f in files:
            f.add_listener(self._cb)
        if timeout_at is not None:
            kernel._push(timeout_at, self._timeout_fire)

    def _detach(self) -> None:
        self.done = True
        for f in self.files:
            f.remove_listener(self._cb)
        if self.proc.waiter is self:
            self.proc.waiter = None

    def _run_check(self) -> bool:
        self._checking = True
        try:
            return self.check()
        finally:
            self._checking = False

    def _cb(self, _f: File) -> None:
        if self.done or self._checking or self.proc.dead:
            return
        self.proc.now = max(self.proc.now, self.kernel.now)
        if self._run_check():
            self._detach()
            self.proc.state = "running"
            self.kernel._service(self.proc)

    def _timeout_fire(self) -> None:
        if self.done or self._checking or self.proc.dead:
            return
        self.proc.now = max(self.proc.now, self.kernel.now)
        if self._run_check():  # raced: became ready at the same instant
            self._detach()
            self.proc.state = "running"
            self.kernel._service(self.proc)
            return
        self._detach()
        if self.on_timeout is not None:
            self.on_timeout()
        self.proc.state = "running"
        self.kernel._service(self.proc)


class GuestThread:
    """One managed thread: its own futex channel pair + per-thread clock
    and run state (reference: ManagedThread, managed_thread.rs:40; the
    reference likewise runs exactly one thread of the whole simulation at
    a time via per-thread ping-pong channels)."""

    def __init__(self, process: "ManagedProcess", tid: int, ipc: "Optional[I.IpcBlock]"):
        self.process = process
        self.kernel = process.kernel
        self.tid = tid
        self.ipc = ipc
        self.now = 0
        self.state = "pending"  # pending -> running -> blocked -> exited
        self.sig_mask = 0  # blocked-signal bits (rt_sigprocmask, kernel view)
        self.waiter: Optional[Waiter] = None
        self._pending: Optional[tuple[str, str]] = None  # strace line await reply
        self.pending_sigs: "deque[int]" = deque()
        self.retval = 0  # THREAD_EXIT value for joiners
        self.exit_evt = File()  # joiners listen here

    # ---- process delegation: syscall handlers treat a thread as the
    # calling context, most state is process-wide --------------------------

    @property
    def host(self):
        return self.process.host

    @property
    def fdtab(self):
        return self.process.fdtab

    @property
    def spec(self):
        return self.process.spec

    @property
    def vpid(self):
        return self.process.vpid

    @property
    def strace(self):
        return self.process.strace

    @property
    def syscall_log(self):
        return self.process.syscall_log

    @property
    def sig_handlers(self):
        return self.process.sig_handlers

    @property
    def dead(self) -> bool:
        return self.state == "exited" or self.process.exited

    # ---- channel ---------------------------------------------------------

    def _recv(self, max_wall_s: "Optional[float]" = None):
        """Blocking receive with child-death detection (the reference pairs
        this with ChildPidWatcher closing the channel,
        utility/childpid_watcher.rs). Returns None if the process died,
        False if max_wall_s elapsed."""
        import time as _time

        deadline = _time.monotonic() + max_wall_s if max_wall_s else None
        while True:
            msg = self.ipc.recv_from_shim(timeout_ms=100)
            if msg is not None:
                return msg
            if self.process.native_dead():
                return None
            if deadline is not None and _time.monotonic() > deadline:
                return False

    def _reply(self, ret: int = 0, a=(), buf: bytes = b"") -> None:
        if self._pending is not None and self.strace is not None:
            name, args = self._pending
            self.strace.log(self.now, name, args, ret, tid=self.tid)
        self._pending = None
        self.ipc.set_time(SIM_START_UNIX_NS + self.now, 0)
        m = I.make_msg(I.MSG_SYSCALL_DONE, a=a, ret=ret, buf=buf)
        if self.pending_sigs:  # deliver one queued signal with this return
            m.sig = self.pending_sigs.popleft()
        self.ipc.send_to_shim(m)

    def mark_exited(self) -> None:
        if self.state != "exited":
            self.state = "exited"
            self.exit_evt.notify()


class ManagedProcess:
    def __init__(self, kernel: "NetKernel", spec: ProcessSpec, host: "HostKernel", vpid: int):
        self.kernel = kernel
        self.spec = spec
        self.host = host
        self.vpid = vpid
        self.popen: Optional[subprocess.Popen] = None
        self.real_pid: Optional[int] = None  # forked children have no Popen
        self.parent: "Optional[ManagedProcess]" = None
        self.wait_status = 0  # waitpid-style status for the guest parent
        self.waited = False  # reaped by a guest waitpid
        self.fdtab = DescriptorTable()
        self.threads: "list[GuestThread]" = []
        self.exited = False
        self.syscall_log: list[tuple[int, str, tuple]] = []
        # memory-map ledger (reference memory_manager/mod.rs bookkeeping):
        # addr -> (len, prot, flags, fd-kind, offset); break from the shim
        self.mappings: "dict[int, tuple]" = {}
        self.brk_end = 0
        self.exit_code: Optional[int] = None
        self._stdout_path = None
        self.strace: Optional[StraceFile] = None
        # signal state (reference: process.rs signal bookkeeping + the
        # pending-unblocked-signal handoff shim_shmem.rs:252-268)
        self.sig_handlers: dict[int, int] = {}  # sig -> 0 dfl | 1 ign | 2 handler
        self.shutdown_requested = False  # config shutdown_time fired
        # still running when the simulation ended and shadow killed it; the
        # final-state check reports this as "running" (reference
        # process.rs:1215 maps ExitStatus::StoppedByShadow -> Running)
        self.stopped_by_shadow = False
        self.itimer_fire_ns = 0  # 0 = disarmed
        self.itimer_interval_ns = 0
        self.itimer_gen = 0
        # pthread sync objects, keyed by guest address
        # (reference: futex.c/futex_table.c serve the same role one level
        # down; the shim interposes at the pthread layer instead)
        self.mutexes: dict[int, "KMutex"] = {}
        self.conds: dict[int, "KCond"] = {}
        # signals every live thread currently blocks, pending delivery
        # (real semantics: blocked signals — even default-fatal ones —
        # stay pending until some thread unblocks them)
        self.blocked_pending: "list[int]" = []
        self.child_evt = File()  # notified whenever any of our children exits
        # raw-futex wait queues (reference: per-host futex table,
        # futex_table.c; here per address space, which is what private
        # futexes actually key on): addr -> FIFO of waiting tids. One hub
        # event source for the whole table so requeued waiters keep their
        # listener (wake/requeue re-check every futex waiter; counts are
        # tiny and order stays FIFO-deterministic).
        self.futex_q: dict[int, list[int]] = {}
        self.futex_woken: set[int] = set()
        self.futex_hub = File()

    # ---- main-thread conveniences (tests + process-level call sites) ----

    @property
    def main(self) -> "Optional[GuestThread]":
        return self.threads[0] if self.threads else None

    @property
    def state(self) -> str:
        if self.exited:
            return "exited"
        return self.main.state if self.main else "pending"

    @property
    def now(self) -> int:
        return max((t.now for t in self.threads), default=0)

    @property
    def ipc(self):
        return self.main.ipc if self.main else None

    def mark_exited(self) -> None:
        if self.exited:
            return
        self.exited = True
        for t in self.threads:
            if t.waiter is not None:
                t.waiter._detach()
            t.mark_exited()
        # process exit closes its descriptors (releases shared pipe/socket
        # ends so peers see EOF/HUP; ports/namespace entries free)
        for fd in self.fdtab.fds():
            self.kernel._close_fd(self, fd)
        if self.parent is not None:
            self.parent.child_evt.notify()  # guest parents blocked in waitpid

    def native_dead(self) -> bool:
        """Has the real process died under us? (ChildPidWatcher analogue.)
        Forked children are the *guest's* children, so poll /proc: a
        zombie (Z) counts as dead — the guest parent will reap it."""
        if self.popen is not None:
            return self.popen.poll() is not None
        if self.real_pid is None:
            return False
        try:
            with open(f"/proc/{self.real_pid}/stat") as f:
                return f.read().split(") ")[-1][:1] == "Z"
        except OSError:
            return True

    # --- lifecycle -------------------------------------------------------

    def spawn(self, now_ns: int) -> None:
        main = GuestThread(
            self,
            self.vpid,
            I.IpcBlock(
                tag=f"h{self.host.host_id}p{self.vpid}",
                vdso_latency_ns=self.host.vdso_latency_ns,
                syscall_latency_ns=self.host.syscall_latency_ns,
                max_unapplied_ns=self.kernel.max_unapplied_ns,
            ),
        )
        main.now = now_ns
        self.threads.append(main)
        self.ipc.set_time(SIM_START_UNIX_NS + now_ns, 0)
        env = dict(os.environ)
        env.update(self.spec.environment)
        env["LD_PRELOAD"] = shim_lib_path()
        env["SHADOW_SHM"] = self.ipc.path
        env["SHADOW_HOSTNAME"] = self.host.name
        env["SHADOW_HOSTS_FILE"] = str(self.kernel.hosts_file)
        outdir = self.kernel.data_dir / self.host.name
        outdir.mkdir(parents=True, exist_ok=True)
        exe = pathlib.Path(self.spec.args[0]).name
        self._stdout_path = outdir / f"{exe}.{self.vpid}.stdout"
        self._stderr_path = outdir / f"{exe}.{self.vpid}.stderr"
        self.strace = StraceFile(
            outdir / f"{exe}.{self.vpid}.strace", self.vpid, mode=self.kernel.strace_mode
        )
        # run the process chdir'd into its per-host data dir so native
        # (non-interposed) relative file access is sandboxed there, exactly
        # like the reference's SHADOW_WORKING_DIR chdir (shim.c:383-470)
        args = [str(pathlib.Path(self.spec.args[0]).resolve())] + list(self.spec.args[1:])
        self.popen = subprocess.Popen(
            args,
            env=env,
            cwd=outdir,
            stdout=open(self._stdout_path, "wb"),
            stderr=open(self._stderr_path, "wb"),
            stdin=subprocess.DEVNULL,
            preexec_fn=_guest_preexec,
        )
        # shim constructor sends START_REQ before main() runs
        msg = main._recv()
        if msg is None or msg.kind != I.MSG_START_REQ:
            raise SimPanic(
                f"{self.host.name}: process failed to attach "
                f"(kind={getattr(msg, 'kind', None)}, rc={self.popen.poll()})"
            )
        main.state = "running"

    def stdout(self) -> bytes:
        return pathlib.Path(self._stdout_path).read_bytes() if self._stdout_path else b""

    def stderr(self) -> bytes:
        return pathlib.Path(self._stderr_path).read_bytes() if self._stderr_path else b""

    def kill(self) -> None:
        if not self.exited:
            self.stopped_by_shadow = True
        self.exited = True
        if self.popen and self.popen.poll() is None:
            self.popen.kill()
            self.popen.wait()
        elif (
            self.popen is None
            and self.real_pid is not None
            and not self.waited
            and self.native_dead() is False
        ):
            try:
                os.kill(self.real_pid, 9)
            except OSError:
                pass
        if self.strace:
            self.strace.close()
            self.strace = None
        for t in self.threads:
            t.mark_exited()
            if t.ipc is not None:
                t.ipc.close()
                t.ipc = None


class NicQueue:
    """Modeled egress NIC with a round-robin qdisc across sockets
    (reference: network_queuing_disciplines.h:15-25 — FIFO by packet
    priority vs round-robin across sockets; network_interface.c:171,332).

    Engaged when interface_qdisc=rr: instead of charging the token bucket
    eagerly at send time (FIFO by construction), packets wait in
    per-socket queues and the NIC pumps one packet per line departure,
    picking the next non-empty socket round-robin. Charging order is the
    only thing the discipline changes, so FIFO mode needs no queue at all
    and bucket math stays the shared closed form."""

    def __init__(self, kernel: "NetKernel", host: "HostKernel"):
        self.kernel = kernel
        self.host = host
        self.queues: "dict[object, object]" = {}
        self.order: "list[object]" = []  # first-seen socket order
        self.rr_idx = 0
        self.pumping = False

    def submit(self, sock_key, size: int, emit) -> None:
        q = self.queues.get(sock_key)
        if q is None:
            q = self.queues[sock_key] = deque()
            self.order.append(sock_key)
        q.append((size, emit))
        if not self.pumping:
            self._pump()

    def _next(self):
        n = len(self.order)
        for i in range(n):
            j = (self.rr_idx + i) % n
            q = self.queues[self.order[j]]
            if q:
                self.rr_idx = (j + 1) % n
                item = q.popleft()
                if not q:
                    # retire drained sockets: ephemeral TCP connections
                    # would otherwise grow the rotation without bound
                    key = self.order.pop(j)
                    del self.queues[key]
                    if self.rr_idx > j:
                        self.rr_idx -= 1
                    if self.order:
                        self.rr_idx %= len(self.order)
                    else:
                        self.rr_idx = 0
                return item
        return None

    def _pump(self) -> None:
        k = self.kernel
        while True:
            item = self._next()
            if item is None:
                self.pumping = False
                return
            size, emit = item
            if self.host.tx_tb is not None and k.now >= k.bootstrap_end_ns:
                dep = self.host.tx_tb.depart(k.now, size)
            else:
                dep = k.now
            emit(dep)
            if dep > k.now:
                # the line is busy until `dep`: packets submitted before
                # then join the rotation, and the next pick happens when
                # the line frees (that is the whole point of RR)
                self.pumping = True
                k._push(dep, self._pump)
                return


class KMutex(File):
    """Kernel-side pthread mutex: lock state lives here so strictly
    serialized guest threads can never deadlock on a native futex
    (reference: futex.c/futex_table.c at the syscall layer)."""

    def __init__(self):
        super().__init__()
        self.owner: Optional[int] = None  # tid
        self.count = 0  # recursion depth (recursive mutexes)


class KCond(File):
    """Kernel-side pthread condvar: signal tickets + broadcast generation;
    waiters re-check through the listener plumbing."""

    def __init__(self):
        super().__init__()
        self.signals = 0
        self.generation = 0


class HostKernel:
    """Per-host world on the CPU side: ports, IP, deterministic counters
    (the CPU sibling of a row in the device engine's SimState; reference
    src/main/host/host.rs:96-205)."""

    def __init__(self, kernel: "NetKernel", name: str, host_id: int, node: int, ip: int):
        self.kernel = kernel
        self.name = name
        self.host_id = host_id
        self.node = node
        self.ip = ip
        # (proto, port) -> socket File (UdpSocket or listening TcpSocket)
        self.ports: dict[tuple[int, int], File] = {}
        # established/handshaking TCP, keyed (local_port, remote_ip, remote_port)
        self.tcp_conns: dict[tuple[int, int, int], T.TcpSocket] = {}
        # unix-domain namespace: (abstract, path) -> bound socket
        # (reference: unix.rs bind + abstract_unix_ns.rs)
        self.unix_ns: "dict[tuple[bool, str], UnixSocket]" = {}
        self.next_port = EPHEMERAL_PORT_BASE
        self.rng_counter = 0
        # per-host send counter: the seq half of the packet total-order key
        # (time, Packet<Local, src_host, seq), reference event.rs:104-155
        self.send_seq = 0
        self.procs: list[ManagedProcess] = []
        self.packets_sent = 0
        self.packets_dropped = 0
        self.bytes_sent = 0
        self.bytes_recv = 0
        # bandwidth shaping (reference: three relays per host,
        # host.rs:285-296; loopback is unlimited so it has no bucket)
        self.tx_tb: "Optional[shaping.TokenBucketRef]" = None
        self.rx_tb: "Optional[shaping.TokenBucketRef]" = None
        self.nic = NicQueue(kernel, self)  # engaged only under qdisc=rr
        self.rx_codel = shaping.CoDelRef()
        # forked-child pid allocator (see NetKernel._sys_fork): 100k pids
        # per host keeps ranges disjoint for up to ~21k hosts within pid_t
        self._fork_vpid_next = 1_000_000 + self.host_id * 100_000
        self.rx_backlog_bytes = 0
        self.codel_dropped = 0

    def alloc_fork_vpid(self) -> int:
        v = self._fork_vpid_next
        if v >= 1_000_000 + (self.host_id + 1) * 100_000:
            raise RuntimeError(
                f"host {self.name}: >100000 forked children; vpid range exhausted"
            )
        self._fork_vpid_next += 1
        return v

    def alloc_port(self, proto: int) -> int:
        while (proto, self.next_port) in self.ports:
            self.next_port += 1
        p = self.next_port
        self.next_port += 1
        return p

    # --- TCP bookkeeping (tcp demux tables) ------------------------------

    def bind_tcp_ephemeral(self, sock: T.TcpSocket) -> None:
        port = self.alloc_port(PROTO_TCP)
        sock.bound_port = port
        self.ports[(PROTO_TCP, port)] = sock

    def add_tcp_conn(self, sock: T.TcpSocket) -> None:
        self.tcp_conns[sock.conn_key()] = sock

    def drop_tcp_conn(self, sock: T.TcpSocket) -> None:
        key = sock.conn_key()
        if self.tcp_conns.get(key) is sock:
            del self.tcp_conns[key]
        pkey = (PROTO_TCP, sock.bound_port)
        if sock.bound_port and self.ports.get(pkey) is sock:
            del self.ports[pkey]


class NetKernel:
    """The serial event loop driving all managed processes."""

    def __init__(
        self,
        tables: RoutingTables,
        host_names: list[str],
        host_nodes: list[int],
        seed: int = 1,
        data_dir: str | os.PathLike = "shadow-tpu-data",
        syscall_latency_ns: int = 1_000,
        vdso_latency_ns: int = 10,
        max_unapplied_ns: int = 1_000_000,
        strace_mode: str = "standard",
        pcap: bool = False,
        host_ips: "Optional[list[int]]" = None,
        heartbeat_ns: int = 0,
        progress: bool = False,
        bw_up_bits: "Optional[list[int]]" = None,
        bw_down_bits: "Optional[list[int]]" = None,
        bootstrap_end_ns: int = 0,
        window_ns: "Optional[int]" = None,
        tcp_sack: bool = True,
        tcp_autotune: bool = True,
        qdisc: str = "fifo",
        use_memory_manager: bool = True,
        owned_hosts: "Optional[list[int]]" = None,
        data_dir_prepared: bool = False,
        manager_heartbeat: bool = True,
        write_hosts_file: bool = True,
        cpu_freq_hz: "Optional[list[int]]" = None,
        native_cpu_freq_hz: int = 3_000_000_000,
    ):
        self.tables = tables
        # the tables may live on the card: the kernel reads host copies
        self.lat = host_array(tables.lat_ns)
        self.rel = host_array(tables.rel)
        self.seed = seed
        self.syscall_latency_ns = syscall_latency_ns
        self.vdso_latency_ns = vdso_latency_ns
        self.max_unapplied_ns = max_unapplied_ns
        self.strace_mode = strace_mode
        # TCP behavior knobs (reference: experimental socket options,
        # configuration.rs:298-455; SACK tally tcp_retransmit_tally.cc,
        # buffer autotuning tcp.c:498-655)
        self.tcp_sack = tcp_sack
        self.tcp_autotune = tcp_autotune
        self.tcp_retransmits = 0  # aggregated loss-recovery resends
        if qdisc not in ("fifo", "rr"):
            raise ValueError(f"unknown qdisc {qdisc!r} (expected 'fifo' or 'rr')")
        # egress queuing discipline (reference QDiscMode,
        # configuration.rs:930): fifo = charge order is send order (no
        # queue needed); rr = NicQueue round-robins across sockets
        self.qdisc = qdisc
        # bulk-memory IO tier (VSYS_{WRITE,READ}_BULK): off -> -ENOSYS,
        # the shim falls back to the chunked shm path
        self.use_memory_manager = use_memory_manager
        # Host sharding (the parallel managed tier, runtime/hybrid.py
        # ParallelHybridScheduler): this kernel knows the *whole* world
        # (names, ips, routing — guests resolve any host) but executes
        # guests only for `owned_hosts`; None = own everything (serial).
        # Plays the role of one work-stealing worker thread in the
        # reference's scheduler (thread_per_core.rs:188-206), with the
        # host partition static instead of stolen.
        self.owned = None if owned_hosts is None else set(owned_hosts)
        self.manager_heartbeat = manager_heartbeat
        self.data_dir = pathlib.Path(data_dir)
        if not data_dir_prepared:
            if self.data_dir.exists():
                shutil.rmtree(self.data_dir)
            self.data_dir.mkdir(parents=True)

        self.dns = Dns()
        self.hosts: list[HostKernel] = []
        self.host_by_ip: dict[int, HostKernel] = {}
        self.host_by_name: dict[str, HostKernel] = {}
        base_ip = (11 << 24) | 1  # 11.0.0.1, reference ip auto-assign graph/mod.rs:356-422
        for i, (name, node) in enumerate(zip(host_names, host_nodes)):
            ip = host_ips[i] if host_ips is not None else base_ip + i
            hk = HostKernel(self, name, i, node, ip)
            self.hosts.append(hk)
            self.host_by_ip[hk.ip] = hk
            self.host_by_name[name] = hk
            self.dns.register(name, hk.ip)
        self.hosts_file = self.data_dir / "hosts"
        if write_hosts_file:
            self.dns.write_hosts_file(self.hosts_file)
        self._keys = rng.host_keys(seed, len(self.hosts))
        self._draw_cache: "dict[int, tuple[int, np.ndarray]]" = {}
        self.bootstrap_end_ns = bootstrap_end_ns
        for i, hk in enumerate(self.hosts):
            up = bw_up_bits[i] if bw_up_bits else 0
            down = bw_down_bits[i] if bw_down_bits else 0
            if up and up > 0:
                hk.tx_tb = shaping.TokenBucketRef(netstack.bw_bits_per_sec_to_refill(up))
            if down and down > 0:
                hk.rx_tb = shaping.TokenBucketRef(netstack.bw_bits_per_sec_to_refill(down))
            # CPU frequency-ratio delay model (reference cpu.rs:8-50): a
            # host simulated at half the native frequency pays double the
            # kernel-crossing time. Deterministic by construction — the
            # scaled charge replaces the reference's native-wall-clock
            # measurement, which its own determinism mode must disable.
            freq = cpu_freq_hz[i] if cpu_freq_hz else 0
            if freq and freq > 0:
                hk.syscall_latency_ns = max(
                    1, syscall_latency_ns * native_cpu_freq_hz // freq
                )
                hk.vdso_latency_ns = max(1, vdso_latency_ns * native_cpu_freq_hz // freq)
            else:
                hk.syscall_latency_ns = syscall_latency_ns
                hk.vdso_latency_ns = vdso_latency_ns

        self.now = 0
        self._seq = 0
        self._next_tid = 20_000  # thread ids, disjoint from vpids
        # heap entries are (time, variant, a, b, fn) where packets carry
        # variant 0 with (a, b) = (src_host, src_seq) and local events carry
        # variant 1 with (a, b) = (global_seq, 0) — the same total order the
        # device engine packs into its tie key (events.py; reference
        # event.rs:104-155, Packet sorts before Local at equal times)
        self.events: list[tuple[int, int, int, int, Callable[[], None]]] = []
        # conservative-window delivery clamp (reference worker.rs:399-402):
        # when set, non-loopback deliveries are clamped to the end of the
        # round window containing the send. The hybrid scheduler requires
        # this (the device engine clamps identically); None = continuous
        # timeline (no rounds), the legacy serial behavior.
        self.window_ns = window_ns
        # hybrid mode (runtime/hybrid.py): sends are buffered for the device
        # engine instead of being simulated locally
        self.hybrid = False
        self.pending_sends: "list[tuple]" = []
        self.payloads: "dict[tuple[int, int], tuple]" = {}
        # the true horizon for the progress line when run_window is driven
        # per round window (the per-window end would pin the bar at ~100%)
        self._progress_total: "Optional[int]" = None
        self.procs: list[ManagedProcess] = []
        self.event_log: list[tuple[int, str]] = []
        self.heartbeat_ns = heartbeat_ns
        self._next_hb = heartbeat_ns if heartbeat_ns > 0 else None
        from shadow_tpu_torch.utils.progress import ProgressLine

        self.progress = ProgressLine(progress)
        # per-syscall-name counts, aggregated like the reference's
        # worker-local-then-merged counters (worker.rs:428-475, sim_stats.rs)
        import collections

        self.syscall_counts: "collections.Counter[str]" = collections.Counter()
        self.pcap = None
        if pcap:
            from shadow_tpu_torch.utils.pcap import PcapDir

            self.pcap = PcapDir(
                self.data_dir,
                [h.name for h in self.hosts if self.owns(h.host_id)],
            )

    def owns(self, host_id: int) -> bool:
        return self.owned is None or host_id in self.owned

    # --- deterministic draws (same threefry streams as the engine) -------

    _DRAW_BLOCK = 512

    def _loss_draw(self, src: HostKernel) -> float:
        """One uniform from the host's counter stream. Values are computed
        in blocks of 512 on CPU tensors (identical per-counter values to
        the device engine's uniform_f32) so the serial kernel doesn't pay
        a threefry call per packet."""
        c = src.rng_counter
        cached = self._draw_cache.get(src.host_id)
        if cached is None or not (cached[0] <= c < cached[0] + self._DRAW_BLOCK):
            vals = rng.uniform_block(
                self._keys[src.host_id], c & rng.MASK32, self._DRAW_BLOCK
            ).numpy()
            cached = (c, vals)
            self._draw_cache[src.host_id] = cached
        src.rng_counter += 1
        return float(cached[1][c - cached[0]])

    def _random_bytes(self, host: HostKernel, n: int) -> bytes:
        out = rng.raw_bytes(self._keys[host.host_id], host.rng_counter, n)
        host.rng_counter += 1
        return out

    # --- config ----------------------------------------------------------

    def add_process(self, spec: ProcessSpec, vpid: "Optional[int]" = None) -> ManagedProcess:
        host = self.host_by_name[spec.host]
        if not self.owns(host.host_id):
            raise ValueError(
                f"host {spec.host!r} (id {host.host_id}) is not owned by this kernel shard"
            )
        # explicit vpid: the parallel scheduler numbers processes globally
        # so sharded runs match the serial kernel's pids exactly
        proc = ManagedProcess(self, spec, host, vpid=vpid if vpid is not None else 1000 + len(self.procs))
        self.procs.append(proc)
        host.procs.append(proc)
        self._push(spec.start_ns, lambda p=proc: self._start_proc(p))
        if spec.shutdown_ns is not None:
            # the reference sends shutdown_signal at shutdown_time
            # (configuration.rs:560-640); signal plumbing is not built yet,
            # so terminate natively — still at a deterministic sim time
            self._push(spec.shutdown_ns, lambda p=proc: self._shutdown_proc(p))
        return proc

    # --- signals (reference: shim_signals.c, process.rs, syscall/signal) --

    _SIG_DFL_IGNORED = {17, 18, 23, 28}  # SIGCHLD, SIGCONT, SIGURG, SIGWINCH
    # default action "stop" — a stopped-process model does not exist here,
    # so these are dropped rather than (wrongly) treated as fatal
    _SIG_DFL_STOP = {19, 20, 21, 22}  # SIGSTOP, SIGTSTP, SIGTTIN, SIGTTOU
    ERESTART = 512  # kernel-internal ERESTARTSYS: shim re-issues the syscall

    def deliver_signal(self, proc: ManagedProcess, sig: int) -> None:
        """Queue a signal for a process at the current sim time, directed
        at its main thread (POSIX allows any thread with the signal
        unblocked; the choice is fixed for determinism). Handler-registered
        signals ride the next IPC reply (the shim raises them natively);
        default-disposition fatal signals terminate the process; ignored
        signals are dropped. SA_RESTART handlers restart the interrupted
        file syscall (the shim resends it on ERESTART)."""
        if isinstance(proc, GuestThread):
            proc = proc.process
        if proc.exited:
            return
        kind = proc.sig_handlers.get(sig, 0)
        if sig == 9:  # SIGKILL cannot be caught, ignored, or blocked
            kind = 0
        bit = 1 << (sig - 1)
        if sig != 9 and all(
            t.sig_mask & bit for t in proc.threads if t.state != "exited"
        ):
            # every live thread blocks it: stays pending until an unblock
            # (rt_sigprocmask reports mask changes via VSYS_SIGMASK)
            proc.blocked_pending.append(sig)
            return
        if kind == 1:
            return
        if kind == 0:
            if sig in self._SIG_DFL_IGNORED or sig in self._SIG_DFL_STOP:
                return
            self._terminate_by_signal(proc, sig)
            return
        restart = bool(kind & 0x10)
        # the main thread may have pthread_exit'ed while workers run; pick
        # the first live thread with the signal unblocked (lowest tid, the
        # deterministic POSIX-allowed choice)
        thread = next(
            (
                t
                for t in proc.threads
                if t.state != "exited" and (sig == 9 or not (t.sig_mask & bit))
            ),
            None,
        )
        if thread is None:
            return
        thread.pending_sigs.append(sig)
        if thread.state == "blocked" and thread.waiter is not None:
            w = thread.waiter
            if not w.sig_interruptible:
                return  # rides the reply when the wait completes
            w._detach()
            thread.now = max(thread.now, self.now)
            thread.state = "running"
            if w.on_interrupt is not None:
                w.on_interrupt()  # syscall-specific EINTR reply (never restarts)
            elif restart and w.restartable:
                thread._reply(-self.ERESTART)
            else:
                thread._reply(-EINTR)
            self._service(thread)

    def _terminate_by_signal(self, proc: ManagedProcess, sig: int) -> None:
        """Default disposition: the real process gets the real signal, so
        waitpid status is authentic (exit_code = -sig via Popen)."""
        self.event_log.append(
            (self.now, f"killed {proc.host.name}/{proc.vpid} sig={sig}")
        )
        # terminate natively and settle the wait status BEFORE mark_exited:
        # it wakes waitpid waiters, whose shim-side real reap must find the
        # child already dying
        if proc.popen is not None and proc.popen.poll() is None:
            proc.popen.send_signal(sig)
            try:
                proc.exit_code = proc.popen.wait(timeout=5)
            except subprocess.TimeoutExpired:  # blocked the signal natively
                proc.popen.kill()
                proc.exit_code = proc.popen.wait()
        elif proc.popen is None and proc.real_pid is not None:
            try:  # a forked child: the guest parent reaps the real status
                os.kill(proc.real_pid, sig)
            except OSError:
                pass
            proc.exit_code = -sig
        proc.wait_status = sig if proc.exit_code == -sig else (proc.exit_code or 0) << 8
        proc.mark_exited()  # detaches waiters, closes fds, wakes waitpid
        proc.kill()

    def _sys_sigaction(self, proc, msg):
        proc.sig_handlers[int(msg.a[1])] = int(msg.a[2])
        proc._reply(0)
        return True

    @staticmethod
    def _itimer_remaining(process: ManagedProcess, now: int) -> int:
        return max(0, process.itimer_fire_ns - now) if process.itimer_fire_ns else 0

    def _arm_itimer(
        self, process: ManagedProcess, base_ns: int, value_ns: int, interval_ns: int
    ) -> None:
        process.itimer_gen += 1
        if value_ns <= 0:
            process.itimer_fire_ns = 0
            process.itimer_interval_ns = 0
            return
        process.itimer_fire_ns = base_ns + value_ns
        process.itimer_interval_ns = interval_ns
        gen = process.itimer_gen
        self._push(process.itimer_fire_ns, lambda: self._itimer_fire(process, gen))

    def _itimer_fire(self, process: ManagedProcess, gen: int) -> None:
        if gen != process.itimer_gen or process.exited:
            return  # re-armed or cancelled since scheduled
        expiry = process.itimer_fire_ns
        interval = process.itimer_interval_ns
        process.itimer_gen += 1
        if interval > 0:
            # re-arm from the expiry, not the (possibly later) proc clock —
            # the cadence must not drift (as with the kernel's own timers)
            process.itimer_fire_ns = expiry + interval
            new_gen = process.itimer_gen
            self._push(process.itimer_fire_ns, lambda: self._itimer_fire(process, new_gen))
        else:
            process.itimer_fire_ns = 0
        self.deliver_signal(process, 14)  # SIGALRM

    def _sys_alarm(self, proc, msg):
        remaining = self._itimer_remaining(proc.process, proc.now)
        self._arm_itimer(proc.process, proc.now, int(msg.a[1]) * 1_000_000_000, 0)
        proc._reply((remaining + 999_999_999) // 1_000_000_000)
        return True

    def _sys_setitimer(self, proc, msg):
        process = proc.process
        old_val = self._itimer_remaining(process, proc.now)
        old_itv = process.itimer_interval_ns
        self._arm_itimer(process, proc.now, int(msg.a[1]), int(msg.a[2]))
        proc._reply(0, a=(0, 0, old_val, old_itv))
        return True

    def _sys_getitimer(self, proc, msg):
        process = proc.process
        proc._reply(
            0,
            a=(0, 0, self._itimer_remaining(process, proc.now), process.itimer_interval_ns),
        )
        return True

    def _sys_kill(self, proc, msg):
        vpid, sig = int(msg.a[1]), int(msg.a[2])
        target = proc.process if vpid == 0 else next(
            (p for p in self.procs if p.vpid == vpid), None
        )
        if target is None or target.exited:
            proc._reply(-ESRCH)
            return True
        if not 0 <= sig <= 64:
            proc._reply(-EINVAL)
            return True
        if sig == 0:  # existence probe
            proc._reply(0)
            return True
        if target is proc.process:
            # queue first so the signal rides this very reply (handler runs
            # before kill() returns, as on Linux); a fatal default kills the
            # process with no reply at all
            self.deliver_signal(target, sig)
            if proc.dead:
                return True
            proc._reply(0)
            return True
        proc._reply(0)
        # deliver at the sender's sim time (its clock may be ahead of the
        # kernel's), like every other cross-process effect (_send_packet)
        self._push(proc.now, lambda: self.deliver_signal(target, sig))
        return True

    def _sys_pause(self, proc, msg):
        if proc.pending_sigs:
            proc._reply(-EINTR)
            return True
        Waiter(self, proc, [], lambda: False, restartable=False)
        return False

    # --- threads (reference: ManagedThread + native_clone,
    # managed_thread.rs:294-365; scheduling stays strictly serial) --------

    def _sys_thread_create(self, proc, msg):
        process = proc.process
        tid = self._next_tid
        self._next_tid += 1
        ipc = I.IpcBlock(
            tag=f"h{process.host.host_id}p{process.vpid}t{tid}",
            vdso_latency_ns=process.host.vdso_latency_ns,
            syscall_latency_ns=process.host.syscall_latency_ns,
            max_unapplied_ns=self.max_unapplied_ns,
        )
        t = GuestThread(process, tid, ipc)
        t.now = proc.now
        process.threads.append(t)
        # the creator (still released) spawns the native thread after this
        # reply; the new thread's STARTED handshake is consumed once the
        # whole simulation parks (event below), keeping one-at-a-time
        self._push(proc.now, lambda: self._start_thread(t))
        proc._reply(0, a=(0, 0, tid), buf=ipc.path.encode())
        return True

    def _start_thread(self, t: GuestThread) -> None:
        if t.dead or t.state != "pending":
            return
        msg = t._recv(max_wall_s=30.0)
        if msg is None:  # process died before the thread came up
            t.process.mark_exited()
            return
        if msg is False:
            raise SimPanic(
                f"thread {t.tid} of {t.process.host.name}/{t.process.vpid} never "
                f"announced itself (native start failure?)"
            )
        if msg.kind != I.MSG_THREAD_START:
            raise SimPanic(f"thread {t.tid}: expected THREAD_START, got {msg.kind}")
        t.now = max(t.now, self.now)
        t.state = "running"
        self.event_log.append((self.now, f"thread-start {t.process.host.name}/{t.tid}"))
        t.ipc.set_time(SIM_START_UNIX_NS + t.now, 0)
        t.ipc.send_to_shim(I.make_msg(I.MSG_SYSCALL_DONE, ret=0))
        self._service(t)

    def _sys_thread_exit(self, proc, msg):
        proc.retval = int(msg.a[1])
        self.event_log.append((proc.now, f"thread-exit {proc.process.host.name}/{proc.tid}"))
        proc._reply(0)  # release it to finish dying natively
        proc.mark_exited()
        if all(t.state == "exited" for t in proc.process.threads):
            proc.process.mark_exited()  # pthread_exit from main + workers done
        return True

    def _sys_thread_join(self, proc, msg):
        tid = int(msg.a[1])
        target = next((t for t in proc.process.threads if t.tid == tid), None)
        if target is None or target is proc:
            proc._reply(-EINVAL)
            return True

        def check() -> bool:
            if target.state != "exited":
                return False
            proc._reply(0, a=(0, 0, target.retval))
            return True

        if check():
            return True
        Waiter(self, proc, [target.exit_evt], check, sig_interruptible=False)
        return False

    def _sys_thread_failed(self, proc, msg):
        tid = int(msg.a[1])
        target = next((t for t in proc.process.threads if t.tid == tid), None)
        if target is not None:
            target.mark_exited()
            if target.ipc is not None:
                target.ipc.close()
                target.ipc = None
        else:  # native fork() failed: cancel the pre-created child process
            child = next((p for p in self.procs if p.vpid == tid), None)
            if child is not None and child.main and child.main.state == "pending":
                child.waited = True  # the guest never saw this vpid
                child.mark_exited()
        proc._reply(0)
        return True

    # --- pthread sync objects (kernel-side so serialized threads never
    # contend on a real futex; reference: futex.c/futex_table.c) ----------

    def _sys_mutex_lock(self, proc, msg):
        m = proc.process.mutexes.setdefault(int(msg.a[1]), KMutex())
        recursive = int(msg.a[2]) == 1  # PTHREAD_MUTEX_RECURSIVE_NP
        if m.owner == proc.tid and recursive:
            m.count += 1
            proc._reply(0)
            return True
        if m.owner is None:
            m.owner = proc.tid
            m.count = 1
            proc._reply(0)
            return True

        def claim() -> bool:
            if m.owner is not None:
                return False
            m.owner = proc.tid
            m.count = 1
            proc._reply(0)
            return True

        Waiter(self, proc, [m], claim, sig_interruptible=False)
        return False

    def _sys_mutex_trylock(self, proc, msg):
        m = proc.process.mutexes.setdefault(int(msg.a[1]), KMutex())
        recursive = int(msg.a[2]) == 1
        if m.owner == proc.tid and recursive:
            m.count += 1
            proc._reply(0)
        elif m.owner is None:
            m.owner = proc.tid
            m.count = 1
            proc._reply(0)
        else:
            proc._reply(-EBUSY)
        return True

    def _sys_mutex_unlock(self, proc, msg):
        m = proc.process.mutexes.setdefault(int(msg.a[1]), KMutex())
        if m.owner != proc.tid:
            proc._reply(-EPERM)
            return True
        m.count -= 1
        if m.count > 0:  # recursive: still held
            proc._reply(0)
            return True
        m.owner = None
        m.notify()  # wake blocked lockers first: the woken thread runs via a
        proc._reply(0)  # nested service while the unlocker stays un-replied
        return True

    def _sys_cond_wait(self, proc, msg):
        process = proc.process
        c = process.conds.setdefault(int(msg.a[1]), KCond())
        m = process.mutexes.setdefault(int(msg.a[2]), KMutex())
        timeout_ns = int(msg.a[3])
        if m.owner != proc.tid:
            proc._reply(-EPERM)
            return True
        m.owner = None
        st = {"woke": None, "timed_out": False, "gen": c.generation}

        def check() -> bool:
            if st["woke"] is None:
                if c.generation != st["gen"]:
                    st["woke"] = "signal"
                elif c.signals > 0:
                    c.signals -= 1
                    st["woke"] = "signal"
                elif st["timed_out"]:
                    st["woke"] = "timeout"
                else:
                    return False
            # woken (or timed out): must re-acquire the mutex to return
            if m.owner is not None:
                return False
            m.owner = proc.tid
            proc._reply(-ETIMEDOUT if st["woke"] == "timeout" else 0)
            return True

        if timeout_ns >= 0:
            def fire_timeout():
                if st["woke"] is None:
                    st["timed_out"] = True
                    c.notify()

            self._push(proc.now + timeout_ns, fire_timeout)
        m.notify()  # other lockers may take the mutex while we wait
        if check():  # a thread that ran during notify may have signaled us
            return True
        Waiter(self, proc, [c, m], check, sig_interruptible=False)
        return False

    def _sys_cond_signal(self, proc, msg):
        c = proc.process.conds.setdefault(int(msg.a[1]), KCond())
        if int(msg.a[2]):  # broadcast
            c.generation += 1
        else:
            c.signals += 1
        c.notify()  # woken waiters run nested before the signaler resumes
        proc._reply(0)
        return True

    # --- raw futex (reference: futex.c, futex_table.c, syscall/futex.c) --
    # The shim already performed the *uaddr == val check (race-free under
    # strict serialization); the kernel owns per-address-space FIFO wait
    # queues. All guest clocks serve the unix-epoch sim time, so absolute
    # timeouts (monotonic or realtime) convert identically.

    def _futex_remove(self, process: ManagedProcess, tid: int) -> None:
        for addr, q in list(process.futex_q.items()):
            if tid in q:
                q.remove(tid)
                if not q:
                    del process.futex_q[addr]
                break
        process.futex_woken.discard(tid)

    @staticmethod
    def _futex_prune(process: ManagedProcess, q: "list[int]") -> None:
        """Drop waiters whose thread died while queued so a wake is never
        spent on a corpse (Linux only ever wakes live waiters)."""
        live = {t.tid for t in process.threads if t.state != "exited"}
        q[:] = [t for t in q if t in live]

    def _sys_futex_wait(self, proc, msg):
        process = proc.process
        timeout_ns, mode = int(msg.a[2]), int(msg.a[3])
        addr = int(msg.a[1])
        tid = proc.tid
        process.futex_q.setdefault(addr, []).append(tid)

        def check() -> bool:
            if tid in process.futex_woken:
                process.futex_woken.discard(tid)
                proc._reply(0)
                return True
            return False

        timeout_at = None
        if timeout_ns >= 0:
            if mode == 0:  # relative
                timeout_at = proc.now + timeout_ns
            else:  # absolute on the unix-epoch sim clock
                timeout_at = max(timeout_ns - SIM_START_UNIX_NS, self.now)

        def on_timeout():
            self._futex_remove(process, tid)
            proc._reply(-ETIMEDOUT)

        def on_interrupt():
            self._futex_remove(process, tid)
            proc._reply(-EINTR)

        Waiter(
            self,
            proc,
            [process.futex_hub],
            check,
            timeout_at=timeout_at,
            on_timeout=on_timeout,
            on_interrupt=on_interrupt,
            restartable=False,
        )
        return False

    def _sys_futex_wake(self, proc, msg):
        process = proc.process
        addr, maxn = int(msg.a[1]), int(msg.a[2])
        q = process.futex_q.get(addr, [])
        self._futex_prune(process, q)
        n = min(max(maxn, 0), len(q))
        for tid in q[:n]:  # FIFO wake order, like the reference's table
            process.futex_woken.add(tid)
        del q[:n]
        if not q:
            process.futex_q.pop(addr, None)
        if n:
            process.futex_hub.notify()
        proc._reply(n)
        return True

    def _sys_futex_requeue(self, proc, msg):
        process = proc.process
        addr, nwake, nreq = int(msg.a[1]), int(msg.a[2]), int(msg.a[3])
        addr2 = int(msg.a[5])
        q = process.futex_q.get(addr, [])
        self._futex_prune(process, q)
        n = min(max(nwake, 0), len(q))
        for tid in q[:n]:
            process.futex_woken.add(tid)
        del q[:n]
        moved = 0
        if nreq > 0 and q:
            moved = min(nreq, len(q))
            process.futex_q.setdefault(addr2, []).extend(q[:moved])
            del q[:moved]
        if not q:
            process.futex_q.pop(addr, None)
        if n:
            process.futex_hub.notify()
        proc._reply(n + moved)
        return True

    def _sys_sigmask(self, proc, msg):
        """rt_sigprocmask, kernel view (reference syscall/signal.c +
        shim_shmem blocked-mask handoff): record the thread's new blocked
        mask, then deliver any process-pending signals it just unblocked."""
        proc.sig_mask = int(msg.a[1]) & ((1 << 64) - 1)
        proc._reply(0)
        process = proc.process
        if process.blocked_pending:
            deliverable = [
                s for s in process.blocked_pending if not (proc.sig_mask >> (s - 1)) & 1
            ]
            for s in deliverable:
                process.blocked_pending.remove(s)
                self.deliver_signal(process, s)
        return True

    # --- fork/wait (reference: process.rs spawn/fork + waitpid) ----------

    def _sys_fork(self, proc, msg):
        parent = proc.process
        # per-host deterministic pid range: forked children get pids that
        # do not depend on global event interleaving, so serial and
        # host-sharded parallel runs assign identical pids
        vpid = parent.host.alloc_fork_vpid()
        child = ManagedProcess(self, parent.spec, parent.host, vpid)
        child.parent = parent
        child._stdout_path = parent._stdout_path
        child._stderr_path = parent._stderr_path
        child.sig_handlers = dict(parent.sig_handlers)
        # fd table: descriptors shared with the parent (POSIX fork)
        for fd, f in parent.fdtab._files.items():
            child.fdtab._files[fd] = f
            f.refcount += 1
        child.fdtab.native_used = set(parent.fdtab.native_used)
        # address space: the child inherits the parent's mappings/break
        child.mappings = dict(parent.mappings)
        child.brk_end = parent.brk_end
        ipc = I.IpcBlock(
            tag=f"h{parent.host.host_id}p{vpid}",
            vdso_latency_ns=parent.host.vdso_latency_ns,
            syscall_latency_ns=parent.host.syscall_latency_ns,
            max_unapplied_ns=self.max_unapplied_ns,
        )
        main = GuestThread(child, vpid, ipc)
        main.now = proc.now
        child.threads.append(main)
        exe = pathlib.Path(parent.spec.args[0]).name
        outdir = self.data_dir / parent.host.name
        child.strace = StraceFile(
            outdir / f"{exe}.{vpid}.strace", vpid, mode=self.strace_mode
        )
        self.procs.append(child)
        parent.host.procs.append(child)
        self._push(proc.now, lambda: self._start_forked(child))
        proc._reply(0, a=(0, 0, vpid), buf=ipc.path.encode())
        return True

    def _start_forked(self, child: ManagedProcess) -> None:
        main = child.main
        if child.exited or main.state != "pending":
            return
        msg = main._recv(max_wall_s=10.0)
        if msg is None or msg is False:
            # the real fork failed or the child died before announcing
            child.waited = True  # not reapable: the guest never saw it run
            child.mark_exited()
            self.event_log.append((self.now, f"fork-lost {child.host.name}/{child.vpid}"))
            return
        if msg.kind != I.MSG_CHILD_START:
            raise SimPanic(f"forked child {child.vpid}: expected CHILD_START, got {msg.kind}")
        child.real_pid = int(msg.a[1])
        main.now = max(main.now, self.now)
        main.state = "running"
        self.event_log.append((self.now, f"fork {child.host.name}/{child.vpid}"))
        main.ipc.set_time(SIM_START_UNIX_NS + main.now, 0)
        main.ipc.send_to_shim(I.make_msg(I.MSG_SYSCALL_DONE, ret=0))
        self._service(main)

    def _sys_waitpid(self, proc, msg):
        vpid, nohang = int(msg.a[1]), bool(int(msg.a[2]))
        parent = proc.process

        # re-scan per check: a child forked by another guest thread after a
        # blocking waitpid(-1) begins must still be waitable
        def matching():
            return [
                c
                for c in self.procs
                if c.parent is parent and not c.waited and (vpid == -1 or c.vpid == vpid)
            ]

        if not matching():
            proc._reply(-ECHILD)
            return True

        def check() -> bool:
            remaining = matching()
            if not remaining:
                # another thread reaped the last matching child while we were
                # blocked; real Linux returns ECHILD, not an eternal block
                proc._reply(-ECHILD)
                return True
            for c in remaining:
                if c.exited:
                    c.waited = True
                    proc._reply(
                        c.vpid, a=(0, 0, c.wait_status, c.real_pid or 0)
                    )
                    return True
            return False

        if check():
            return True
        if nohang:
            proc._reply(0)
            return True
        Waiter(self, proc, [parent.child_evt], check, sig_interruptible=False)
        return False

    def _shutdown_proc(self, proc: ManagedProcess) -> None:
        """Config shutdown_time: deliver SIGTERM at sim time (reference
        sends shutdown_signal, configuration.rs:560-640). A process with a
        SIGTERM handler gets to run it and exit on its own; the default
        disposition terminates. Either way the exit is expected."""
        if proc.state == "exited":
            return
        self.event_log.append((self.now, f"shutdown {proc.host.name}/{proc.vpid}"))
        proc.shutdown_requested = True
        self.deliver_signal(proc, 15)

    # --- event machinery --------------------------------------------------

    def _push(self, t: int, fn: Callable[[], None]) -> None:
        heapq.heappush(self.events, (t, 1, self._seq, 0, fn))
        self._seq += 1

    def _push_packet(self, t: int, src_host: int, src_seq: int, fn: Callable[[], None]) -> None:
        """Network-plane event carrying the packet total-order key."""
        heapq.heappush(self.events, (t, 0, src_host, src_seq, fn))

    def _grid_end(self, t: int) -> int:
        """End of the round window containing time t (windows are fixed
        multiples of window_ns, half-open [k*W, (k+1)*W); the engine pops
        events strictly below the window end the same way)."""
        return (t // self.window_ns + 1) * self.window_ns

    def run(self, until_ns: int) -> None:
        try:
            self.run_window(until_ns, inclusive=True)
            self.finish(until_ns)
        finally:
            self.shutdown_check()

    def finish(self, until_ns: int) -> None:
        """Sim time runs to until_ns even after the queue drains; keep the
        heartbeat cadence to the end (manager.rs:738-780)."""
        hb = self.heartbeat_ns
        while self._next_hb is not None and self._next_hb <= until_ns:
            self.now = max(self.now, self._next_hb)
            self._heartbeat()
            self._next_hb += hb
        self.progress.finish(until_ns)

    def run_window(
        self, end_ns: int, inclusive: bool = False, stop_at_send_grid: bool = False
    ) -> None:
        """Drain events with t < end_ns (or <= when inclusive), advancing
        heartbeats on cadence. The hybrid driver calls this per round
        window; run() calls it once for the whole horizon.

        stop_at_send_grid (hybrid free-run): once a send has been buffered,
        tighten the horizon to the end of that send's round window — the
        device engine must process the send before the CPU may cross that
        boundary (its arrivals land at or after it)."""
        hb = self.heartbeat_ns
        total = self._progress_total if self._progress_total is not None else end_ns
        while self.events:
            if stop_at_send_grid and self.pending_sends:
                lim = self._grid_end(self.pending_sends[0][0])
                if lim < end_ns or (inclusive and lim <= end_ns):
                    end_ns, inclusive = lim, False
                stop_at_send_grid = False
            if self.progress.enabled:
                self.progress.update(self.now, total)
            t = self.events[0][0]
            hb_due = self._next_hb is not None and (
                self._next_hb <= end_ns if inclusive else self._next_hb < end_ns
            )
            if hb_due and self._next_hb < t:
                self.now = max(self.now, self._next_hb)
                self._heartbeat()
                self._next_hb += hb
                continue
            if (t > end_ns) if inclusive else (t >= end_ns):
                break
            fn = heapq.heappop(self.events)[4]
            self.now = max(self.now, t)
            fn()

    def _heartbeat(self) -> None:
        """Manager heartbeat + per-host tracker lines (reference:
        manager.rs:738-780 heartbeat messages; tracker.c:407-450 per-host
        bytes in/out heartbeats)."""
        from shadow_tpu_torch.utils.shadow_log import slog

        self.progress.clear()  # don't interleave with the \r status line
        if self.manager_heartbeat:
            total_sc = sum(self.syscall_counts.values())
            slog(
                "info",
                self.now,
                "manager",
                f"heartbeat: {total_sc} syscalls, "
                f"{sum(h.packets_sent for h in self.hosts)} packets",
            )
        for h in self.hosts:
            if not h.procs:
                continue
            slog(
                "info",
                self.now,
                h.name,
                f"tracker: bytes_sent={h.bytes_sent} bytes_recv={h.bytes_recv} "
                f"packets_sent={h.packets_sent} packets_dropped={h.packets_dropped}",
            )

    def stats(self) -> dict:
        """Aggregate counters for sim-stats.json (reference sim_stats.rs)."""
        return {
            "syscalls_handled": sum(self.syscall_counts.values()),
            "syscall_counts": dict(sorted(self.syscall_counts.items())),
            "packets_sent": sum(h.packets_sent for h in self.hosts),
            "packets_dropped": sum(h.packets_dropped for h in self.hosts),
            "codel_dropped": sum(h.codel_dropped for h in self.hosts),
            "bytes_sent": sum(h.bytes_sent for h in self.hosts),
            "bytes_recv": sum(h.bytes_recv for h in self.hosts),
            "processes": len(self.procs),
            # per-host breakdown (the tracker's final sample; reference
            # tracker.c heartbeats + sim-stats detail)
            "hosts": {
                h.name: {
                    "bytes_sent": h.bytes_sent,
                    "bytes_recv": h.bytes_recv,
                    "packets_sent": h.packets_sent,
                    "packets_dropped": h.packets_dropped,
                    "codel_dropped": h.codel_dropped,
                }
                for h in self.hosts
            },
        }

    def shutdown(self) -> None:
        for p in self.procs:
            p.kill()
        if self.pcap:
            self.pcap.close()

    def shutdown_check(self) -> None:
        """Reap naturally-exited children (expected_final_state,
        reference configuration.rs:582 + worker.rs:485-487)."""
        for p in self.procs:
            if p.state == "exited" and p.popen is not None and p.exit_code is None:
                p.exit_code = p.popen.wait()

    def unexpected_final_states(self) -> "list[str]":
        out = []
        for p in self.procs:
            if p.parent is not None:
                continue  # forked children answer to their guest parent
            if p.shutdown_requested and p.state == "exited":
                continue  # a requested shutdown is an expected exit
            want = p.spec.expected_final_state
            if p.stopped_by_shadow:
                got = "running"  # alive at sim end, killed by shadow itself
            else:
                got = "exited" if p.state == "exited" else "running"
            if want != got or (got == "exited" and (p.exit_code or 0) != 0):
                out.append(
                    f"{p.host.name}/{pathlib.Path(p.spec.args[0]).name}: "
                    f"expected {want}, got {got} (exit_code={p.exit_code})"
                )
        return out

    # --- process driving --------------------------------------------------

    def _start_proc(self, proc: ManagedProcess) -> None:
        if proc.state != "pending":  # e.g. shut down before its start event
            return
        proc.spawn(self.now)
        self.event_log.append((self.now, f"start {proc.host.name} vpid={proc.vpid}"))
        # reply START_RES: a[0] = virtual pid
        proc.ipc.set_time(SIM_START_UNIX_NS + self.now, 0)
        # a[0]=vpid, a[1]=host ip (the shim needs it for getifaddrs)
        proc.ipc.send_to_shim(I.make_msg(I.MSG_START_RES, a=(proc.vpid, proc.host.ip)))
        self._service(proc.main)

    def _service(self, thread: GuestThread) -> None:
        """Run one thread until it blocks or exits, emulating each syscall
        (the ManagedThread::resume loop, managed_thread.rs:156-267).
        Exactly one thread of the whole simulation executes guest code at
        a time: every other thread is parked on its own channel, and wakes
        happen through nested _service calls while the waker stays
        un-replied."""
        proc = thread.process
        while True:
            if thread.dead:  # e.g. fatal self-kill mid-service
                return
            msg = thread._recv()
            if msg is None:
                proc.mark_exited()
                self.event_log.append(
                    (thread.now, f"exit-native {proc.host.name}/{proc.vpid}")
                )
                return
            if msg.kind == I.MSG_PROC_EXIT:
                thread._reply(0)
                proc.wait_status = (proc.exit_code or 0) << 8
                proc.mark_exited()
                self.event_log.append((thread.now, f"exit {proc.host.name}/{proc.vpid}"))
                return
            if msg.kind != I.MSG_SYSCALL:
                raise SimPanic(f"unexpected msg kind {msg.kind}")
            if not self._syscall(thread, msg):
                if not thread.dead:
                    thread.state = "blocked"
                return  # reply deferred to a later event

    # --- syscall dispatch (syscall_handler.c:229-463 analogue) ------------

    def _syscall(self, proc: ManagedProcess, msg: I.ShimMsg) -> bool:
        """Emulate one syscall; returns False if the reply is deferred
        (blocking)."""
        code = int(msg.a[0])
        # fold shim-accumulated local latency, then charge the syscall cost
        # (per-host: scaled by the CPU frequency ratio, cpu.rs:8-50 role)
        proc.now += int(msg.a[4]) + proc.process.host.syscall_latency_ns
        name = I.VSYS_NAMES.get(code, str(code))
        self.syscall_counts[name] += 1
        args = tuple(int(x) for x in msg.a[1:4])
        proc.syscall_log.append((proc.now, name, args))
        proc._pending = (name, ", ".join(str(a) for a in args))

        handler = _DISPATCH.get(code)
        if handler is None:
            proc._reply(-ENOSYS)
            return True
        return handler(self, proc, msg)

    # --- generic helpers --------------------------------------------------

    def _file(self, proc: ManagedProcess, fd: int) -> Optional[File]:
        return proc.fdtab.get(fd)

    def _close_fd(self, proc: ManagedProcess, fd: int) -> int:
        host = proc.host
        f = proc.fdtab.remove(fd)  # None = missing fd or other refs remain
        if f is not None:
            # epoll(7): the kernel auto-deregisters an fd from every epoll
            # interest list once all descriptors for the file are closed
            for other in list(proc.fdtab._files.values()):
                if isinstance(other, Epoll):
                    w = other.watches.get(fd)
                    if w is not None and w.file is f:
                        other.ctl(2, fd, None, 0, 0)  # EPOLL_CTL_DEL
            # release port bindings on last close
            if isinstance(f, UdpSocket) and f.bound_port:
                pk = (PROTO_UDP, f.bound_port)
                if host.ports.get(pk) is f:
                    del host.ports[pk]
            if isinstance(f, T.TcpSocket):
                pk = (PROTO_TCP, f.bound_port)
                if f.bound_port and host.ports.get(pk) is f and f.state in (T.CLOSED, T.LISTEN):
                    del host.ports[pk]
            if isinstance(f, UnixSocket) and f.bound is not None:
                # accepted children share the listener's address; only the
                # namespace owner releases it
                if host.unix_ns.get(f.bound) is f:
                    del host.unix_ns[f.bound]
            f.on_close(self, proc)
        return 0

    # --- time & identity --------------------------------------------------

    def _sys_yield(self, proc, msg):
        proc._reply(0)
        return True

    def _sys_clock_gettime(self, proc, msg):
        proc._reply(0, a=(0, SIM_START_UNIX_NS + proc.now))
        return True

    def _sys_getpid(self, proc, msg):
        proc._reply(proc.vpid)
        return True

    def _sys_nanosleep(self, proc, msg):
        wake_at = proc.now + int(msg.a[1])
        Waiter(
            self,
            proc,
            [],
            lambda: False,
            timeout_at=wake_at,
            on_timeout=lambda: proc._reply(0),
            # a signal interrupts the sleep: EINTR + remaining time
            on_interrupt=lambda: proc._reply(
                -EINTR, a=(0, 0, max(0, wake_at - proc.now))
            ),
        )
        return False

    def _sys_gethostname(self, proc, msg):
        proc._reply(0, buf=proc.host.name.encode() + b"\0")
        return True

    def _sys_uname(self, proc, msg):
        # buf: nodename only; the shim fills the static fields
        proc._reply(0, buf=proc.host.name.encode() + b"\0")
        return True

    def _sys_resolve(self, proc, msg):
        name = I.msg_payload(msg).split(b"\0")[0].decode(errors="replace")
        if name == proc.host.name or name in ("localhost", "localhost.localdomain"):
            proc._reply(0, a=(0, 0, proc.host.ip))
            return True
        ip = self.dns.resolve(name)
        if ip is None:
            proc._reply(-2)  # maps to EAI_NONAME in the shim
            return True
        proc._reply(0, a=(0, 0, ip))
        return True

    def _sys_resolve_rev(self, proc, msg):
        """Reverse DNS: ip -> registered hostname (dns.c:180
        dns_resolveIPToAddress analogue)."""
        ip = int(msg.a[1])
        if ip == proc.host.ip or (ip >> 24) == (LOCALHOST_NET >> 24):
            proc._reply(0, buf=proc.host.name.encode() + b"\0")
            return True
        name = self.dns.reverse(ip)
        if name is None:
            proc._reply(-2)  # EAI_NONAME on the shim side
            return True
        proc._reply(0, buf=name.encode() + b"\0")
        return True

    def _sys_getrandom(self, proc, msg):
        n = min(int(msg.a[1]), I.SHIM_BUF_SIZE)
        proc._reply(n, buf=self._random_bytes(proc.host, n))
        return True

    def _sys_exit(self, proc, msg):
        if proc.process.popen is None:  # forked: no Popen to report status
            proc.process.exit_code = int(msg.a[1])
            # raw _exit skips the shim destructor's PROC_EXIT message, so
            # stamp the waitpid status here (guest parents read it)
            proc.process.wait_status = (int(msg.a[1]) & 0xFF) << 8
        proc._reply(0)
        return True

    def _sys_open(self, proc, msg):
        """Virtual-path open (reference regular_file.c special paths); the
        shim passes everything else through natively in the sandbox cwd."""
        path = I.msg_payload(msg).split(b"\0")[0].decode(errors="replace")
        if path in ("/dev/urandom", "/dev/random"):
            f = RandomFile(lambda n, h=proc.host: self._random_bytes(h, min(n, I.SHIM_BUF_SIZE)))
            proc._reply(proc.fdtab.alloc(f))
            return True
        proc._reply(-ENOENT)
        return True

    # --- memory-map ledger -------------------------------------------------
    # The role of the reference's MemoryManager bookkeeping
    # (memory_manager/mod.rs:1-17): shadow tracks guest mappings and the
    # program break. Mappings execute natively in the guest (this design
    # never remaps guest pages into shadow — payloads ride the shm
    # channel), and the shim's libc-level mmap/munmap/mremap/brk/sbrk
    # interposers report each region change here (raw glibc-internal
    # mappings are deliberately not trapped; see seccomp.c's note).

    def _sys_mm_note(self, proc, msg):
        op, addr, length = int(msg.a[1]), int(msg.a[2]) & (2**64 - 1), int(msg.a[3])
        payload = I.msg_payload(msg)
        prot = flags = fd = off = 0
        if len(payload) >= 32:
            prot, flags, fd, off = struct.unpack_from("<4q", payload)
        p = proc.process

        def _carve(lo: int, hi: int) -> None:
            """Remove [lo, hi) from the ledger, trimming partial overlaps
            (native mmap/munmap semantics: a new fixed mapping or an unmap
            atomically replaces whatever it covers)."""
            for base in list(p.mappings):
                mlen, mprot, mflags, mfd, moff = p.mappings[base]
                mend = base + mlen
                if mend <= lo or base >= hi:
                    continue
                del p.mappings[base]
                if base < lo:  # left remainder
                    p.mappings[base] = (lo - base, mprot, mflags, mfd, moff)
                if mend > hi:  # right remainder
                    p.mappings[hi] = (mend - hi, mprot, mflags, mfd,
                                      moff + (hi - base))

        if op == 1:  # mmap (MAP_FIXED over an existing region replaces it)
            _carve(addr, addr + length)
            p.mappings[addr] = (length, int(prot), int(flags), int(fd), int(off))
        elif op == 2:  # munmap: drop/trim overlapping regions
            _carve(addr, addr + length)
        elif op == 3:  # brk: shim reports the post-call break
            p.brk_end = addr
        elif op == 4:  # mremap: new addr in a[2], old in payload off slot
            old = int(off) & (2**64 - 1)
            ent = p.mappings.pop(old, None)
            if ent is not None:
                p.mappings[addr] = (length or ent[0], ent[1], ent[2], ent[3], ent[4])
            else:
                p.mappings[addr] = (length, 0, int(flags), -1, 0)
        proc._reply(0)
        return True

    # --- descriptor ops ---------------------------------------------------

    def _sys_fd_native(self, proc, msg):
        """The shim reports native passthrough fds entering (op 1) and
        leaving (op 2) use, keeping the unified lowest-free allocator off
        numbers real files occupy (descriptor_table.rs:12 role)."""
        op, fd = int(msg.a[1]), int(msg.a[2])
        if op == 1:
            proc.process.fdtab.native_used.add(fd)
        else:
            proc.process.fdtab.native_used.discard(fd)
        proc._reply(0)
        return True

    def _sys_close(self, proc, msg):
        fd = int(msg.a[1])
        if self._file(proc, fd) is None:
            proc._reply(-EBADF)
            return True
        self._close_fd(proc, fd)
        proc._reply(0)
        return True

    def _sys_dup(self, proc, msg):
        nfd = proc.fdtab.dup(int(msg.a[1]))
        proc._reply(nfd if nfd is not None else -EBADF)
        return True

    def _sys_dup2(self, proc, msg):
        oldfd, newfd = int(msg.a[1]), int(msg.a[2])
        f = self._file(proc, oldfd)
        if f is None:
            proc._reply(-EBADF)
            return True
        if oldfd == newfd:
            proc._reply(newfd)
            return True
        if proc.fdtab.get(newfd) is not None:
            self._close_fd(proc, newfd)
        # dup2 onto a native number displaces the native file (the shim's
        # placeholder claim closes it on the real kernel)
        proc.fdtab.native_used.discard(newfd)
        proc.fdtab.alloc_at(f, newfd)
        proc._reply(newfd)
        return True

    def _sys_fstat(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if f is None:
            proc._reply(-EBADF)
            return True
        if isinstance(f, (T.TcpSocket, UdpSocket, UnixSocket)):
            t = 1  # S_IFSOCK
        elif isinstance(f, PipeEnd):
            t = 2  # S_IFIFO
        elif isinstance(f, (EventFd, TimerFd, Epoll)):
            t = 3  # anon inode
        else:
            t = 4  # character device (/dev/urandom etc.)
        proc._reply(0, a=(0, 0, t))
        return True

    def _sys_fcntl(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if f is None:
            proc._reply(-EBADF)
            return True
        cmd, arg = int(msg.a[2]), int(msg.a[3])
        if cmd == F_GETFL:
            proc._reply(O_NONBLOCK if f.nonblock else 0)
        elif cmd == F_SETFL:
            f.nonblock = bool(arg & O_NONBLOCK)
            proc._reply(0)
        elif cmd in (0, 1030):  # F_DUPFD / F_DUPFD_CLOEXEC
            proc._reply(proc.fdtab.alloc(f, min_fd=max(int(arg), 0)))
        else:
            proc._reply(0)  # accept-and-ignore (F_SETFD etc.)
        return True

    def _sys_ioctl(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if f is None:
            proc._reply(-EBADF)
            return True
        req = int(msg.a[2])
        if req == FIONREAD:
            if isinstance(f, T.TcpSocket):
                n = len(f.rcv_buf)
            elif isinstance(f, UdpSocket):
                n = len(f.recvq[0][0]) if f.recvq else 0
            elif isinstance(f, PipeEnd):
                n = len(f.buf.data) if f.is_read else 0
            else:
                n = 0
            proc._reply(0, a=(0, 0, n))
            return True
        if req == FIONBIO:
            # the int value rides in a[3] (the shim reads *argp; CPython's
            # settimeout/setblocking path uses FIONBIO when available)
            f.nonblock = bool(int(msg.a[3]))
            proc._reply(0)
            return True
        proc._reply(-EINVAL)
        return True

    def _sys_pipe2(self, proc, msg):
        r, w = make_pipe()
        flags = int(msg.a[1])
        r.nonblock = w.nonblock = bool(flags & O_NONBLOCK)
        rfd = proc.fdtab.alloc(r)
        wfd = proc.fdtab.alloc(w)
        proc._reply(0, a=(0, rfd, wfd))
        return True

    def _sys_eventfd(self, proc, msg):
        ef = EventFd(int(msg.a[1]), int(msg.a[2]))
        ef.nonblock = bool(int(msg.a[2]) & 0x800)  # EFD_NONBLOCK == O_NONBLOCK
        proc._reply(proc.fdtab.alloc(ef))
        return True

    def _sys_timerfd_create(self, proc, msg):
        tf = TimerFd(self)
        tf.nonblock = bool(int(msg.a[2]) & 0x800)  # TFD_NONBLOCK
        proc._reply(proc.fdtab.alloc(tf))
        return True

    def _sys_timerfd_settime(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if not isinstance(f, TimerFd):
            proc._reply(-EBADF if f is None else -EINVAL)
            return True
        payload = I.msg_payload(msg)
        value_ns, interval_ns = struct.unpack("<qq", payload[:16])
        flags = int(msg.a[2])
        if (flags & 1) and value_ns > 0:  # TFD_TIMER_ABSTIME on CLOCK_REALTIME
            # a past abstime must fire immediately (clamp to 1, not 0 —
            # 0 would disarm)
            value_ns = max(value_ns - SIM_START_UNIX_NS - self.now, 1)
            flags &= ~1
        old_value, old_interval = f.settime(value_ns, interval_ns, flags)
        proc._reply(0, a=(0, 0, old_value, old_interval))
        return True

    def _sys_timerfd_gettime(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if not isinstance(f, TimerFd):
            proc._reply(-EBADF if f is None else -EINVAL)
            return True
        value, interval = f.gettime()
        proc._reply(0, a=(0, 0, value, interval))
        return True

    # --- read/write on any vfd -------------------------------------------

    def _sys_read(self, proc, msg):
        fd, n = int(msg.a[1]), min(int(msg.a[2]), I.SHIM_BUF_SIZE)
        f = self._file(proc, fd)
        if f is None:
            proc._reply(-EBADF)
            return True
        dontwait = bool(int(msg.a[3]))
        return self._do_read(proc, f, n, dontwait)

    def _do_read(self, proc, f: File, n: int, dontwait: bool) -> bool:
        if isinstance(f, T.TcpSocket):
            return self._tcp_recv(proc, f, n, dontwait)
        if isinstance(f, UdpSocket):
            return self._udp_recv(proc, f, n, dontwait)
        if isinstance(f, UnixSocket):
            return self._unix_recv(proc, f, n, dontwait, include_path=False)
        if isinstance(f, (PipeEnd, EventFd, TimerFd, RandomFile)):
            r = f.read(n)
            if isinstance(r, int) and r == -EAGAIN and not (f.nonblock or dontwait):
                def check(pf=f, pn=n):
                    rr = pf.read(pn)
                    if isinstance(rr, int) and rr == -EAGAIN:
                        return False
                    if isinstance(rr, int):
                        proc._reply(rr)
                    else:
                        proc._reply(len(rr), buf=rr)
                    return True

                Waiter(self, proc, [f], check)
                return False
            if isinstance(r, int):
                proc._reply(r)
            else:
                proc._reply(len(r), buf=r)
            return True
        proc._reply(-EINVAL)
        return True

    def _sys_write(self, proc, msg):
        fd = int(msg.a[1])
        data = I.msg_payload(msg)
        f = self._file(proc, fd)
        if f is None:
            proc._reply(-EBADF)
            return True
        dontwait = bool(int(msg.a[3]))
        return self._do_write(proc, f, data, dontwait)

    # --- bulk-memory IO tier (reference memory_copier.rs:64-170): the
    # payload never rides the 64 KB shm channel — the kernel copies
    # straight out of / into the frozen guest's address space. Byte
    # semantics mirror the chunked shm path exactly (64 KB rounds, short
    # round ends the write, blocking waits between rounds); the shim
    # falls back to the chunked path on -ENOSYS. ------------------------

    def _bulk_pid(self, proc):
        for owner in (proc, getattr(proc, "process", None)):
            if owner is None:
                continue
            if getattr(owner, "real_pid", None) is not None:
                return owner.real_pid  # forked children
            popen = getattr(owner, "popen", None)
            if popen is not None:
                return popen.pid
        return None

    def _sys_write_bulk(self, proc, msg):
        from shadow_tpu_torch.hostk import guestmem

        if not self.use_memory_manager:
            proc._reply(-ENOSYS)
            return True
        fd, addr, n = int(msg.a[1]), int(msg.a[2]), int(msg.a[3])
        dontwait = bool(int(msg.a[5]))
        f = self._file(proc, fd)
        if f is None:
            proc._reply(-EBADF)
            return True
        pid = self._bulk_pid(proc)
        if (
            pid is None
            or not guestmem.AVAILABLE
            or not isinstance(f, (T.TcpSocket, PipeEnd))
        ):
            proc._reply(-ENOSYS)  # shim retraces the chunked shm path
            return True
        state = {"done": 0}

        def check() -> bool:
            while state["done"] < n:
                want = min(I.SHIM_BUF_SIZE, n - state["done"])
                data = guestmem.read_guest(pid, addr + state["done"], want)
                if data is None:
                    proc._reply(state["done"] if state["done"] else -EFAULT)
                    return True
                r = f.send(data) if isinstance(f, T.TcpSocket) else f.write(data)
                if r == -EAGAIN:
                    if f.nonblock or dontwait:
                        proc._reply(state["done"] if state["done"] else -EAGAIN)
                        return True
                    return False  # Waiter retries this round
                if r < 0:
                    proc._reply(state["done"] if state["done"] else r)
                    return True
                state["done"] += r
                if r < want:  # short round ends the write (chunked-path parity)
                    proc._reply(state["done"])
                    return True
            proc._reply(state["done"])
            return True

        if check():
            return True
        Waiter(self, proc, [f], check)
        return False

    def _sys_read_bulk(self, proc, msg):
        from shadow_tpu_torch.hostk import guestmem

        if not self.use_memory_manager:
            proc._reply(-ENOSYS)
            return True
        fd, addr, n = int(msg.a[1]), int(msg.a[2]), int(msg.a[3])
        dontwait = bool(int(msg.a[5]))
        f = self._file(proc, fd)
        if f is None:
            proc._reply(-EBADF)
            return True
        pid = self._bulk_pid(proc)
        if (
            pid is None
            or not guestmem.AVAILABLE
            or not isinstance(f, (T.TcpSocket, PipeEnd))
        ):
            proc._reply(-ENOSYS)
            return True

        def check() -> bool:
            # peek, copy into guest memory, THEN consume — a guest buffer
            # fault must not lose stream bytes (Linux only consumes what
            # it actually copied)
            if isinstance(f, T.TcpSocket):
                r = f.peek(n)
            elif f.buf.data:
                r = bytes(f.buf.data[:n])
            elif not f.buf.write_open:
                r = b""  # EOF
            else:
                r = -EAGAIN
            if isinstance(r, int):
                if r == -EAGAIN:
                    if f.nonblock or dontwait:
                        proc._reply(-EAGAIN)
                        return True
                    return False
                proc._reply(r)
                return True
            if not r:
                proc._reply(0)
                return True
            if not guestmem.write_guest(pid, addr, r):
                proc._reply(-EFAULT)  # nothing consumed
                return True
            consumed = f.recv(len(r)) if isinstance(f, T.TcpSocket) else f.read(len(r))
            assert not isinstance(consumed, int) and len(consumed) == len(r)
            proc._reply(len(r))
            return True

        if check():
            return True
        Waiter(self, proc, [f], check)
        return False

    def _do_write(self, proc, f: File, data: bytes, dontwait: bool) -> bool:
        if isinstance(f, T.TcpSocket):
            return self._tcp_send(proc, f, data, dontwait)
        if isinstance(f, UdpSocket):
            return self._udp_sendto(proc, f, data, -1, -1)
        if isinstance(f, UnixSocket):
            return self._unix_send(proc, f, data, dontwait)
        if isinstance(f, (PipeEnd, EventFd, RandomFile)):
            r = f.write(data)
            if r == -EAGAIN and not (f.nonblock or dontwait):
                def check(pf=f, pd=data):
                    rr = pf.write(pd)
                    if rr == -EAGAIN:
                        return False
                    proc._reply(rr)
                    return True

                Waiter(self, proc, [f], check)
                return False
            proc._reply(r)
            return True
        proc._reply(-EINVAL)
        return True

    # --- sockets ----------------------------------------------------------

    def _sys_socket(self, proc, msg):
        domain = int(msg.a[1])
        stype = int(msg.a[2]) & 0xFF
        nonblock = bool(int(msg.a[2]) & 0x800)  # SOCK_NONBLOCK
        if domain == 1:  # AF_UNIX
            if stype not in (SOCK_STREAM, SOCK_DGRAM):
                proc._reply(-EINVAL)
                return True
            s: File = UnixSocket(stype)
        elif stype == 2:  # SOCK_DGRAM
            s = UdpSocket()
        elif stype == 1:  # SOCK_STREAM
            s = T.TcpSocket(proc.host)
        else:
            proc._reply(-EINVAL)
            return True
        s.nonblock = nonblock
        proc._reply(proc.fdtab.alloc(s))
        return True

    def _sys_bind(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        host = proc.host
        if f is None:
            proc._reply(-EBADF)
            return True
        port = int(msg.a[3])
        if isinstance(f, UdpSocket):
            proto = PROTO_UDP
        elif isinstance(f, T.TcpSocket):
            proto = PROTO_TCP
        else:
            proc._reply(-ENOTSOCK)
            return True
        if f.bound_port:  # Linux: rebinding a bound socket is EINVAL
            proc._reply(-EINVAL)
            return True
        port = port or host.alloc_port(proto)
        if (proto, port) in host.ports:
            proc._reply(-EADDRINUSE)
            return True
        host.ports[(proto, port)] = f
        f.bound_port = port
        if isinstance(f, T.TcpSocket):
            f.local_ip = host.ip
            f.local_port = port
        proc._reply(0)
        return True

    def _sys_listen(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if f is None:
            proc._reply(-EBADF)
            return True
        if isinstance(f, UnixSocket):
            if f.stype != SOCK_STREAM or f.bound is None:
                proc._reply(-EINVAL)
                return True
            f.listening = True
            f.backlog = max(int(msg.a[2]), 1)
            proc._reply(0)
            return True
        if not isinstance(f, T.TcpSocket):
            proc._reply(-ENOTSOCK if not isinstance(f, UdpSocket) else -EINVAL)
            return True
        if f.bound_port == 0:  # listen() without bind: ephemeral (POSIX allows)
            proc.host.bind_tcp_ephemeral(f)
            f.local_ip = proc.host.ip
            f.local_port = f.bound_port
        proc._reply(f.listen(int(msg.a[2])))
        return True

    def _sys_accept(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if f is None:
            proc._reply(-EBADF)
            return True
        if isinstance(f, UnixSocket):
            if not f.listening:
                proc._reply(-EINVAL)
                return True
            nonblock_child = bool(int(msg.a[2]))

            def try_accept_unix() -> bool:
                if not f.pending:
                    return False
                child = f.pending.popleft()
                child.nonblock = nonblock_child
                cfd = proc.fdtab.alloc(child)
                f.notify()  # a backlog slot freed: blocked connectors re-check
                proc._reply(cfd, a=(0, 0, 0, 0, 1))  # a[4]=1: unix peer addr
                return True

            if try_accept_unix():
                return True
            if f.nonblock:
                proc._reply(-EAGAIN)
                return True
            Waiter(self, proc, [f], try_accept_unix)
            return False
        if not isinstance(f, T.TcpSocket) or f.state != T.LISTEN:
            proc._reply(-EINVAL)
            return True
        nonblock_child = bool(int(msg.a[2]))

        def try_accept() -> bool:
            child = f.accept_pop()
            if child is None:
                return False
            child.nonblock = nonblock_child
            cfd = proc.fdtab.alloc(child)
            proc._reply(cfd, a=(0, 0, child.remote_ip, child.remote_port))
            return True

        if try_accept():
            return True
        if f.nonblock:
            proc._reply(-EAGAIN)
            return True
        Waiter(self, proc, [f], try_accept)
        return False

    def _sys_connect(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if f is None:
            proc._reply(-EBADF)
            return True
        ip, port = self._norm_ip(proc.host, int(msg.a[2])), int(msg.a[3])
        if isinstance(f, UdpSocket):
            f.peer = (ip, port)
            proc._reply(0)
            return True
        if not isinstance(f, T.TcpSocket):
            proc._reply(-ENOTSOCK)
            return True
        if f.state == T.ESTABLISHED:
            proc._reply(-EISCONN)
            return True
        r = f.connect(ip, port)
        if r != -EINPROGRESS:
            proc._reply(r)
            return True
        if f.nonblock:
            proc._reply(-EINPROGRESS)
            return True

        def check() -> bool:
            if f.state == T.ESTABLISHED:
                proc._reply(0)
                return True
            if f.error:
                e, f.error = f.error, 0
                proc._reply(-e)
                return True
            return False

        Waiter(self, proc, [f], check)
        return False

    def _sys_shutdown(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if not isinstance(f, (T.TcpSocket, UnixSocket)):
            proc._reply(-EBADF if f is None else -ENOTSOCK)
            return True
        how = int(msg.a[2])
        if how in (1, 2):  # SHUT_WR / SHUT_RDWR
            proc._reply(f.shutdown_write())
        else:
            proc._reply(0)  # SHUT_RD: no-op in this model
        return True

    @staticmethod
    def _unix_addr_reply(proc, addr: "Optional[tuple[bool, str]]") -> None:
        """Reply with a unix address: a[4]=1 marker, a[2]=abstract flag,
        buf=path bytes (empty for unbound)."""
        if addr is None:
            proc._reply(0, a=(0, 0, 0, 0, 1))
        else:
            proc._reply(0, a=(0, 0, int(addr[0]), 0, 1), buf=addr[1].encode("utf-8", "surrogateescape"))

    def _sys_getsockname(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        host = proc.host
        if isinstance(f, UnixSocket):
            self._unix_addr_reply(proc, f.bound)
            return True
        if isinstance(f, UdpSocket):
            proc._reply(0, a=(0, 0, host.ip, f.bound_port))
        elif isinstance(f, T.TcpSocket):
            proc._reply(0, a=(0, 0, f.local_ip or host.ip, f.local_port or f.bound_port))
        else:
            proc._reply(-EBADF if f is None else -ENOTSOCK)
        return True

    def _sys_getpeername(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if isinstance(f, UnixSocket):
            if f.stype == SOCK_STREAM and f.peer is not None:
                self._unix_addr_reply(proc, f.peer.bound)
            elif f.stype == SOCK_DGRAM and f.default_dest is not None:
                self._unix_addr_reply(proc, f.default_dest.bound)
            else:
                proc._reply(-ENOTCONN)
            return True
        if isinstance(f, UdpSocket):
            if f.peer is None:
                proc._reply(-ENOTCONN)
            else:
                proc._reply(0, a=(0, 0, f.peer[0], f.peer[1]))
        elif isinstance(f, T.TcpSocket):
            if f.state in (T.CLOSED, T.LISTEN):
                proc._reply(-ENOTCONN)
            else:
                proc._reply(0, a=(0, 0, f.remote_ip, f.remote_port))
        else:
            proc._reply(-EBADF if f is None else -ENOTSOCK)
        return True

    # --- unix-domain sockets (reference: descriptor/socket/unix.rs) -------

    @staticmethod
    def _unix_key(msg, payload: "Optional[bytes]" = None) -> "tuple[bool, str]":
        path = (payload if payload is not None else I.msg_payload(msg)).decode(
            errors="surrogateescape"
        )
        return (bool(int(msg.a[2])), path)

    def _sys_ubind(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if not isinstance(f, UnixSocket):
            proc._reply(-EBADF if f is None else -ENOTSOCK)
            return True
        key = self._unix_key(msg)
        if f.bound is not None or not key[1]:
            proc._reply(-EINVAL)
            return True
        if key in proc.host.unix_ns:
            proc._reply(-EADDRINUSE)
            return True
        f.bound = key
        proc.host.unix_ns[key] = f
        proc._reply(0)
        return True

    def _sys_uconnect(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if not isinstance(f, UnixSocket):
            proc._reply(-EBADF if f is None else -ENOTSOCK)
            return True
        key = self._unix_key(msg)
        dest = proc.host.unix_ns.get(key)
        if dest is None or dest.stype != f.stype:
            proc._reply(-ECONNREFUSED)
            return True
        if f.stype == SOCK_DGRAM:
            f.default_dest = dest
            proc._reply(0)
            return True
        if f.peer is not None:
            proc._reply(-EISCONN)
            return True
        if not dest.listening:
            proc._reply(-ECONNREFUSED)
            return True
        r = f.connect_to_listener(dest)
        if isinstance(r, int) and r == -EAGAIN and not f.nonblock:
            # full backlog: a blocking connect waits for accept() to drain
            # a slot (Linux blocks; only nonblocking connect sees EAGAIN)
            def check() -> bool:
                if dest.closed:
                    proc._reply(-ECONNREFUSED)
                    return True
                rr = f.connect_to_listener(dest)
                if isinstance(rr, int) and rr == -EAGAIN:
                    return False
                proc._reply(rr if isinstance(rr, int) else 0)
                return True

            Waiter(self, proc, [dest], check)
            return False
        proc._reply(r if isinstance(r, int) else 0)
        return True

    def _sys_usendto(self, proc, msg):
        """Dgram sendto with an explicit destination path:
        buf = [u16 pathlen][path][payload], a[2]=abstract, a[3]=dontwait."""
        f = self._file(proc, int(msg.a[1]))
        if not isinstance(f, UnixSocket):
            proc._reply(-EBADF if f is None else -ENOTSOCK)
            return True
        if f.stype != SOCK_DGRAM:
            proc._reply(-EISCONN)  # stream sendto with addr
            return True
        raw = I.msg_payload(msg)
        plen = struct.unpack("<H", raw[:2])[0]
        key = self._unix_key(msg, raw[2 : 2 + plen])
        data = raw[2 + plen :]
        dest = proc.host.unix_ns.get(key)
        if dest is None or dest.stype != SOCK_DGRAM:
            proc._reply(-ECONNREFUSED)
            return True
        return self._unix_dgram_send(proc, f, dest, data, dontwait=bool(int(msg.a[3])))

    def _sys_socketpair(self, proc, msg):
        stype = int(msg.a[2]) & 0xFF
        nonblock = bool(int(msg.a[2]) & 0x800)
        if int(msg.a[1]) != 1 or stype not in (SOCK_STREAM, SOCK_DGRAM):
            proc._reply(-EINVAL)
            return True
        a, b = UnixSocket(stype), UnixSocket(stype)
        a.nonblock = b.nonblock = nonblock
        if stype == SOCK_STREAM:
            a.peer, b.peer = b, a
        else:
            a.default_dest, b.default_dest = b, a
        proc._reply(proc.fdtab.alloc(a), a=(0, 0, proc.fdtab.alloc(b)))
        return True

    def _sys_setsockopt(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if f is None:
            proc._reply(-EBADF)
            return True
        proc._reply(0)  # accept-and-ignore (SO_REUSEADDR, TCP_NODELAY, bufs…)
        return True

    def _sys_getsockopt(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if f is None:
            proc._reply(-EBADF)
            return True
        level, opt = int(msg.a[2]), int(msg.a[3])
        if level == SOL_SOCKET and opt == SO_ERROR:
            e = 0
            if isinstance(f, T.TcpSocket):
                e, f.error = f.error, 0
            proc._reply(0, a=(0, 0, e))
            return True
        if level == SOL_SOCKET and opt == 3:  # SO_TYPE
            stream = isinstance(f, T.TcpSocket) or (
                isinstance(f, UnixSocket) and f.stype == SOCK_STREAM
            )
            proc._reply(0, a=(0, 0, 1 if stream else 2))
            return True
        if level == SOL_SOCKET and opt == 30:  # SO_ACCEPTCONN
            listening = (isinstance(f, T.TcpSocket) and f.state == T.LISTEN) or (
                isinstance(f, UnixSocket) and f.listening
            )
            proc._reply(0, a=(0, 0, int(listening)))
            return True
        if level == SOL_SOCKET and opt in (7, 8):  # SO_SNDBUF / SO_RCVBUF
            proc._reply(0, a=(0, 0, 212992))  # net.core default
            return True
        proc._reply(0, a=(0, 0, 0))
        return True

    # --- UDP data path ----------------------------------------------------

    def _sys_sendto(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if f is None:
            proc._reply(-EBADF)
            return True
        data = I.msg_payload(msg)
        ip, port = int(msg.a[2]), int(msg.a[3])
        if ip != -1:
            ip = self._norm_ip(proc.host, ip)
        dontwait = bool(int(msg.a[5]))  # MSG_DONTWAIT forwarded by the shim
        if isinstance(f, T.TcpSocket):
            return self._tcp_send(proc, f, data, dontwait=dontwait)
        if isinstance(f, UdpSocket):
            return self._udp_sendto(proc, f, data, ip, port)
        if isinstance(f, UnixSocket):  # send() on a connected unix socket
            return self._unix_send(proc, f, data, dontwait=dontwait)
        proc._reply(-ENOTSOCK)
        return True

    def _unix_send(self, proc, sock: UnixSocket, data: bytes, dontwait: bool) -> bool:
        if sock.stype == SOCK_DGRAM:
            dest = sock.default_dest
            if dest is None:
                proc._reply(-ENOTCONN)
                return True
            return self._unix_dgram_send(proc, sock, dest, data, dontwait)
        r = sock.stream_send(data)
        if r == -EAGAIN and not (sock.nonblock or dontwait):

            def check() -> bool:
                rr = sock.stream_send(data)
                if rr == -EAGAIN:
                    return False
                proc._reply(rr)
                return True

            Waiter(self, proc, [sock], check)
            return False
        proc._reply(r)
        return True

    def _unix_dgram_send(
        self, proc, sock: UnixSocket, dest: UnixSocket, data: bytes, dontwait: bool
    ) -> bool:
        if len(data) > I.SHIM_BUF_SIZE:
            proc._reply(-EMSGSIZE)
            return True
        r = sock.dgram_send_to(dest, data)
        if r == -EAGAIN and not (sock.nonblock or dontwait):

            def check() -> bool:
                rr = sock.dgram_send_to(dest, data)
                if rr == -EAGAIN:
                    return False
                proc._reply(rr)
                return True

            Waiter(self, proc, [dest], check)
            return False
        proc._reply(r)
        return True

    @staticmethod
    def _norm_ip(host: HostKernel, ip: int) -> int:
        """127.0.0.0/8 means the sending host itself (the reference routes
        loopback via a dedicated localhost interface, namespace.rs:26)."""
        return host.ip if (ip >> 24) == (LOCALHOST_NET >> 24) else ip

    def _udp_sendto(self, proc, sock: UdpSocket, data: bytes, ip: int, port: int) -> bool:
        host = proc.host
        if ip == -1:  # send() on a connected socket
            if sock.peer is None:
                proc._reply(-EDESTADDRREQ)
                return True
            ip, port = sock.peer
        if len(data) > 65507:  # real UDP: datagram exceeds IPv4 payload max
            proc._reply(-EMSGSIZE)
            return True
        if sock.bound_port == 0:  # implicit bind on first send
            sock.bound_port = host.alloc_port(PROTO_UDP)
            host.ports[(PROTO_UDP, sock.bound_port)] = sock
        self._send_packet(host, proc.now, ip, port, host.ip, sock.bound_port, data)
        proc._reply(len(data))
        return True

    def _sys_recvfrom(self, proc, msg):
        f = self._file(proc, int(msg.a[1]))
        if f is None:
            proc._reply(-EBADF)
            return True
        fl = int(msg.a[2])
        dontwait, peek = bool(fl & 1), bool(fl & 2)
        waitall = bool(fl & 4) and not dontwait
        n = min(int(msg.a[3]), I.SHIM_BUF_SIZE)
        if isinstance(f, T.TcpSocket):
            if n == 0:  # stream: returns 0 immediately, consumes nothing
                proc._reply(0)
                return True
            # O_NONBLOCK beats MSG_WAITALL on Linux (plain-recv behavior)
            if waitall and not f.nonblock:
                if peek:
                    return self._tcp_peek_all(proc, f, n)
                return self._stream_recv_all(
                    proc, f, n, f.recv, (0, 0, f.remote_ip, f.remote_port)
                )
            return self._tcp_recv(proc, f, n, dontwait, peek=peek)
        if isinstance(f, UdpSocket):
            # n == 0 on a datagram socket still dequeues (truncate-discard)
            return self._udp_recv(proc, f, n, dontwait, peek=peek)
        if isinstance(f, UnixSocket):
            if n == 0 and f.stype == SOCK_STREAM:
                proc._reply(0)
                return True
            if (
                waitall
                and not peek
                and f.stype == SOCK_STREAM
                and not f.nonblock
            ):
                return self._stream_recv_all(
                    proc, f, n, f.stream_recv, (0, 0, 0, 0, 1)
                )
            return self._unix_recv(proc, f, n, dontwait, include_path=True, peek=peek)
        proc._reply(-ENOTSOCK)
        return True

    def _unix_recv(
        self,
        proc,
        sock: UnixSocket,
        n: int,
        dontwait: bool,
        include_path: bool,
        peek: bool = False,
    ) -> bool:
        """Unix-socket receive. Reply contract when a source address rides
        along: a[4]=1 (unix marker), a[2]=pathlen, a[3]=abstract flag,
        buf=path+payload, ret=len(payload)."""

        def attempt() -> "Optional[tuple]":
            """-> (ret, a, buf) or None if would block."""
            if sock.stype == SOCK_DGRAM:
                d = sock.dgrams[0] if (peek and sock.dgrams) else (
                    None if peek else sock.dgram_recv()
                )
                if d is None:
                    return None
                src, data = d
                data = data[:n]  # excess datagram bytes are discarded (POSIX)
                if include_path and src is not None:
                    path = src[1].encode("utf-8", "surrogateescape")
                    # path + payload must fit the reply buffer
                    data = data[: I.SHIM_BUF_SIZE - len(path)]
                    return (len(data), (0, 0, len(path), int(src[0]), 1), path + data)
                return (len(data), (0, 0, 0, 0, 1), data)
            r = sock.stream_peek(n) if peek else sock.stream_recv(n)
            if r == -EAGAIN:
                return None
            if isinstance(r, int):
                return (r, (), b"")
            return (len(r), (0, 0, 0, 0, 1), r)

        got = attempt()
        if got is None:
            if sock.nonblock or dontwait:
                proc._reply(-EAGAIN)
                return True

            def check() -> bool:
                g = attempt()
                if g is None:
                    return False
                proc._reply(g[0], a=g[1], buf=g[2])
                return True

            Waiter(self, proc, [sock], check)
            return False
        proc._reply(got[0], a=got[1], buf=got[2])
        return True

    def _udp_recv(
        self, proc, sock: UdpSocket, n: int, dontwait: bool, peek: bool = False
    ) -> bool:
        def check() -> bool:
            if not sock.recvq:
                return False
            if peek:
                data, sip, sport = sock.recvq[0]
            else:
                data, sip, sport = sock.take()
            proc._reply(len(data), a=(0, 0, sip, sport), buf=data[:n])
            return True

        if check():
            return True
        if sock.nonblock or dontwait:
            proc._reply(-EAGAIN)
            return True
        Waiter(self, proc, [sock], check)
        return False

    # --- TCP data path ----------------------------------------------------

    def _tcp_send(self, proc, sock: T.TcpSocket, data: bytes, dontwait: bool) -> bool:
        r = sock.send(data)
        if r == -EAGAIN and not (sock.nonblock or dontwait):
            def check() -> bool:
                rr = sock.send(data)
                if rr == -EAGAIN:
                    return False
                proc._reply(rr)
                return True

            Waiter(self, proc, [sock], check)
            return False
        proc._reply(r)
        return True

    def _tcp_recv(
        self, proc, sock: T.TcpSocket, n: int, dontwait: bool, peek: bool = False
    ) -> bool:
        def check() -> bool:
            r = sock.peek(n) if peek else sock.recv(n)
            if isinstance(r, int):
                if r == -EAGAIN:
                    return False
                proc._reply(r)
                return True
            proc._reply(len(r), a=(0, 0, sock.remote_ip, sock.remote_port), buf=r)
            return True

        if check():
            return True
        if sock.nonblock or dontwait:
            proc._reply(-EAGAIN)
            return True
        Waiter(self, proc, [sock], check)
        return False

    def _stream_recv_all(self, proc, sock, n: int, recv_fn, addr_a) -> bool:
        """MSG_WAITALL: accumulate until n bytes, EOF, error, or a signal
        (a partial count is returned if interrupted after some data)."""
        acc = bytearray()

        def check() -> bool:
            while len(acc) < n:
                r = recv_fn(n - len(acc))
                if isinstance(r, int):
                    if r == -EAGAIN:
                        return False
                    if acc:
                        # partial data wins; re-arm the error for the next
                        # call (Linux keeps sk_err pending)
                        if hasattr(sock, "error"):
                            sock.error = -r
                        proc._reply(len(acc), a=addr_a, buf=bytes(acc))
                    else:
                        proc._reply(r)
                    return True
                if r == b"":  # EOF: return what we have
                    proc._reply(len(acc), a=addr_a, buf=bytes(acc))
                    return True
                acc.extend(r)
            proc._reply(len(acc), a=addr_a, buf=bytes(acc))
            return True

        if check():
            return True

        def on_interrupt():
            # partial data beats EINTR (Linux MSG_WAITALL semantics)
            if acc:
                proc._reply(len(acc), a=addr_a, buf=bytes(acc))
            else:
                proc._reply(-EINTR)

        Waiter(self, proc, [sock], check, on_interrupt=on_interrupt)
        return False

    def _tcp_peek_all(self, proc, sock: T.TcpSocket, n: int) -> bool:
        """MSG_PEEK|MSG_WAITALL: block until n bytes are buffered (or
        EOF/error), then peek without consuming (Linux computes the
        WAITALL target irrespective of PEEK)."""

        def check() -> bool:
            r = sock.peek(n)
            if isinstance(r, int):
                if r == -EAGAIN:
                    return False
                proc._reply(r)
                return True
            # complete the peek when the target is reached OR no more data
            # can ever arrive (FIN already received and in-sequence)
            fin_in = (
                sock.fin_rcvd_seq is not None
                and sock.rcv_nxt >= sock.fin_rcvd_seq + 1
            )
            if len(r) < n and not fin_in:
                return False
            proc._reply(len(r), a=(0, 0, sock.remote_ip, sock.remote_port), buf=r)
            return True

        if check():
            return True
        Waiter(self, proc, [sock], check)
        return False

    # --- poll / select / epoll -------------------------------------------

    def _sys_poll(self, proc, msg):
        nfds = int(msg.a[1])
        timeout_ns = int(msg.a[2])
        raw = I.msg_payload(msg)
        if nfds * 8 > len(raw):  # shim clamps payloads to SHIM_BUF_SIZE
            proc._reply(-EINVAL)
            return True
        entries = []  # (fd, events)
        for i in range(nfds):
            fd, events, _rev = struct.unpack_from("<ihh", raw, i * 8)
            entries.append((fd, events))

        def ready_map() -> "tuple[int, bytes]":
            out = bytearray(raw[: nfds * 8])
            count = 0
            for i, (fd, events) in enumerate(entries):
                f = self._file(proc, fd)
                if f is None:
                    # unknown fd: could be a native file the shim never
                    # noted (launcher-inherited, unnotable creator) — be
                    # lenient and treat as never-ready, not POLLNVAL
                    rev = 0
                else:
                    mask = f.poll_mask()
                    rev = 0
                    if (events & 0x1) and (mask & EPOLLIN):
                        rev |= 0x1  # POLLIN
                    if (events & 0x4) and (mask & EPOLLOUT):
                        rev |= 0x4  # POLLOUT
                    if mask & 0x8:
                        rev |= 0x8  # POLLERR
                    if mask & 0x10:
                        rev |= 0x10  # POLLHUP
                struct.pack_into("<ihh", out, i * 8, fd, events, rev)
                if rev:
                    count += 1
            return count, bytes(out)

        count, out = ready_map()
        if count > 0 or timeout_ns == 0:
            proc._reply(count, buf=out)
            return True
        files = [
            self._file(proc, fd) for fd, _ in entries if fd >= 0 and self._file(proc, fd)
        ]

        def check() -> bool:
            c, o = ready_map()
            if c == 0:
                return False
            proc._reply(c, buf=o)
            return True

        def on_timeout() -> None:
            c, o = ready_map()
            proc._reply(c, buf=o)

        Waiter(
            self,
            proc,
            files,
            check,
            timeout_at=(proc.now + timeout_ns) if timeout_ns > 0 else None,
            on_timeout=on_timeout,
            restartable=False,  # poll(2) is never restarted by SA_RESTART
        )
        return False

    def _sys_epoll_create(self, proc, msg):
        proc._reply(proc.fdtab.alloc(Epoll()))
        return True

    def _sys_epoll_ctl(self, proc, msg):
        ep = self._file(proc, int(msg.a[1]))
        if not isinstance(ep, Epoll):
            proc._reply(-EBADF if ep is None else -EINVAL)
            return True
        op, fd = int(msg.a[2]), int(msg.a[3])
        target = self._file(proc, fd)
        events = data = 0
        payload = I.msg_payload(msg)
        if len(payload) >= 12:
            events, data = struct.unpack("<IQ", payload[:12])
        proc._reply(ep.ctl(op, fd, target, events, data))
        return True

    def _sys_epoll_wait(self, proc, msg):
        ep = self._file(proc, int(msg.a[1]))
        if not isinstance(ep, Epoll):
            proc._reply(-EBADF if ep is None else -EINVAL)
            return True
        maxevents = max(1, int(msg.a[2]))
        timeout_ns = int(msg.a[3])

        def try_report() -> bool:
            got = ep.report(maxevents)
            if not got:
                return False
            buf = b"".join(struct.pack("<IQ", hits, data) for data, hits in got)
            proc._reply(len(got), buf=buf)
            return True

        if try_report():
            return True
        if timeout_ns == 0:
            proc._reply(0)
            return True

        def on_timeout() -> None:
            got = ep.report(maxevents)
            buf = b"".join(struct.pack("<IQ", hits, data) for data, hits in got)
            proc._reply(len(got), buf=buf)

        Waiter(
            self,
            proc,
            [ep],
            try_report,
            timeout_at=(proc.now + timeout_ns) if timeout_ns > 0 else None,
            on_timeout=on_timeout,
            restartable=False,  # epoll_wait(2) is never restarted by SA_RESTART
        )
        return False

    # --- the data plane (Worker::send_packet, worker.rs:328-413) ---------

    def _path(self, src: HostKernel, dst: HostKernel) -> "tuple[int, float]":
        """(latency_ns, reliability); same-host traffic rides loopback
        (exempt from loss + bandwidth, reference relay/mod.rs local exempt)."""
        if src is dst:
            lat = int(self.lat[src.node, dst.node])
            if lat >= TIME_MAX:
                lat = LOOPBACK_LATENCY_NS
            return lat, 1.0
        return int(self.lat[src.node, dst.node]), float(self.rel[src.node, dst.node])

    def _egress_depart(self, src: HostKernel, t: int, size: int) -> int:
        """Up-bw relay at the source NIC (relay/mod.rs inet-out); charged
        before the loss draw, exactly like the device engine (lost packets
        still consume tokens, worker.rs:361-378 ordering)."""
        if src.tx_tb is None or t < self.bootstrap_end_ns:
            return t
        return src.tx_tb.depart(t, size)

    def _arrive(
        self,
        dst: HostKernel,
        size: int,
        loopback: bool,
        deliver_fn,
        src_host: int = 0,
        src_seq: int = 0,
    ) -> None:
        """Down-bw relay + CoDel at the destination's upstream router
        (relay inet-in + router/codel, mirroring netstack.py's ingress)."""
        if loopback or dst.rx_tb is None or self.now < self.bootstrap_end_ns:
            deliver_fn()
            return
        snap = (dst.rx_tb.tokens, dst.rx_tb.last)
        ready = dst.rx_tb.depart(self.now, size)
        if dst.rx_codel.dequeue(ready, ready - self.now, dst.rx_backlog_bytes):
            dst.rx_tb.tokens, dst.rx_tb.last = snap  # drop consumes no tokens
            dst.codel_dropped += 1
            self.event_log.append((self.now, f"codel-drop {dst.name} {size}B"))
            return
        if ready > self.now:
            dst.rx_backlog_bytes += size

            def later():
                dst.rx_backlog_bytes -= size
                deliver_fn()

            # the deferred dequeue keeps the packet's total-order key, like
            # the engine's shaped re-enqueue (round.py push_self with ev.tie)
            self._push_packet(ready, src_host, src_seq, later)
        else:
            deliver_fn()

    def _clamp(self, arr_t: int, send_t: int) -> int:
        """Conservative-window delivery clamp (worker.rs:399-402): the
        delivery may not land inside the send's own round window."""
        if self.window_ns is None:
            return arr_t
        return max(arr_t, self._grid_end(send_t))

    def _send_packet(
        self, src: HostKernel, t: int, dst_ip: int, dst_port: int,
        src_ip: int, src_port: int, data: bytes,
    ) -> None:
        dst = self.host_by_ip.get(dst_ip)
        loopback = dst is src
        if self.hybrid and not loopback:
            # the loss uniform is evaluated on device from this counter;
            # the stream position advances exactly as _loss_draw would
            ctr = src.rng_counter
            src.rng_counter += 1
            u = None
        else:
            u = self._loss_draw(src)  # drawn even for unroutable, like the engine
        if dst is None:
            return  # no such host: UDP silently drops
        lat, relv = self._path(src, dst)
        if lat >= TIME_MAX:
            return  # unroutable packets never charge the tx relay
        size = len(data)
        seq = src.send_seq
        src.send_seq += 1
        if loopback:
            src.packets_sent += 1
            src.bytes_sent += size
            if self.pcap:
                self.pcap.udp(src.name, t, src_ip, src_port, dst_ip, dst_port, data)
            self._push_packet(
                t + lat,
                src.host_id,
                seq,
                lambda: self._arrive(
                    dst, size, True,
                    lambda: self._deliver(dst, dst_port, data, src_ip, src_port),
                    src.host_id, seq,
                ),
            )
            return
        if self.hybrid:
            self.payloads[(src.host_id, seq)] = (
                "udp", t, dst.host_id, dst_port, data, src_ip, src_port,
            )
            src.packets_sent += 1  # tentative; reverted by a loss record
            src.bytes_sent += size
            self.pending_sends.append((t, src.host_id, seq, ctr, dst.host_id, size))
            return
        if self.qdisc == "rr" and src.tx_tb is not None:

            def emit(dep):
                if not (u < relv):
                    src.packets_dropped += 1
                    self.event_log.append((t, f"drop {src.name}->{dst.name}:{dst_port}"))
                    return
                src.packets_sent += 1
                src.bytes_sent += size
                if self.pcap:
                    self.pcap.udp(src.name, t, src_ip, src_port, dst_ip, dst_port, data)
                self._push_packet(
                    self._clamp(dep + lat, t), src.host_id, seq,
                    lambda: self._arrive(
                        dst, size, False,
                        lambda: self._deliver(dst, dst_port, data, src_ip, src_port),
                        src.host_id, seq,
                    ),
                )

            src.nic.submit(("udp", src_port), size, emit)
            return
        dep = self._egress_depart(src, t, size)
        if not (u < relv):
            src.packets_dropped += 1
            self.event_log.append((t, f"drop {src.name}->{dst.name}:{dst_port}"))
            return
        src.packets_sent += 1
        src.bytes_sent += size
        if self.pcap:
            self.pcap.udp(src.name, t, src_ip, src_port, dst_ip, dst_port, data)
        self._push_packet(
            self._clamp(dep + lat, t),
            src.host_id,
            seq,
            lambda: self._arrive(
                dst, size, False,
                lambda: self._deliver(dst, dst_port, data, src_ip, src_port),
                src.host_id, seq,
            ),
        )

    def _deliver(
        self, dst: HostKernel, port: int, data: bytes, src_ip: int, src_port: int
    ) -> None:
        self.event_log.append((self.now, f"deliver {dst.name}:{port} {len(data)}B"))
        dst.bytes_recv += len(data)
        if self.pcap:
            self.pcap.udp(dst.name, self.now, src_ip, src_port, dst.ip, port, data)
        sock = dst.ports.get((PROTO_UDP, port))
        if not isinstance(sock, UdpSocket):
            return  # nobody bound: drop (no ICMP in v1)
        if sock.peer is not None and sock.peer != (src_ip, src_port):
            return  # connected UDP sockets only accept their peer's datagrams
        sock.deliver(data, src_ip, src_port)

    # --- TCP segment plane -------------------------------------------------

    def send_segment(self, src: HostKernel, seg: T.Segment) -> None:
        """Transmit one TCP segment through the simulated network (the
        TCP-tier Worker::send_packet)."""
        dst = self.host_by_ip.get(seg.dst_ip)
        loopback = dst is src
        if self.hybrid and not loopback:
            ctr = src.rng_counter
            src.rng_counter += 1
            u = None
        else:
            u = self._loss_draw(src)
        if dst is None:
            return
        lat, relv = self._path(src, dst)
        if lat >= TIME_MAX:
            return  # unroutable packets never charge the tx relay
        t = self.now
        size = seg.wire_len()
        seq = src.send_seq
        src.send_seq += 1
        if loopback:
            src.packets_sent += 1
            src.bytes_sent += size
            if self.pcap:
                self.pcap.tcp(src.name, t, seg)
            self._push_packet(
                t + lat,
                src.host_id,
                seq,
                lambda: self._arrive(
                    dst, size, True, lambda: self._deliver_segment(dst, seg),
                    src.host_id, seq,
                ),
            )
            return
        if self.hybrid:
            self.payloads[(src.host_id, seq)] = ("tcp", t, dst.host_id, seg)
            src.packets_sent += 1  # tentative; reverted by a loss record
            src.bytes_sent += size
            self.pending_sends.append((t, src.host_id, seq, ctr, dst.host_id, size))
            return
        if self.qdisc == "rr" and src.tx_tb is not None:

            def emit(dep):
                if not (u < relv):
                    src.packets_dropped += 1
                    self.event_log.append(
                        (t, f"drop-tcp {src.name}->{dst.name} {seg.flag_str()} seq={seg.seq}")
                    )
                    return
                src.packets_sent += 1
                src.bytes_sent += size
                if self.pcap:
                    self.pcap.tcp(src.name, t, seg)
                self._push_packet(
                    self._clamp(dep + lat, t), src.host_id, seq,
                    lambda: self._arrive(
                        dst, size, False, lambda: self._deliver_segment(dst, seg),
                        src.host_id, seq,
                    ),
                )

            src.nic.submit(
                ("tcp", seg.src_port, seg.dst_ip, seg.dst_port), size, emit
            )
            return
        dep = self._egress_depart(src, t, size)
        if not (u < relv):
            src.packets_dropped += 1
            self.event_log.append(
                (t, f"drop-tcp {src.name}->{dst.name} {seg.flag_str()} seq={seg.seq}")
            )
            return
        src.packets_sent += 1
        src.bytes_sent += size
        if self.pcap:
            self.pcap.tcp(src.name, t, seg)
        self._push_packet(
            self._clamp(dep + lat, t),
            src.host_id,
            seq,
            lambda: self._arrive(
                dst, size, False, lambda: self._deliver_segment(dst, seg),
                src.host_id, seq,
            ),
        )

    def _deliver_segment(self, dst: HostKernel, seg: T.Segment) -> None:
        dst.bytes_recv += seg.wire_len()
        self.event_log.append(
            (
                self.now,
                f"tcp {dst.name}:{seg.dst_port} {seg.flag_str()} "
                f"seq={seg.seq} ack={seg.ack} {len(seg.payload)}B",
            )
        )
        if self.pcap:
            self.pcap.tcp(dst.name, self.now, seg)
        conn = dst.tcp_conns.get((seg.dst_port, seg.src_ip, seg.src_port))
        if conn is not None:
            conn.on_segment(seg)
            return
        listener = dst.ports.get((PROTO_TCP, seg.dst_port))
        if isinstance(listener, T.TcpSocket) and listener.state == T.LISTEN:
            if seg.flags & T.FLAG_SYN and not (seg.flags & T.FLAG_ACK):
                listener.on_syn(seg)
                return
        # closed port / dead connection: RST (unless this was an RST)
        if not (seg.flags & T.FLAG_RST):
            rst = T.Segment(
                src_ip=seg.dst_ip,
                src_port=seg.dst_port,
                dst_ip=seg.src_ip,
                dst_port=seg.src_port,
                flags=T.FLAG_RST | T.FLAG_ACK,
                seq=seg.ack,
                ack=seg.seq + len(seg.payload) + (1 if seg.flags & T.FLAG_SYN else 0),
                wnd=0,
            )
            self.send_segment(dst, rst)

    # --- hybrid coupling API (runtime/hybrid.py) --------------------------

    def hybrid_take_sends(self) -> "list[tuple]":
        """Drain the buffered sends: (t, src_host, seq, loss_ctr, dst_host,
        size) tuples in emission order."""
        out = self.pending_sends
        self.pending_sends = []
        return out

    def hybrid_apply_record(
        self, flag: int, t: int, src_host: int, seq: int, horizon_ns: "Optional[int]" = None
    ) -> None:
        """Apply one device-engine outcome record for send (src_host, seq):
        the packet was delivered at t (push the socket delivery event),
        lost to path loss at send time, or dropped by the ingress AQM at t.
        Log lines and counters mirror the serial transport path exactly —
        including the horizon: an AQM drop timed past horizon_ns is an
        arrival event the serial kernel would never pop, so it must not be
        counted (deliveries past the horizon equivalently land in the heap
        and never fire).

        Split into a src-side half (loss revert + send-side pcap) and a
        dst-side half (delivery push / AQM counter) so the parallel
        scheduler can route each half to the worker owning that host; the
        serial path simply applies both."""
        pl = self.payloads.pop((src_host, seq))
        self.hybrid_record_src_side(flag, t, src_host, seq, pl, horizon_ns)
        self.hybrid_record_dst_side(flag, t, src_host, seq, pl, horizon_ns)

    def hybrid_record_src_side(
        self, flag: int, t: int, src_host: int, seq: int, pl: tuple,
        horizon_ns: "Optional[int]" = None,
    ) -> None:
        from shadow_tpu_torch.models.managed_net import REC_LOSS_DROP

        src = self.hosts[src_host]
        if pl[0] == "udp":
            _, t_send, dst_id, dst_port, data, src_ip, src_port = pl
            dst = self.hosts[dst_id]
            size = len(data)
            if flag == REC_LOSS_DROP:
                src.packets_sent -= 1
                src.bytes_sent -= size
                src.packets_dropped += 1
                self.event_log.append((t_send, f"drop {src.name}->{dst.name}:{dst_port}"))
                return
            if self.pcap:
                self.pcap.udp(src.name, t_send, src_ip, src_port, dst.ip, dst_port, data)
        else:
            _, t_send, dst_id, seg = pl
            dst = self.hosts[dst_id]
            size = seg.wire_len()
            if flag == REC_LOSS_DROP:
                src.packets_sent -= 1
                src.bytes_sent -= size
                src.packets_dropped += 1
                self.event_log.append(
                    (t_send, f"drop-tcp {src.name}->{dst.name} {seg.flag_str()} seq={seg.seq}")
                )
                return
            if self.pcap:
                self.pcap.tcp(src.name, t_send, seg)

    def hybrid_record_dst_side(
        self, flag: int, t: int, src_host: int, seq: int, pl: tuple,
        horizon_ns: "Optional[int]" = None,
    ) -> None:
        from shadow_tpu_torch.models.managed_net import REC_CODEL_DROP, REC_LOSS_DROP

        if flag == REC_LOSS_DROP:
            return  # loss is entirely a src-side outcome
        past_horizon = horizon_ns is not None and t > horizon_ns
        if pl[0] == "udp":
            _, t_send, dst_id, dst_port, data, src_ip, src_port = pl
            dst = self.hosts[dst_id]
            size = len(data)
            if flag == REC_CODEL_DROP:
                if not past_horizon:
                    dst.codel_dropped += 1
                    self.event_log.append((t, f"codel-drop {dst.name} {size}B"))
                return
            self._push_packet(
                t, src_host, seq,
                lambda: self._deliver(dst, dst_port, data, src_ip, src_port),
            )
        else:
            _, t_send, dst_id, seg = pl
            dst = self.hosts[dst_id]
            size = seg.wire_len()
            if flag == REC_CODEL_DROP:
                if not past_horizon:
                    dst.codel_dropped += 1
                    self.event_log.append((t, f"codel-drop {dst.name} {size}B"))
                return
            self._push_packet(
                t, src_host, seq, lambda: self._deliver_segment(dst, seg)
            )


_DISPATCH = {
    I.VSYS_YIELD: NetKernel._sys_yield,
    I.VSYS_CLOCK_GETTIME: NetKernel._sys_clock_gettime,
    I.VSYS_GETPID: NetKernel._sys_getpid,
    I.VSYS_NANOSLEEP: NetKernel._sys_nanosleep,
    I.VSYS_SOCKET: NetKernel._sys_socket,
    I.VSYS_BIND: NetKernel._sys_bind,
    I.VSYS_CONNECT: NetKernel._sys_connect,
    I.VSYS_GETSOCKNAME: NetKernel._sys_getsockname,
    I.VSYS_SENDTO: NetKernel._sys_sendto,
    I.VSYS_RECVFROM: NetKernel._sys_recvfrom,
    I.VSYS_CLOSE: NetKernel._sys_close,
    I.VSYS_EXIT: NetKernel._sys_exit,
    I.VSYS_LISTEN: NetKernel._sys_listen,
    I.VSYS_ACCEPT: NetKernel._sys_accept,
    I.VSYS_SHUTDOWN: NetKernel._sys_shutdown,
    I.VSYS_GETPEERNAME: NetKernel._sys_getpeername,
    I.VSYS_SETSOCKOPT: NetKernel._sys_setsockopt,
    I.VSYS_GETSOCKOPT: NetKernel._sys_getsockopt,
    I.VSYS_FCNTL: NetKernel._sys_fcntl,
    I.VSYS_IOCTL: NetKernel._sys_ioctl,
    I.VSYS_WRITE_BULK: NetKernel._sys_write_bulk,
    I.VSYS_READ_BULK: NetKernel._sys_read_bulk,
    I.VSYS_PIPE2: NetKernel._sys_pipe2,
    I.VSYS_READ: NetKernel._sys_read,
    I.VSYS_WRITE: NetKernel._sys_write,
    I.VSYS_EVENTFD: NetKernel._sys_eventfd,
    I.VSYS_TIMERFD_CREATE: NetKernel._sys_timerfd_create,
    I.VSYS_TIMERFD_SETTIME: NetKernel._sys_timerfd_settime,
    I.VSYS_TIMERFD_GETTIME: NetKernel._sys_timerfd_gettime,
    I.VSYS_EPOLL_CREATE: NetKernel._sys_epoll_create,
    I.VSYS_EPOLL_CTL: NetKernel._sys_epoll_ctl,
    I.VSYS_EPOLL_WAIT: NetKernel._sys_epoll_wait,
    I.VSYS_POLL: NetKernel._sys_poll,
    I.VSYS_GETHOSTNAME: NetKernel._sys_gethostname,
    I.VSYS_UNAME: NetKernel._sys_uname,
    I.VSYS_RESOLVE: NetKernel._sys_resolve,
    I.VSYS_GETRANDOM: NetKernel._sys_getrandom,
    I.VSYS_DUP: NetKernel._sys_dup,
    I.VSYS_OPEN: NetKernel._sys_open,
    I.VSYS_UBIND: NetKernel._sys_ubind,
    I.VSYS_UCONNECT: NetKernel._sys_uconnect,
    I.VSYS_USENDTO: NetKernel._sys_usendto,
    I.VSYS_SOCKETPAIR: NetKernel._sys_socketpair,
    I.VSYS_SIGACTION: NetKernel._sys_sigaction,
    I.VSYS_ALARM: NetKernel._sys_alarm,
    I.VSYS_SETITIMER: NetKernel._sys_setitimer,
    I.VSYS_GETITIMER: NetKernel._sys_getitimer,
    I.VSYS_KILL: NetKernel._sys_kill,
    I.VSYS_RESOLVE_REV: NetKernel._sys_resolve_rev,
    I.VSYS_DUP2: NetKernel._sys_dup2,
    I.VSYS_FSTAT: NetKernel._sys_fstat,
    I.VSYS_THREAD_CREATE: NetKernel._sys_thread_create,
    I.VSYS_THREAD_EXIT: NetKernel._sys_thread_exit,
    I.VSYS_THREAD_JOIN: NetKernel._sys_thread_join,
    I.VSYS_THREAD_FAILED: NetKernel._sys_thread_failed,
    I.VSYS_MUTEX_LOCK: NetKernel._sys_mutex_lock,
    I.VSYS_MUTEX_TRYLOCK: NetKernel._sys_mutex_trylock,
    I.VSYS_MUTEX_UNLOCK: NetKernel._sys_mutex_unlock,
    I.VSYS_COND_WAIT: NetKernel._sys_cond_wait,
    I.VSYS_COND_SIGNAL: NetKernel._sys_cond_signal,
    I.VSYS_FUTEX_WAIT: NetKernel._sys_futex_wait,
    I.VSYS_FUTEX_WAKE: NetKernel._sys_futex_wake,
    I.VSYS_FUTEX_REQUEUE: NetKernel._sys_futex_requeue,
    I.VSYS_SIGMASK: NetKernel._sys_sigmask,
    I.VSYS_MM_NOTE: NetKernel._sys_mm_note,
    I.VSYS_FD_NATIVE: NetKernel._sys_fd_native,
    I.VSYS_FORK: NetKernel._sys_fork,
    I.VSYS_WAITPID: NetKernel._sys_waitpid,
    I.VSYS_PAUSE: NetKernel._sys_pause,
}
