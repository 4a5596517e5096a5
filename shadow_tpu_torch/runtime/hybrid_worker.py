"""Worker process for the parallel managed tier (port of
shadow_tpu/runtime/hybrid_worker.py).

One worker owns a static partition of the hosts and runs a NetKernel
shard over them — its guests, sockets, timers, and per-host shaping state
all live here; every non-loopback packet goes to the parent's device
engine and comes back as an outcome record. This is the role of one
work-stealing worker thread in the reference's scheduler
(reference: src/main/core/scheduler/thread_per_core.rs:188-206), as an OS
process (the kernel is pure Python — processes sidestep the GIL the way
the reference's threads sidestep nothing).

Protocol (pickled tuples over a multiprocessing Pipe; one reply per
command):

  ("run_window", end_ns, inclusive, progress_total)
        -> ("sends", [(t, src, seq, ctr, dst, size, payload-or-None)]) —
        payload is shipped only for sends whose destination lives in
        another worker; progress_total feeds the kernel's progress line.
  ("apply_records", (which[], flag[], t[], src[], seq[], payload[]), horizon)
        -> ("ok",) — columnar batch (one list per field, which in
        {"both","src","dst"}): the round boundary ships six flat lists of
        primitives per worker instead of one tuple per record
  ("next_time",)                      -> ("t", ns-or-None)
  ("finish", until_ns) / ("stats",) / ("proc_info",) / ("unexpected",)
  / ("shutdown",) / ("exit",)

Workers are spawned (not forked) so the parent's CUDA context never
leaks in, and they never initialise CUDA: the parent hides the card from
a worker's environment (CUDA_VISIBLE_DEVICES="") before the worker's
interpreter starts, so before it imports torch
(hybrid.py::ParallelHybridScheduler._spawn), its NetKernel draws threefry
blocks on CPU tensors, and it checks that CUDA was never initialised.
The parent alone owns the device state.
"""

from __future__ import annotations

import os
import signal
import traceback


def worker_main(conn, init: dict) -> None:
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    # Ctrl-C goes to the whole foreground process group: the PARENT owns
    # orderly teardown (final checkpoint, worker reaping) — a worker that
    # dies first would look like a crash and trigger a pointless respawn.
    try:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    except (ValueError, OSError):  # non-main thread / exotic platform
        pass
    try:
        _serve(conn, init)
    except EOFError:
        return  # parent went away: exit quietly, nothing to report to
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        except Exception:
            pass
        raise


def _serve(conn, init: dict) -> None:
    import torch

    # K workers share the host's cores: one intra-op thread each (the
    # draws are 512-value blocks, exact in any thread count)
    torch.set_num_threads(1)

    from shadow_tpu_torch.graph.routing import RoutingTables
    from shadow_tpu_torch.hostk.kernel import NetKernel, ProcessSpec
    from shadow_tpu_torch.runtime.hybrid import _SortingPcap

    tables = RoutingTables(lat_ns=init["lat"], rel=init["rel"], host_node=None)
    primary = init["worker_index"] == 0
    k = NetKernel(
        tables,
        host_names=init["host_names"],
        host_nodes=init["host_nodes"],
        seed=init["seed"],
        data_dir=init["data_dir"],
        window_ns=init["window_ns"],
        bw_up_bits=init["bw_up_bits"],
        bw_down_bits=init["bw_down_bits"],
        strace_mode=init.get("strace_mode", "standard"),
        pcap=init.get("pcap", False),
        host_ips=init.get("host_ips"),
        heartbeat_ns=init.get("heartbeat_ns", 0),
        bootstrap_end_ns=init.get("bootstrap_end_ns", 0),
        tcp_sack=init.get("tcp_sack", True),
        tcp_autotune=init.get("tcp_autotune", True),
        qdisc=init.get("qdisc", "fifo"),
        syscall_latency_ns=init.get("syscall_latency_ns", 1_000),
        vdso_latency_ns=init.get("vdso_latency_ns", 10),
        max_unapplied_ns=init.get("max_unapplied_ns", 1_000_000),
        cpu_freq_hz=init.get("cpu_freq_hz"),
        owned_hosts=init["owned"],
        data_dir_prepared=True,
        manager_heartbeat=primary,
        write_hosts_file=primary,
    )
    k.hybrid = True
    if k.pcap is not None:
        k.pcap = _SortingPcap(k.pcap)
    procs = []
    for spec in init["specs"]:
        spec = dict(spec)
        vpid = spec.pop("_vpid", None)
        procs.append(k.add_process(ProcessSpec(**spec), vpid=vpid))
    _check_no_cuda(torch)
    conn.send(("ready", len(procs)))

    while True:
        msg = conn.recv()
        cmd = msg[0]
        if cmd == "run_window":
            _, end_ns, inclusive, total = msg
            k._progress_total = total
            k.run_window(end_ns, inclusive=inclusive)
            out = []
            for (t, src, seq, ctr, dst, size) in k.hybrid_take_sends():
                pl = None if k.owns(dst) else k.payloads[(src, seq)]
                out.append((t, src, seq, ctr, dst, size, pl))
            conn.send(("sends", out))
        elif cmd == "apply_records":
            _, (whichs, flags, ts, srcs, seqs, pls), horizon = msg
            for which, flag, t, src, seq, pl in zip(
                whichs, flags, ts, srcs, seqs, pls
            ):
                if which == "both":
                    k.hybrid_apply_record(flag, t, src, seq, horizon_ns=horizon)
                elif which == "src":
                    pl2 = k.payloads.pop((src, seq))
                    k.hybrid_record_src_side(flag, t, src, seq, pl2, horizon)
                else:
                    k.hybrid_record_dst_side(flag, t, src, seq, pl, horizon)
            conn.send(("ok",))
        elif cmd == "next_time":
            conn.send(("t", k.events[0][0] if k.events else None))
        elif cmd == "finish":
            k.finish(msg[1])
            _check_no_cuda(torch)
            conn.send(("ok",))
        elif cmd == "stats":
            conn.send(("stats", k.stats(), sorted(k.owned or []), list(k.event_log)))
        elif cmd == "proc_info":
            info = []
            for p in procs:
                info.append(
                    {
                        "host": p.host.name,
                        "args": list(p.spec.args),
                        "stdout": p.stdout(),
                        "exit_code": p.exit_code,
                        "syscalls": [s for _, s, _ in p.syscall_log],
                        "state": p.state,
                    }
                )
            conn.send(("procs", info))
        elif cmd == "unexpected":
            conn.send(("u", k.unexpected_final_states()))
        elif cmd == "shutdown_check":
            k.shutdown_check()
            conn.send(("ok",))
        elif cmd == "shutdown":
            k.shutdown()
            k.shutdown_check()
            conn.send(("ok",))
        elif cmd == "exit":
            conn.send(("bye",))
            return
        else:
            raise ValueError(f"unknown worker command {cmd!r}")


def _check_no_cuda(torch) -> None:
    if torch.cuda.is_initialized():
        raise RuntimeError("hybrid worker initialised CUDA; workers run on the CPU only")
