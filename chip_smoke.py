"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full smoke (H = 10,240 hosts)

Phases, each printing one line; any failure exits non-zero:
  1. identify the card (nvidia-smi name/power limit, torch and CUDA versions);
  2. build the pump megakernel from csrc/ with nvcc (sm_90a);
  3. kernel vs its plain twin at full width: the bench world (10,240 hosts,
     32-node lossy graph, 100 Mbit shaped hosts, tgen 100 KB streams over
     TCP, tracker on) advanced on the card into the burst, then one kernel
     stage and one twin stage on clones of the same state, every leaf equal;
     then the same on a 4,096-host world whose streams cross lossy links
     (shaped and unshaped), plus whole runs of both engines there;
  4. the main path: run_until to 0.5 s sim with engine "auto", which must
     resolve to the kernel; bench counters equal the pinned oracle values;
  5. plain vs megakernel engines agree on host_stats at 0.1 s sim;
  6. the CLI entry point on examples/tgen/shadow.yaml, sim-stats pinned;
  7. the kernels JSON line, the card line, and the final JSON line.

Imports torch, numpy and the port only (no jax, nothing of shadow_tpu/).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# --- pinned expectations ---------------------------------------------
# Bench world, 10,240 hosts to 0.5 s sim: the counters of the native C
# oracle, `python tools/native_baseline/run_native_baseline.py 10240 0.5`
# (a single-core C PDES of the same semantics), which also agree with the
# JAX engine's record for this world (BENCH_r04.json).
BENCH_HOSTS = 10240
BENCH_END_NS = 500_000_000
BENCH_EVENTS = 1_085_440
BENCH_STREAMS_DONE = 5_120
BENCH_BYTES_DOWN = 512_000_000
# examples/tgen/shadow.yaml (16 hosts, 4 s): sim-stats.json of the JAX
# package's `shadow-tpu run` on the CPU (JAX_PLATFORMS=cpu), minus the
# wall-clock and execution-shape fields.
TGEN_EXAMPLE_STATS = {
    "events_handled": 3_360,
    "packets_sent": 2_688,
    "packets_dropped": 0,
    "packets_unroutable": 0,
    "sim_seconds": 4.0,
    "scheduler": "tpu",
    "num_hosts": 16,
    "unexpected_final_states": [],
}
# sim time at which the bench world is in its burst: the first pump
# stage of the next round takes P1, P2 and P3 events and rejects others
BURST_NS = 14_000_000
# the lossy world of phase 3b: hosts, and the sim times at which its
# next pump stage takes P1 (shaped only), P2 and P3 events, rejects
# others and drops packets to loss draws
LOSSY_HOSTS = 4096
LOSSY_MID_NS_SHAPED = 26_000_000
LOSSY_MID_NS_UNSHAPED = 22_000_000
LOSSY_END_NS = 120_000_000
# H100 SXM device-memory rate (NVIDIA data sheet) for the bound column
HBM_BYTES_PER_S = 3.35e12
# non-tensor-core 32-bit rate (NVIDIA data sheet, FP32), the op yardstick
OPS_PER_S = 67e12


def line(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def bench_world(num_hosts: int, device, seed: int = 7):
    """bench.py's _build_world + _build, written against the port."""
    from shadow_tpu_torch.engine.round import bootstrap
    from shadow_tpu_torch.engine.state import EngineConfig, init_state
    from shadow_tpu_torch.graph import NetworkGraph, compute_routing
    from shadow_tpu_torch.models.tgen import TgenModel
    from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill
    from shadow_tpu_torch.simtime import NS_PER_MS

    rng_py = random.Random(seed)
    n_nodes = 32
    lines = ["graph [", "  directed 0"]
    for i in range(n_nodes):
        lines.append(f"  node [ id {i} ]")
        lines.append(f'  edge [ source {i} target {i} latency "2 ms" ]')
    for i in range(n_nodes):
        for j in rng_py.sample(range(n_nodes), 6) + [(i + 1) % n_nodes]:
            if j != i:
                lat = rng_py.randrange(2, 12)
                lines.append(
                    f'  edge [ source {i} target {j} latency "{lat} ms" packet_loss 0.005 ]'
                )
    lines.append("]")
    graph = NetworkGraph.from_gml("\n".join(lines))
    host_node = [i % n_nodes for i in range(num_hosts)]
    tables = compute_routing(graph, block=64, device=device).with_hosts(host_node)
    clients = num_hosts // 2
    cfg = EngineConfig(
        num_hosts=num_hosts,
        queue_capacity=384,
        outbox_capacity=32,
        runahead_ns=graph.min_latency_ns(),
        seed=seed,
        use_netstack=True,
        deliver_lanes=64,
        max_iters_per_round=256,
        tracker=True,
    )
    model = TgenModel(
        num_hosts=num_hosts,
        num_clients=clients,
        num_servers=num_hosts - clients,
        resp_bytes=100_000,
        pause_ns=500 * NS_PER_MS,
    )
    bw = bw_bits_per_sec_to_refill(100_000_000)
    st = init_state(cfg, model.init(device), tx_bytes_per_interval=bw,
                    rx_bytes_per_interval=bw, device=device)
    return cfg, model, tables, bootstrap(st, model, cfg)


def lossy_world(num_hosts: int, device, shaped: bool = True, loss: float = 0.05, seed: int = 11):
    """A tgen world in the style of tests/test_pump.py (lossy edges between
    graph nodes, 20 Mbit hosts when shaped), written against the port. It
    has 5 nodes so that, unlike the bench world, a client and its server
    sit on different nodes: loss draws drop packets and recovery runs."""
    from shadow_tpu_torch.engine.round import bootstrap
    from shadow_tpu_torch.engine.state import EngineConfig, init_state
    from shadow_tpu_torch.graph import NetworkGraph, compute_routing
    from shadow_tpu_torch.models.tgen import TgenModel
    from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill
    from shadow_tpu_torch.simtime import NS_PER_MS

    rng_py = random.Random(seed)
    n_nodes = 5
    lines = ["graph [", "  directed 0"]
    for i in range(n_nodes):
        lines.append(f"  node [ id {i} ]")
        lines.append(f'  edge [ source {i} target {i} latency "2 ms" ]')
    for i in range(n_nodes):
        for j in range(i + 1, n_nodes):
            lat = rng_py.randrange(2, 9)
            lines.append(
                f'  edge [ source {i} target {j} latency "{lat} ms" packet_loss {loss} ]'
            )
    lines.append("]")
    graph = NetworkGraph.from_gml("\n".join(lines))
    tables = compute_routing(graph, device=device).with_hosts(
        [i % n_nodes for i in range(num_hosts)]
    )
    cfg = EngineConfig(
        num_hosts=num_hosts, queue_capacity=192, outbox_capacity=32,
        runahead_ns=graph.min_latency_ns(), seed=seed, use_netstack=shaped,
        deliver_lanes=48, tracker=True,
    )
    model = TgenModel(
        num_hosts=num_hosts, num_clients=num_hosts // 2,
        num_servers=num_hosts - num_hosts // 2, resp_bytes=40_000,
        pause_ns=30 * NS_PER_MS,
    )
    bw = bw_bits_per_sec_to_refill(20_000_000) if shaped else None
    st = init_state(cfg, model.init(device), tx_bytes_per_interval=bw,
                    rx_bytes_per_interval=bw, device=device)
    return cfg, model, tables, bootstrap(st, model, cfg)


def leaves_equal(a, b):
    """(names of the leaves that differ in dtype, shape or value, the
    largest absolute difference over all leaves)."""
    from shadow_tpu_torch.utils.tree import tree_leaves_with_path

    bad, err = [], 0.0
    for (pa, la), (pb, lb) in zip(tree_leaves_with_path(a), tree_leaves_with_path(b)):
        if pa != pb or la.dtype != lb.dtype or la.shape != lb.shape:
            bad.append(pa)
            continue
        if not torch.equal(la, lb):
            bad.append(pa)
            d = (la.to(torch.float64) - lb.to(torch.float64)).abs().max()
            err = max(err, float(d))
    return bad, err


def timed_ms(fn, reps: int, setup, device) -> float:
    """Mean ms of fn(setup()) over `reps` calls: CUDA events on the card
    (setup() runs untimed before each call), the host clock on the CPU."""
    total = 0.0
    for _ in range(reps):
        arg = setup()
        if device.type == "cuda":
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn(arg)
            t1.record()
            torch.cuda.synchronize()
            total += t0.elapsed_time(t1)
        else:
            t0 = time.perf_counter()
            fn(arg)
            total += (time.perf_counter() - t0) * 1e3
    return total / reps


def kernel_device_ms(st, we, model, tables, cfg, reps: int) -> float:
    """Mean device ms of one kernel launch, each on a fresh clone of
    `st`. The argument structs are built before timing; a sleep kernel
    holds the stream while every launch is enqueued, so the CUDA events
    around each launch bracket the kernel alone, not the host's wrapper."""
    from shadow_tpu_torch.engine import megakernel as mk

    dev = st.device
    w = torch.as_tensor(we, dtype=torch.int64, device=dev).reshape(())
    codel = mk.PUMP_KERNEL.codel_table(dev)
    prepared = []
    for _ in range(reps):
        rej = torch.zeros((1,), dtype=torch.int32, device=dev)
        prepared.append(mk.kernel_args(st.clone(), w, model, tables, cfg, rej, codel))
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles
    for (args, _), (t0, t1) in zip(prepared, events):
        t0.record()
        mk.PUMP_KERNEL.launch(args, dev)
        t1.record()
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in events) / reps


def pump_bound(st, we, model, tables, cfg, tallies, after) -> "tuple[float, str, dict]":
    """Least time for one pump stage on this input: the bytes that this
    input needs moved (each read once, each changed element written
    once) over the memory rate, vs an operation count over the 32-bit
    rate. Returns (ms, bound_by, the reckoning).

    Reads: the head time of every row; the `time` row of each live row
    (the argmin scans it); tie, kind, aux and data of each slot the queue
    supplies; the socket-matching fields (st, ports, remote host) of all
    sockets of a live row and every field of a socket the stage changes;
    the per-row scalars of a row that takes an event; the routing and
    CoDel tables once. Writes: exactly the elements that differ between
    `st` and `after` (the twin's result on the same input)."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.utils.tree import tree_leaves_with_path

    h, cap = st.queue.time.shape
    rej = torch.zeros((1,), dtype=torch.int32, device=st.device)
    w = torch.as_tensor(we, dtype=torch.int64, device=st.device).reshape(())
    _, named = mk.kernel_args(st, w, model, tables, cfg, rej,
                              mk.PUMP_KERNEL.codel_table(st.device))
    tcp = st.model.tcp
    tcp_names = {f.name for f in dataclasses.fields(tcp)}

    def row_bytes(t):  # bytes of one row (first index) of t
        return t.element_size() * t[0].numel()

    steps = tallies["steps"]
    live = int(tallies["live_rows"])
    q_sel = int(sum(d["ev_queue"] for d in steps))
    taken = int(sum(d["take"] for d in steps))
    rows_taking = int((after.events_handled != st.events_handled).sum())
    touched = torch.zeros(tcp.st.shape, dtype=torch.bool, device=st.device)
    for name in tcp_names:
        a, b = getattr(tcp, name), getattr(after.model.tcp, name)
        touched |= (a != b).reshape(*tcp.st.shape, -1).any(-1)
    n_touched = int(touched.sum())
    socket_bytes = sum(row_bytes(getattr(tcp, n)[0]) for n in tcp_names)
    match_bytes = sum(row_bytes(named[n]) for n in ("st", "lport", "rport", "rhost"))
    table_names = ("host_node", "lat_ns", "rel", "codel_table")
    scalar_bytes = sum(
        row_bytes(t) for n, t in named.items()
        if n in ("q_count", "ob_fill") or (
            t.dim() >= 1 and t.shape[0] == h and n not in tcp_names
            and n not in table_names and not n.startswith(("q_", "ob_")))
    )
    slot_bytes = sum(row_bytes(named[n][0]) for n in ("q_tie", "q_kind", "q_aux", "q_data"))
    tables_bytes = sum(named[n].numel() * named[n].element_size() for n in table_names)
    read = (h * named["q_head"].element_size() + live * row_bytes(named["q_time"])
            + q_sel * slot_bytes + live * match_bytes + n_touched * socket_bytes
            + rows_taking * scalar_bytes + tables_bytes)
    write = 0
    for (_, a), (_, b) in zip(tree_leaves_with_path(st), tree_leaves_with_path(after)):
        write += int((a != b).sum()) * a.element_size()
    nbytes = read + write
    # a compare and a select per slot of each queue scan, a few hundred
    # scalar operations per taken event
    ops = q_sel * cap * 2 + taken * 600
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    reck = dict(live_rows=live, queue_selections=q_sel, taken=taken, rows_taking=rows_taking,
                sockets_touched=n_touched, read_bytes=read, write_bytes=write, ops=ops)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), reck


def profile_main_path(st0, model, tables, cfg, end_ns) -> None:
    """The main path under torch.profiler: device time by kernel, the
    device's idle share over the wall, and the host's top ops."""
    from torch.profiler import ProfilerActivity, profile

    from shadow_tpu_torch.engine.round import run_until

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        run_until(st0, end_ns, model, tables, cfg, rounds_per_chunk=16)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    dev_ms = {a.key: a.self_device_time_total / 1e3 for a in avgs
              if getattr(a, "self_device_time_total", 0) > 0}
    busy = sum(dev_ms.values())
    kernels = sum(1 for e in prof.events() if str(e.device_type).endswith("CUDA"))
    top_dev = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
    top_cpu = sorted(((a.key, a.self_cpu_time_total / 1e3, a.count) for a in avgs),
                     key=lambda t: -t[1])[:10]
    line("profile", wall_ms_under_profiler=wall_ms, device_busy_ms=busy,
         device_idle_share=1 - busy / wall_ms if wall_ms else None,
         device_kernels=kernels,
         pump_megakernel_ms=sum(v for k, v in dev_ms.items() if "pump_megakernel" in k),
         top_device=[[k[:60], v] for k, v in top_dev],
         top_host=[[k[:60], ms, n] for k, ms, n in top_cpu])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=BENCH_HOSTS)
    ap.add_argument("--end-ns", type=int, default=BENCH_END_NS)
    ap.add_argument(
        "--profile", action="store_true",
        help="also run the main path once under torch.profiler and print "
        "where the device and host time goes",
    )
    ap.add_argument(
        "--rehearse-cpu", action="store_true",
        help="rehearse the phases on the CPU with the kernel's plain twin "
        "(no build, no kernel; never prints a result)",
    )
    args = ap.parse_args(argv)
    full = args.hosts == BENCH_HOSTS and args.end_ns == BENCH_END_NS
    if not full and not args.rehearse_cpu:
        ap.error("--hosts and --end-ns size a CPU rehearsal; the card runs the full bench world")

    if not args.rehearse_cpu and not torch.cuda.is_available():
        print("chip_smoke: CUDA not available; this smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from shadow_tpu_torch import equeue
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.pump import pump_stage
    from shadow_tpu_torch.engine.round import (
        _next_window_end,
        effective_engine,
        host_stats,
        run_until,
    )

    if args.rehearse_cpu:
        dev, smi = torch.device("cpu"), "cpu rehearsal"
    else:
        dev = torch.device("cuda", 0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        line("card", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
             kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

        # 2. build
        t0 = time.perf_counter()
        mk.PUMP_KERNEL.library()
        ptxas = [ln.strip() for ln in mk.PUMP_KERNEL.build_log.splitlines()
                 if "registers" in ln or "spill" in ln or "stack frame" in ln]
        line("build", seconds=round(time.perf_counter() - t0, 3),
             nvcc_seconds=mk.PUMP_KERNEL.build_seconds, ptxas=ptxas)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # 3. kernel vs twin at full width, in the burst
    cfg, model, tables, st0 = bench_world(args.hosts, dev)
    stage_cfg = mk.resolve_stage_cfg(cfg)
    t0 = time.perf_counter()
    st_b = run_until(st0, BURST_NS, model, tables, dataclasses.replace(cfg, engine="plain"))
    sync()
    advance_s = time.perf_counter() - t0
    start = equeue.next_time(st_b.queue).amin()
    we = _next_window_end(st_b, args.end_ns, cfg, start, tables)
    elig = equeue.next_time(st_b.queue) < we
    tallies = {"steps": [], "live_rows": int(elig.sum())}
    twin, rej_t = pump_stage(st_b.clone(), we, model, tables, stage_cfg,
                             debug_out=tallies["steps"])
    launches0 = mk.PUMP_KERNEL.launches
    kern, rej_k = mk.megakernel_stage(st_b.clone(), we, model, tables, stage_cfg)
    sync()
    bad, max_abs_err = leaves_equal(twin, kern)
    classes = {k: sum(d[k] for d in tallies["steps"]) for k in ("p1", "p2", "p3", "rejected")}
    ok3 = not bad and bool(rej_t) == bool(rej_k) and all(classes[k] > 0 for k in ("p1", "p2", "p3"))
    line("kernel_vs_twin", ok=ok3, mismatched_leaves=bad, max_abs_err=max_abs_err,
         rejected=[bool(rej_t), bool(rej_k)],
         classes=classes, live_rows=tallies["live_rows"], advance_s=round(advance_s, 3))
    if not ok3:
        return 1
    reps = 20
    if dev.type == "cuda":
        ms_k = kernel_device_ms(st_b, we, model, tables, stage_cfg, reps)
    else:
        ms_k = timed_ms(lambda s: mk.megakernel_stage(s, we, model, tables, stage_cfg), reps,
                        st_b.clone, dev)
    ms_t = timed_ms(lambda s: pump_stage(s, we, model, tables, stage_cfg), 5, st_b.clone, dev)
    mk.PUMP_KERNEL.launches = launches0  # comparison launches do not count
    bound_ms, bound_by, reck = pump_bound(st_b, we, model, tables, stage_cfg, tallies, twin)
    line("kernel_time", kernel_ms=ms_k, twin_ms=ms_t, bound_ms=bound_ms, bound_by=bound_by,
         share_of_bound=bound_ms / ms_k, reckoning=reck, reps=reps)
    del twin, kern, st_b

    # 3b. kernel vs twin where loss draws drop packets (the bench world's
    # pairs share a node and never lose one), shaped and unshaped
    lossy_hosts = min(LOSSY_HOSTS, args.hosts)
    for shaped, mid_ns in ((True, LOSSY_MID_NS_SHAPED), (False, LOSSY_MID_NS_UNSHAPED)):
        lcfg, lmodel, ltables, l0 = lossy_world(lossy_hosts, dev, shaped=shaped)
        lst = run_until(l0, mid_ns, lmodel, ltables, dataclasses.replace(lcfg, engine="plain"))
        lwe = _next_window_end(lst, 10**9, lcfg, equeue.next_time(lst.queue).amin(), ltables)
        scfg = mk.resolve_stage_cfg(lcfg)
        steps = []
        twin, rej_t = pump_stage(lst.clone(), lwe, lmodel, ltables, scfg, debug_out=steps)
        kern, rej_k = mk.megakernel_stage(lst.clone(), lwe, lmodel, ltables, scfg)
        sync()
        bad, err = leaves_equal(twin, kern)
        max_abs_err = max(max_abs_err, err)
        classes = {k: sum(d[k] for d in steps) for k in ("p1", "p2", "p3", "rejected")}
        drops = int((twin.packets_dropped - lst.packets_dropped).sum())
        runs = {}
        for eng_name in ("plain", "megakernel"):
            out = run_until(l0, LOSSY_END_NS, lmodel, ltables,
                            dataclasses.replace(lcfg, engine=eng_name), rounds_per_chunk=16)
            runs[eng_name] = (host_stats(out), int(out.model.streams_done.sum()),
                              int(out.model.bytes_down.sum()))
            del out
        diff = [k for k in runs["plain"][0] if k not in ("iters_done", "lanes_live")
                and not np.array_equal(runs["plain"][0][k], runs["megakernel"][0][k])]
        fired = classes["p2"] > 0 and classes["p3"] > 0 and (classes["p1"] > 0 or not shaped)
        ok3b = (not bad and bool(rej_t) == bool(rej_k) and fired and drops > 0 and not diff
                and runs["plain"][1:] == runs["megakernel"][1:])
        line("kernel_vs_twin_lossy", ok=ok3b, shaped=shaped, hosts=lossy_hosts,
             mismatched_leaves=bad, classes=classes, stage_drops=drops,
             rejected=[bool(rej_t), bool(rej_k)], run_differing=diff,
             run_dropped=int(runs["plain"][0]["packets_dropped"].sum()),
             streams_done=[runs[e][1] for e in runs])
        if not ok3b:
            return 1
        del twin, kern, lst, l0

    # 4. the main path at full width (the earlier phases' states are
    # freed before the peak is reset, so the peak is the main path's)
    eng = effective_engine(dataclasses.replace(cfg, engine="auto"), dev)
    counters = {}
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mk.PUMP_KERNEL.launches = 0
    t0 = time.perf_counter()
    final = run_until(st0, args.end_ns, model, tables, cfg, rounds_per_chunk=16,
                      counters=counters)
    sync()
    wall = time.perf_counter() - t0
    main_launches = mk.PUMP_KERNEL.launches
    got = dict(
        events=int(final.events_handled.sum()),
        streams_done=int(final.model.streams_done.sum()),
        bytes_down=int(final.model.bytes_down.sum()),
    )
    want = dict(events=BENCH_EVENTS, streams_done=BENCH_STREAMS_DONE, bytes_down=BENCH_BYTES_DOWN)
    ok4 = (eng == "megakernel" and main_launches > 0) or dev.type == "cpu"
    ok4 = ok4 and (got == want or not full)
    line("main_path", ok=ok4, engine=eng, counters=got, pinned=want if full else None,
         wall_s=round(wall, 3), sim_s_per_wall_s=args.end_ns / 1e9 / wall,
         kernel_launches=main_launches, iters=counters.get("iters"),
         max_memory_allocated=torch.cuda.max_memory_allocated() if dev.type == "cuda" else None)
    if not ok4:
        return 1
    del final

    # 5. engines agree on the card
    short = min(100_000_000, args.end_ns)
    hs, walls = {}, {}
    for eng_name in ("plain", "megakernel"):
        sync()
        t0 = time.perf_counter()
        out = run_until(st0, short, model, tables, dataclasses.replace(cfg, engine=eng_name),
                        rounds_per_chunk=16)
        sync()
        walls[eng_name] = time.perf_counter() - t0
        hs[eng_name] = host_stats(out)
        del out
    diff = [k for k in hs["plain"] if k not in ("iters_done", "lanes_live")
            and not np.array_equal(hs["plain"][k], hs["megakernel"][k])]
    ok5 = not diff
    line("engines_agree", ok=ok5, differing=diff, end_ns=short, wall_s=walls,
         iters={k: int(v["iters_done"].sum()) for k, v in hs.items()})
    if not ok5:
        return 1
    if args.profile and dev.type == "cuda":
        profile_main_path(st0, model, tables, cfg, args.end_ns)

    # 6. the CLI entry point on the tgen example
    with tempfile.TemporaryDirectory() as tmp:
        src = open(os.path.join(HERE, "examples", "tgen", "shadow.yaml")).read()
        data = os.path.join(tmp, "data")
        cfg_path = os.path.join(tmp, "shadow.yaml")
        with open(cfg_path, "w") as f:
            f.write(src.replace("data_directory: shadow.data", f"data_directory: {data}"))
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "shadow_tpu_torch", "run", cfg_path]
        if dev.type == "cpu":
            cmd += ["--device", "cpu"]
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True)
        cli_s = time.perf_counter() - t0
        stats = {}
        if proc.returncode == 0:
            with open(os.path.join(data, "sim-stats.json")) as f:
                stats = json.load(f)
        got6 = {k: stats.get(k) for k in TGEN_EXAMPLE_STATS}
        ok6 = proc.returncode == 0 and got6 == TGEN_EXAMPLE_STATS
        line("cli", ok=ok6, rc=proc.returncode, stats=got6, execution=stats.get("execution"),
             wall_s=round(cli_s, 3), stderr_tail=proc.stderr[-2000:] if not ok6 else "")
        if not ok6:
            return 1

    if dev.type == "cpu":
        line("rehearsal_done", note="no result: the kernel runs only on the card")
        return 3

    # 7. the kernels line, the card line, and the result
    print(json.dumps({"kernels": [{
        "name": "pump_megakernel",
        "route": "cuda",
        "source": "shadow_tpu_torch/csrc/pump_megakernel.cu",
        "replaces": "shadow_tpu/engine/megakernel.py:211",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": ms_k,
        "plain_ms": ms_t,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
