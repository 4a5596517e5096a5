"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full smoke (H = 10,240 hosts)

Phases, each printing one line; any failure exits non-zero:
  1. identify the card (nvidia-smi name/power limit, torch and CUDA versions);
  2. build the pump megakernel from csrc/ with nvcc (sm_90a): the library
     of the default TCP shape (4 out-of-order ranges, 4 segments a flush)
     here, those of the shapes phase's shapes (8, 8) and (2, 2) in threads
     beside it and phase 3, then waited for (nvcc's seconds, registers
     and spill bytes per instance);
  3. kernel vs its plain twin at full width: the bench world (10,240 hosts,
     32-node lossy graph, 100 Mbit shaped hosts, tgen 100 KB streams over
     TCP, tracker on) advanced on the card into the burst, then one kernel
     stage and one twin stage on clones of the same state, every leaf equal;
     the kernel timed alone at four launches of that world (the burst at
     pump_k 8 and 16, mid-run at 20 ms, and at 30 ms, where every live row
     rejects its head), each also held against the twin; kernel vs twin on
     states that reach the kernel's edge cases: a queue of 8 slots whose
     rows start full, a queue of 1,100 slots whose rows hold more slots
     below the window end than the kernel stages, and a host count that is
     not a multiple of the rows a warp owns, and on one shard's rows (a
     quarter of the hosts, row index != host id) at the burst, timed with
     its bound; then the same on a 4,096-host world whose streams cross
     lossy links (shaped and unshaped), plus whole runs of both engines
     there;
     wide_kernel: the kernel's wide instances, which take any pump_k and
     any socket count: tgen's at pump_k 40 in the burst (timed with its
     bound), on the edge states and on rows that take 40 events in one
     launch, on rows with more slots below the window end than a wide
     pass stages and equal times and ties across the list's end, and at
     pump_k 80, past the list and FIFO entries a wide launch's shared
     memory holds; its main path from the burst to 20 ms against the plain
     engine; onion's at 16 and 32 circuits per relay (33 and 65 sockets),
     its main paths to 35 ms, then kernel vs twin there, timed,
     and at 33 sockets also at pump_k 40; each wide launch prints its dynamic shared
     memory; while those
     two host-bound runs go on, the onion cell's plain-engine run (phase
     7) and every CLI run of the smoke go on in processes of their own,
     which end before any kernel is timed: on examples/onion (stop time cut, sim-stats pinned), on examples/fattree
     (graph from gen_fattree.py 8: two outbox recoveries, 64 -> 128 ->
     256, and the reference's 88,768 events), on examples/tgen
     (sim-stats pinned), again at 8 rounds a chunk with --tracker,
     --trace-file, --metrics-file, --metrics-prom and --xprof-dir
     (sim-stats pinned, with `tracker`, `metrics` and `memory` sections;
     the dispatch spans, one heartbeat line per host, the profiler's
     trace naming the kernel; `metrics` renders its stream; `mem --json`
     prices the example's state at 313,656 B),
     on examples/phold (stop time cut, sim-stats pinned) and `run
     --replicas 2` on it (replica 0 the pinned single run);
  4. the main path: run_until to 0.5 s sim with engine "auto", which must
     resolve to the kernel; bench counters equal the pinned oracle values;
  5. plain vs megakernel engines agree on host_stats at 0.1 s sim;
     recovery: the bench world at an 8-slot outbox recovers through the
     kernel (8 -> 16 -> 32) to the oracle's counters and the main path's
     final state, and an R = 2 ensemble of it to 0.1 s regrows the whole
     batch, leaf-equal to the ensemble started at the grown capacity;
     checkpoint: the main path (1 round per chunk) interrupted at 10 ms
     and resumed from its checkpoint file, leaf-equal to the
     uninterrupted run;
  6. observability-10240: the main path again with a Tracker (per-host
     heartbeats every 250 ms to a file, the dispatch trace), an
     installed FlightRecorder (metrics stream, prom file) and a
     torch.profiler capture of chunks 1 to 3: leaf-equal to the main
     path, its fold equal to the main path's, one sample per chunk with
     the card's bytes in use, the profiler's trace naming the kernel, one
     heartbeat line per host; its wall beside the main path's, and the
     main path's wall run again once the capture has stopped;
  6a. guards-10240: the main path through TpuScheduler.run under the
     run-loop guards: a chaos plan at 8 rounds a chunk (an injected
     capacity error at chunk 1, a stall in chunk 2's probe read under a
     chunk watchdog of 1.5 times the main path's wall, at least 5 s, the
     stall 1 s longer: two recoveries, capacity then watchdog), as long a
     device-side stall (torch.cuda._sleep) on the stream at chunk 2's
     launch under the same watchdog and no chaos plan (one watchdog
     recovery), an injected compile fault on
     the megakernel (one fallback, megakernel -> pump; the pump twin
     finishes the run), and the autotuner walking 64 rounds a chunk down
     to 16 from a cached probe wall; each run leaf-equal to the main
     path's, its launches counted; in the background, beside the wide
     onion runs (phase 3a): examples/tgen with `--autotune` (a real
     probe), with checkpoints under a ckpt-corrupt fault, interrupted and
     resumed past the damaged file, and with `scheduler: cpu-ref` (sim-
     stats and hosts file equal to the card run's), and the cpu-ref
     oracles against the engine on the card on the reference tests' small
     tgen, bulk-tcp and phold worlds (`--cpu-ref OUT`, a process of its
     own), every TCP field, counter and leftover queue entry equal;
  7. onion-10240: the onion model (4,096 clients, 6,144 relays, 17 sockets
     per host) on the bench graph and shaping: the main path to its burst
     (40 ms) with engine "auto" (the kernel's onion instance); the plain
     engine on the same world to 40 ms (run in a process of its own
     during phase 3a), whose host and model counters must agree with the
     main path's; kernel vs twin at the burst launch, which is the main
     path's end, timed alone with its bound;
  8. phold, bulk-tcp, cdn and gossip (no pump kernel) on the card and on
     the CPU in this process, leaf-equal, at small size; phold at 10,240
     hosts on the bench graph;
  9. the ensemble plane (R seeded replicas as one batch, one kernel launch
     over all R x H rows per drain iteration):
     ensemble-tgen-10240x8, the lossy tgen world (6 nodes) at 10,240 hosts x 8
     replicas (81,920 rows) to 60 ms: the main path with engine "auto", replicas 0
     and 7 held against single kernel runs seeded 11 and 18 (the first is
     the R = 1 run it is compared with), launches against drain
     iterations, and the kernel against its twin at the burst, timed with
     its bound; ensemble-onion-10240x4, the onion cell x 4 replicas
     (horizon cut to ENS_ONION_END_NS), replica 0 against a single onion
     kernel run, kernel against twin at its end; ensemble-ragged, 10,235
     hosts x 2 replicas (a warp owns rows of both), kernel against twin;
  9a. planes-10240, the reference's other execution planes through the
     kernel: the bench world to 0.5 s with exchange "segment" and with
     it and active_lanes 1,280 (H / 8), each at the oracle's
     counters and equal to the main path's final state (queues in pop
     order; iters_done and lanes_live apart under compaction), and with
     use_dynamic_runahead through the kernel engine and the twin engine,
     every leaf equal; kernel vs twin, timed, on a compacted sub-state
     with sentinel lanes (the lossy world at 10,240 hosts, whose hosts
     spread), on a dyn_runahead launch in the burst whose min_used
     changes, and on a compacted sub-state of the ragged ensemble
     (10,235 x 2, 2,560 rows, 1,280 a replica); that ensemble with all
     three planes to 30 ms against its single runs; how many of 10^6
     f32 draws of rng.exponential_ns CUDA's log1pf makes differ from the
     CPU's;
  9b. managed: examples/http (guests built by cc) through `python -m
     shadow_tpu_torch run` three ways, the hybrid with its device plane on
     the card, the same with --device cpu and `scheduler: managed` (the
     serial host kernel, no device), and at parallelism 2 under a
     worker-kill fault: guest stdout, strace files and sim-stats equal,
     the killed worker respawned once; the three ways again in this
     process, their packet event logs equal as sorted multisets; then
     hybrid-http-matrix-128, tools/bench_hybrid.py's world cut to 256
     examples/http-matrix guests (4 kernel workers; the CLI runs start
     beside the wide onion runs, phase 3a) through the port's
     ParallelHybridScheduler with the device state on the card: every
     client fetched its document, and the syscall, packet and device-pass
     counts equal the JAX package's run of that world on the CPU;
  9c. services-10240: `sweep` in this process over the lossy tgen world
     at 10,240 hosts (6 nodes, GML inline): seeds 0-7 in two batches of
     4 x 10,240 rows through the kernel's tgen instance, a priority-1 job
     arriving at 20 ms on the service clock preempts the running batch
     through a verified final checkpoint and the batch resumes from it;
     every job done, builds equal to the distinct worlds (2) and hits for
     the resume and the second batch (2), the preempted job and one of
     the other batch leaf-equal to single runs of their seeds; its daemon
     part ran in a process of its own since phase 9 (`serve`
     daemons on the card taking submitted examples/tgen jobs: one whose
     cache entry a cache-corrupt fault damages, SIGKILLed mid-batch by the
     chaos plane; the restart, which rebuilds the entry with its warning
     and loses no job, each job's sim-stats that of a single run; a warm
     start with zero builds behind the HTTP front door on 127.0.0.1);
  9d. mesh: the multi-device planes on 8 logical devices of the card
     (SHADOW_TPU_TORCH_LOGICAL_DEVICES): sharded-10240, the bench world
     through TpuScheduler with parallelism 4 (all_to_all, the auto
     bucket) to 0.5 s, the kernel launched on each shard's rows, at the
     oracle's counters and equal to the main path's final state but for
     the per-shard diagnostics; and what ran in processes of their own
     since phase 9: mesh-2x4-lossy-10240x2 (`--mesh-lossy OUT`: the lossy
     world x 2 on a 2x4 grid, the segment exchange's ring, to 40 ms,
     plain, under a device loss of logical device 5 that degrades it to
     2x2, and interrupted at 20 ms then resumed on 1x4, each equal to the
     same batch through run_ensemble_until in pop order), `run --mesh
     2x2` of the phold example (stop time cut) straight and resumed on
     1x2 (its log naming the reshard), each equal to `run --replicas 2`
     on it, and a `sweep` of examples/tgen (stop time cut) with `mesh:
     2x2` equal job for job to the same sweep without one, one build;
  9e. shapes: models registered at TCP shapes other than (4, 4) through
     the kernel's libraries of those shapes: tgen_ooo8 (8 ranges, 8
     segments) on the services world at 10,240 hosts to 60 ms through the
     port's Manager in this process, engine "auto" (the kernel,
     tgen@8x8) and at pump_k 40 (tgen_wide@8x8), each equal to the plain
     engine's run of the same config in host_stats and model counters;
     its kernel vs twin at the 26 ms burst at pump_k 8, 16 and 40, timed
     with its bound; onion_r2s2 (2 ranges, 2 segments) on the onion
     cell's world through the kernel (onion@2x2) to 37 ms in a process of
     its own since phase 9, and its kernel vs twin on that run's states
     at 29 and 37 ms, timed;
 10. the narrow instances' R = 1 launch times beside the earlier record,
     the wide instances' launch times beside theirs before the redesign,
     the kernels JSON line (one entry per template instance of the
     kernel, and per instance at another TCP shape), the card line, and
     the final JSON line.

Imports torch, numpy and the port only (no jax, nothing of shadow_tpu/).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import random
import re
import shlex
import signal
import subprocess
import sys
import tempfile
import threading
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
# examples/phold/shadow.yaml (64 hosts) cut from 2 s to 0.5 s and
# examples/onion/onion.yaml (11 hosts) cut from 0.6 s to 0.25 s, as
# tests/test_torch_models_cli.py cuts them: the same, pinned from the JAX
# package's run of the cut configs
PHOLD_EXAMPLE_STOP = ('stop_time: "2 s"', 'stop_time: "500 ms"')
PHOLD_EXAMPLE_STATS = {
    "events_handled": 3_683,
    "packets_sent": 1_843,
    "packets_dropped": 0,
    "packets_unroutable": 0,
    "sim_seconds": 0.5,
    "scheduler": "tpu",
    "num_hosts": 64,
    "unexpected_final_states": [],
}
ONION_EXAMPLE_STOP = ('stop_time: "600 ms"', 'stop_time: "250 ms"')
ONION_EXAMPLE_STATS = {
    "events_handled": 2_384,
    "packets_sent": 764,
    "packets_dropped": 0,
    "packets_unroutable": 0,
    "sim_seconds": 0.25,
    "scheduler": "tpu",
    "num_hosts": 11,
    "unexpected_final_states": [],
}
# sim time at which the bench world is in its burst: the first pump
# stage of the next round takes P1, P2 and P3 events and rejects others
BURST_NS = 14_000_000
# later launches of the bench world: mid-run, and one where every live
# row rejects its head event (most launches of a run are this small)
MID_NS = 20_000_000
REJECTS_NS = 30_000_000
# the edge-case states of phase 3: a small queue, a queue above the
# kernel's staging area (with this many events added just below the
# window end on half of the rows), and a host count this many rows short
# of a multiple of the rows a warp owns
SMALL_QUEUE = 8
LARGE_QUEUE = 1100
LARGE_QUEUE_EXTRA = 48
RAGGED_SHORT = 5
# the lossy world of phase 3b: hosts, and the sim times at which its
# next pump stage takes P1 (shaped only), P2 and P3 events, rejects
# others and drops packets to loss draws
LOSSY_HOSTS = 4096
LOSSY_MID_NS_SHAPED = 26_000_000
LOSSY_MID_NS_UNSHAPED = 22_000_000
# the whole runs of both engines there end here (cut from 120 ms to make
# room for the mesh phase: past both bursts and the streams'
# second requests after their 30 ms pause)
LOSSY_END_NS = 60_000_000
# the onion cell: 10,240 hosts, 4,096 clients (0.4) and 6,144 relays
# (about Tor's consensus size), to ONION_END_NS, in its burst (the plain
# handler, which every relay event takes, holds the host ~66 ms per drain
# iteration on an H100's host, so 0.6 s would take ~10 min a run, and
# the smoke's time limit, with every phase, holds 40 ms: the onion
# launches take P2 and P3 events from ~35 ms on); its kernel is held
# against the twin and timed there (ONION_BURST_NS), which is the end of
# the main path
ONION_CLIENT_SHARE = 0.4
ONION_BURST_NS = 40_000_000
ONION_END_NS = ONION_BURST_NS
ONION_WINDOW_CAP_NS = 1_000_000_000
# wide_kernel: pump_k past a narrow instance's MAX_K, in the bench burst
# and on the burst state's run to WIDE_RUN_NS; onion past 32 sockets, at
# circuits_per_relay 16 and 32 (33 and 65 sockets), each to
# ONION_WIDE_SHORT_NS, short of the burst, where its launches already
# take P2 and P3 events (each run host-bound, ~85 s to the burst alone on
# the card's host, up to 240 s beside the other processes, which the
# smoke's time limit does not hold: the CLI runs of background_clis and
# the onion cell's plain-engine run go on in processes of their own
# meanwhile, and no kernel is timed until they have ended)
WIDE_PUMP_K = 40
WIDE_RUN_NS = 20_000_000
# wide_kernel's edge states on the 30 ms state's idle rows
# (deferring_queue at group 3, columns rebuilt by rebuilt_queue): rows of
# BOUNDARY_ARRIVALS arrivals at pump_k WIDE_PUMP_K, more slots below the
# window end than a wide pass stages, with equal times and ties across
# the list's end; and rows of WIDE_PAST_ARRIVALS arrivals at pump_k
# WIDE_PAST_K, past the list entries and FIFO entries a wide launch's
# shared memory holds (megakernel.WIDE_LIST_CAP, WIDE_FIFO_CAP: 64)
BOUNDARY_ARRIVALS = 60
WIDE_PAST_K = 80
WIDE_PAST_ARRIVALS = 100
ONION_WIDE_SHORT_NS = 35_000_000
ONION_WIDE_NS = {16: ONION_WIDE_SHORT_NS, 32: ONION_WIDE_SHORT_NS}
# recovery: the bench world at an outbox of RECOVERY_OUTBOX slots, below
# its 32: the start's burst overflows it in the first chunk, and recovery
# regrows it 8 -> 16 -> 32 (the bench's own capacity); its R = 2 ensemble
# to RECOVERY_ENS_END_NS
RECOVERY_OUTBOX = 8
RECOVERY_ENS_REPLICAS = 2
RECOVERY_ENS_END_NS = 100_000_000
# checkpoint: the bench main path at CHECKPOINT_RPC rounds per chunk (so
# that chunk boundaries fall inside the streams, which end by ~33 ms),
# a checkpoint every CHECKPOINT_INTERVAL_NS, interrupted once sim time
# reaches CHECKPOINT_INTERRUPT_NS, then resumed
CHECKPOINT_RPC = 1
CHECKPOINT_INTERVAL_NS = 4_000_000
CHECKPOINT_INTERRUPT_NS = 10_000_000
# examples/fattree (its graph from examples/fattree/gen_fattree.py 8):
# what the JAX package's `shadow-tpu run` gives on the CPU (ROADMAP,
# Queue 3's record): two recoveries, outbox 64 -> 128 -> 256, and these
# events
FATTREE_STATS = {"events_handled": 88_768}
FATTREE_RECOVERIES = [(256, 128), (256, 256)]
# the narrow instances' R = 1 launch times as recorded before the wide
# instances were added (PERF.md §6; NVIDIA H100 80GB HBM3, 700.00 W),
# which this run's are printed beside
EARLIER_LAUNCH_MS = {"burst_k8": 0.1442, "burst_k16": 0.1546, "mid_20ms_k8": 0.0910,
                 "rejects_30ms_k8": 0.0289, "onion_burst": 0.0635}
# the wide instances' launch times as recorded before their redesign for
# Hopper (PERF.md §6; the same card), which this run's are printed beside
EARLIER_WIDE_LAUNCH_MS = {"tgen_wide_burst_k40": 0.5351, "onion_wide_33_sockets": 0.1308,
                          "onion_wide_65_sockets": 0.1593}
# the ensemble cells: replicas of the lossy tgen world on ENS_TGEN_NODES
# nodes (main path to ENS_TGEN_END_NS, paused at LOSSY_MID_NS_SHAPED,
# where the batch's kernel is held against its twin and timed), replicas
# of the onion cell (its horizon cut below ONION_END_NS to fit the smoke's
# time limit: the onion main path is host-bound), and a ragged ensemble
# (RAGGED_SHORT hosts short of a multiple of the rows a warp owns) of
# ENS_RAGGED_REPLICAS
ENS_TGEN_REPLICAS = 8
ENS_TGEN_NODES = 6
# cut from 120 ms for the mesh phase: past the burst and the
# second requests of the streams' 30 ms pause
ENS_TGEN_END_NS = 60_000_000
ENS_ONION_REPLICAS = 4
ENS_ONION_END_NS = 30_000_000
ENS_RAGGED_REPLICAS = 2
# the small worlds of phold, bulk-tcp, cdn and gossip (card vs CPU; the
# tests hold them against the JAX package at this horizon too), and the
# horizon of phold at full width (cut from 200 ms to make room for the
# mesh phase)
SMALL_WORLD_END_NS = 200_000_000
PHOLD_END_NS = 100_000_000
# planes-10240: active_lanes = hosts / PLANES_LANES_DIV (1,280 at full
# width, as tools/profile_kernels.py sizes it); the end of the search, in
# steps of 1 ms from the lossy world's burst, for a state whose next
# window holds fewer eligible rows than lanes; the ragged ensemble's horizon with all three
# planes; the draws of rng.exponential_ns compared between the card and
# the CPU
PLANES_LANES_DIV = 8
PLANES_SENTINEL_END_NS = 120_000_000
PLANES_RAGGED_END_NS = 30_000_000
PLANES_EXP_DRAWS = 1_000_000
PLANES_EXP_SEED = 7
PLANES_EXP_MEAN_NS = 1_000_000
# observability-10240: the main path with the host-side planes attached:
# per-host heartbeats every OBS_HEARTBEAT_NS (written to a file), the
# dispatch trace, the flight recorder with its metrics stream and prom
# file, and a torch.profiler capture over chunks OBS_XPROF_CHUNKS; and
# examples/tgen's state as `mem` prices it (the reference's 313,400 B
# and 16 B a host for the leaves the port holds as int64)
OBS_HEARTBEAT_NS = 250_000_000
OBS_XPROF_CHUNKS = (1, 3)
OBS_SPANS = ("compile+launch", "chunk_launch", "probe_fetch", "host_stats_fetch")
# the CLI part runs examples/tgen at this many rounds a chunk (the
# config's 128 make one chunk of the whole run): 16 chunks, four heartbeats
OBS_CLI_ROUNDS_PER_CHUNK = 8
TGEN_EXAMPLE_STATE_BYTES = 313_656
# guards-10240: the main path under the run-loop guards, through
# TpuScheduler.run with recovery on: (a) a chaos plan with an injected
# capacity error at chunk GUARD_CAPACITY_AT and a stall in chunk
# GUARD_STALL_AT's probe read under the chunk watchdog; (d) the same
# watchdog against as long a stall of device time spun on the stream
# (torch.cuda._sleep) at chunk GUARD_STALL_AT's launch. The watchdog's
# region is a chunk's launch and probe read, so its deadline is
# GUARD_WATCHDOG_OVER_MAIN times this run's main-path wall (which holds
# every chunk; 4.06-4.67 s on an H100 at 700 W, varying with the host),
# at least GUARD_WATCHDOG_FLOOR_S, and only the stall, GUARD_STALL_PAST_S
# longer, expires it;
# (b) an injected compile fault on the megakernel, which falls to the pump
# twin; (c) the autotuner walking GUARD_REQUESTED_RPC down from a cached
# probe wall (GUARD_PROBE_WALL_S projects 160, 80 and 40 s for 64, 32 and
# 16 rounds a chunk against a GUARD_BUDGET_S budget: 16, the main path's)
GUARD_CAPACITY_AT = 1
GUARD_STALL_AT = 2
# (a) runs at 8 rounds a chunk: the main path's 18 live rounds make 2
# chunks of 16 (no chunk 2 to stall in) and 3 of 8. Its idle rounds (the
# tail of the last chunk) are then 6 where the main path's are 14, so
# `.tracker.rounds_idle` is the one leaf (a) does not hold equal.
GUARD_CHAOS_RPC = 8
GUARD_WATCHDOG_OVER_MAIN = 1.5
GUARD_WATCHDOG_FLOOR_S = 5.0
GUARD_STALL_PAST_S = 1.0
GUARD_REQUESTED_RPC = 64
GUARD_BUDGET_S = 60.0
GUARD_PROBE_WALL_S = 10.0
GUARD_RPC = 16
# the guards' CLI runs of examples/tgen in the background: a real autotune
# probe under a budget of GUARD_CLI_AUTOTUNE_S seconds; checkpoints every
# GUARD_CKPT_INTERVAL with the run interrupted at GUARD_INTERRUPT_NS (the
# interrupt guard's sim-time knob), its final checkpoint (write 1)
# corrupted by the chaos plane, then resumed
GUARD_CLI_AUTOTUNE_S = 5
GUARD_CKPT_INTERVAL = "1 s"
GUARD_INTERRUPT_NS = 1_500_000_000
GUARD_CKPT_FAULT = "ckpt-corrupt@1"
GUARD_RESUME_INTERVAL = "10 s"  # past the example's 4 s: the resumed run writes none
INTERRUPT_ENV = "SHADOW_TPU_TEST_INTERRUPT_AT_NS"
# the cpu-ref oracles against the engine on the card, on the reference
# tests' small worlds (tests/test_cpu_ref_tgen.py, test_cpu_ref_bulk.py,
# test_engine_phold.py): (loss, shaped, end ms[, active lanes])
ORACLE_TGEN = ((0.0, False, 250, 0), (0.05, False, 400, 0), (0.02, True, 400, 0),
               (0.02, True, 400, 3))
ORACLE_BULK = ((0.0, False, 60), (0.05, False, 200), (0.02, True, 200))
ORACLE_PHOLD_LOSS = (0.0, 0.2)
ORACLE_PHOLD_END_NS = 60_000_000
TCP_FIELDS = (
    "st", "lport", "rport", "rhost", "snd_una", "snd_nxt", "snd_max",
    "snd_end", "fin_pending", "fin_sent", "peer_wnd", "rcv_nxt", "rcv_fin",
    "delivered", "ooo", "sacked", "rtx_mark", "cwnd", "ssthresh", "dupacks", "recover",
    "in_rec", "srtt", "rttvar", "rto", "rtt_pending", "rtt_seq", "rtt_ts",
    "rto_expire", "backoff", "tev_time", "retransmits", "segs_in", "segs_out",
)
# managed: examples/http three ways (the hybrid on the card, the hybrid
# with --device cpu, `scheduler: managed`) and at parallelism 2 under a
# worker kill (CLI runs started beside the wide onion runs); then
# tools/bench_hybrid.py's world at the repro in BENCH_HYBRID_r03.json
# (`python tools/bench_hybrid.py 512 4 1 12000`) cut to MATRIX_PAIRS
# pairs, because the smoke's time limit does not hold 512 on a slow host
# (147 s there, 1,024 guests), nor 256 beside the shapes phase (66-96 s):
# two sites 10 ms apart with 1 ms
# self-latency, MATRIX_PAIRS examples/http-matrix client/server pairs,
# MATRIX_WORKERS kernel workers, MATRIX_FETCHES fetch of MATRIX_BYTES,
# MATRIX_SIM_NS of sim time. MATRIX_STATS are the JAX package's counters
# for that run on the CPU (`python tools/bench_hybrid.py 128 4 1 12000`,
# JAX_PLATFORMS=cpu).
MANAGED_HTTP = "http/shadow.yaml"
MANAGED_GUESTS = ("http_server", "http_client")
MANAGED_KILL = "worker-kill@2"
MANAGED_SERIAL = "  scheduler: managed\n"
MANAGED_PARALLELISM = 2
MATRIX_PAIRS = 128
MATRIX_WORKERS = 4
MATRIX_FETCHES = 1
MATRIX_BYTES = 12_000
MATRIX_SIM_NS = 30_000_000_000
MATRIX_SEED = 7
MATRIX_STATS = {"syscalls": 3_968, "packets": 3_968, "device_passes": 385}
# services-10240 (phase 9c), the sweep in the foreground: a tgen world in
# lossy_world's style (40 KB responses, 30 ms pause, 20 Mbit hosts, loss
# 0.05 between SERVICES_NODES nodes, queue 192, outbox 32) at full width,
# written as a config with its GML inline, the clients on the first half
# of the nodes and their servers on the other half (so streams cross
# lossy links and seeds diverge); SERVICES_SEEDS seeds of one entry at
# capacity SERVICES_CAPACITY (two batches of 4 x 10,240 rows) and a job of
# priority 1 (seed SERVICES_HI_SEED) arriving at SERVICES_ARRIVAL_NS on the
# service clock, which preempts the running batch; every job runs to
# SERVICES_END_NS, past the burst (26 ms, LOSSY_MID_NS_SHAPED), at
# SERVICES_RPC rounds a chunk. The jobs in SERVICES_KEEP (the preempted
# batch's first, and one of the other batch) are held against single runs
SERVICES_NODES = 6
SERVICES_SEEDS = 8
SERVICES_CAPACITY = 4
SERVICES_HI_SEED = 100
SERVICES_ARRIVAL_NS = 20_000_000
SERVICES_END_NS = 40_000_000
SERVICES_RPC = 16
SERVICES_KEEP = ("lo-s0", "lo-s5")
# the daemon's part (`--services-daemon OUT`, a process of its own beside
# the wide onion runs): examples/tgen cut to SERVICES_DAEMON_STOP at
# SERVICES_DAEMON_RPC rounds a chunk with checkpoints every
# SERVICES_DAEMON_CKPT, jobs of two seeds each (16 chunks a batch: the
# streams end by 9 ms and resume after each 200 ms pause, so the first
# checkpoint is at chunk 4, 204 ms); the first daemon is SIGKILLed at
# chunk SERVICES_DAEMON_KILL_AT of its batch (216 ms, after that
# checkpoint); claims lease SERVICES_DAEMON_LEASE_S seconds; every
# subprocess waits at most SERVICES_DAEMON_WAIT_S. Three daemons, not
# one for each check: each start costs a process, torch and CUDA, and
# they share the host with the wide onion runs
SERVICES_DAEMON_STOP = "600 ms"
SERVICES_DAEMON_RPC = 2
SERVICES_DAEMON_CKPT = "50 ms"
SERVICES_DAEMON_KILL_AT = 8
SERVICES_DAEMON_LEASE_S = "2"
SERVICES_DAEMON_WAIT_S = 300
# a timed launch holds every process this script started (quiet_card):
# what they queued on the card drains for QUIET_DRAIN_S first
QUIET_DRAIN_S = 0.2
# 9d. mesh: the multi-device planes on logical devices of the one card
# (SHADOW_TPU_TORCH_LOGICAL_DEVICES): the bench world sharded over 4 of 8
# (all_to_all, the auto bucket); the lossy world at R replicas on a 2x4
# grid with the segment exchange's ring to MESH_END_NS, plain, under a
# device loss of MESH_LOSS_DEVICE at launch MESH_LOSS_AT (2x4 -> 2x2), and
# interrupted at MESH_INTERRUPT_NS then resumed on 1x4
MESH_LOGICAL_DEVICES = 8
MESH_SHARDS = 4
MESH_REPLICAS = 2
MESH_GRID = (2, 4)
MESH_RESUME_GRID = (1, 4)
MESH_END_NS = 40_000_000
MESH_RPC = 1  # a probe a round: the interrupt lands mid-run, the checkpoint before the end
MESH_LOSS_AT = 2
MESH_LOSS_DEVICE = 5
MESH_INTERRUPT_NS = 20_000_000
MESH_DROP = (".iters_done", ".lanes_live", ".tracker.exch_hwm")  # per-shard diagnostics
# the background mesh CLIs: `run --mesh 2x2` of the phold example (stop
# time cut) straight and interrupted at MESH_CLI_INTERRUPT_NS, resumed on
# 1x2; `sweep` of examples/tgen (stop time cut) seeds 0-3 with and
# without `mesh: 2x2`
MESH_CLI_GRID = "2x2"
MESH_CLI_RESUME_GRID = "1x2"
MESH_CLI_INTERRUPT_NS = 250_000_000
MESH_SWEEP_STOP = ('stop_time: "4 s"', 'stop_time: "1 s"')
MESH_SWEEP_SEEDS = 4
# shapes (phase 9e): models registered at a TCP shape (out-of-order
# ranges, segments per flush) other than tgen's (4, 4), each its base
# model's own args: tgen_ooo8 (TGEN_TCP apart from the shape) for a
# deeper out-of-order buffer on lossy, high-delay paths, and onion_r2s2
# (1 + 2 x circuits_per_relay sockets). tgen_ooo8 drives services_world at
# full width to SHAPES_END_NS through the port's Manager (engine auto, and
# at pump_k SHAPES_WIDE_K for the wide instance), held against the plain
# engine's run of the same config; its kernel vs the twin, timed, at the
# burst (LOSSY_MID_NS_SHAPED) at pump_k 8, 16 and SHAPES_WIDE_K. onion_r2s2
# runs onion_world through the kernel in a process of its own from phase
# 9 (`--onion-shape OUT`) and keeps its states at ONION_SHAPE_NS, where
# its launches take P2 and P3 events, for kernel vs twin here
SHAPE_MODELS = {"tgen_ooo8": ("tgen", (8, 8)), "onion_r2s2": ("onion", (2, 2))}
SHAPES_END_NS = 60_000_000
SHAPES_WIDE_K = 40
ONION_SHAPE_NS = (29_000_000, 37_000_000)
# H100 SXM device-memory rate (NVIDIA data sheet) for the bound column
HBM_BYTES_PER_S = 3.35e12
# non-tensor-core 32-bit rate (NVIDIA data sheet, FP32), the op yardstick
OPS_PER_S = 67e12


# every line this process printed (a process of its own hands them to
# the smoke in its record)
PRINTED: list = []


def line(phase: str, **kw) -> None:
    text = json.dumps({"phase": phase, **kw})
    PRINTED.append(text)
    print(text, flush=True)


def with_tcp_shape(model, shape):
    """`model` with its TCP params at `shape` (out-of-order ranges,
    segments per flush), every other field kept."""
    p = dataclasses.replace(model.tcp_params, ooo_ranges=shape[0], segs_per_flush=shape[1])
    return dataclasses.replace(model, tcp_params=p)


def register_shape_models(registry) -> None:
    """Register SHAPE_MODELS in `registry` (a package's models/registry
    module): each is that package's own builder of its base model (the
    base's args, parsed as for it) with the TCP params at its shape."""
    def at_shape(build, shape):
        return lambda num_hosts, args: with_tcp_shape(build(num_hosts, args), shape)

    for name, (base, shape) in SHAPE_MODELS.items():
        registry.register_model(name, at_shape(getattr(registry, f"_build_{base}"), shape))


def bench_graph(seed: int = 7):
    """bench.py's 32-node graph (2 ms self-loops, seven seeded lossy links
    per node at 2-11 ms, loss 0.005), written against the port."""
    from shadow_tpu_torch.graph import NetworkGraph

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
    return NetworkGraph.from_gml("\n".join(lines))


def bench_world(num_hosts: int, device, seed: int = 7, outbox_capacity: int = 32):
    """bench.py's _build_world + _build, written against the port (the
    recovery phase rebuilds it at a smaller outbox)."""
    from shadow_tpu_torch.engine.round import bootstrap
    from shadow_tpu_torch.engine.state import EngineConfig, init_state
    from shadow_tpu_torch.graph import compute_routing
    from shadow_tpu_torch.models.tgen import TgenModel
    from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill
    from shadow_tpu_torch.simtime import NS_PER_MS

    graph = bench_graph(seed)
    host_node = [i % 32 for i in range(num_hosts)]
    tables = compute_routing(graph, block=64, device=device).with_hosts(host_node)
    clients = num_hosts // 2
    cfg = EngineConfig(
        num_hosts=num_hosts,
        queue_capacity=384,
        outbox_capacity=outbox_capacity,
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


def onion_world(num_hosts: int, device, seed: int = 7, circuits_per_relay: int = 8,
                path: str = "onion"):
    """The onion cell: the bench graph and shaping (host i on node i % 32,
    100 Mbit up and down), ONION_CLIENT_SHARE of the hosts clients and the
    rest relays, examples/onion/onion.yaml's onion args and capacities
    (circuits_per_relay at its default of 8, so 17 sockets per host; the
    wide_kernel phase raises it), the model built by the registered
    builder `path` from those args."""
    from shadow_tpu_torch.engine.round import bootstrap
    from shadow_tpu_torch.engine.state import EngineConfig, init_state
    from shadow_tpu_torch.graph import compute_routing
    from shadow_tpu_torch.models.registry import build_model
    from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill

    graph = bench_graph(seed)
    tables = compute_routing(graph, block=64, device=device).with_hosts(
        [i % 32 for i in range(num_hosts)])
    clients = int(num_hosts * ONION_CLIENT_SHARE)
    cfg = EngineConfig(
        num_hosts=num_hosts,
        queue_capacity=192,
        outbox_capacity=64,
        runahead_ns=graph.min_latency_ns(),
        seed=seed,
        use_netstack=True,
        deliver_lanes=64,
        max_iters_per_round=256,
        tracker=True,
    )
    model = build_model(path, num_hosts, {
        "relays": num_hosts - clients, "hops": 3, "cell": 512, "req_cells": 2,
        "resp_cells": 20, "pause": "100 ms", "circuits": circuits_per_relay})
    bw = bw_bits_per_sec_to_refill(100_000_000)
    st = init_state(cfg, model.init(device), tx_bytes_per_interval=bw,
                    rx_bytes_per_interval=bw, device=device)
    return cfg, model, tables, bootstrap(st, model, cfg)


def lossy_gml(n_nodes: int, loss: float, seed: int) -> str:
    """lossy_world's graph: 2 ms self-loops, 2-8 ms (drawn from `seed`)
    and `loss` between nodes."""
    rng_py = random.Random(seed)
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
    return "\n".join(lines)


def lossy_world(num_hosts: int, device, shaped: bool = True, loss: float = 0.05, seed: int = 11,
                n_nodes: int = 5, tcp_shape=None):
    """A tgen world in the style of tests/test_pump.py (lossy edges between
    graph nodes, 20 Mbit hosts when shaped), written against the port.
    Host i sits on node i % n_nodes; with 5 nodes at 4,096 hosts, unlike
    the bench world, a client and its server sit on different nodes: loss
    draws drop packets and recovery runs. (At 10,240 hosts a client's
    first server, num_hosts / 2 rows on, shares its node when n_nodes
    divides 5,120; 6 nodes do not.) `tcp_shape` (out-of-order ranges,
    segments per flush) replaces TGEN_TCP's (4, 4)."""
    from shadow_tpu_torch.engine.round import bootstrap
    from shadow_tpu_torch.engine.state import EngineConfig, init_state
    from shadow_tpu_torch.graph import NetworkGraph, compute_routing
    from shadow_tpu_torch.models.tgen import TgenModel
    from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill
    from shadow_tpu_torch.simtime import NS_PER_MS

    graph = NetworkGraph.from_gml(lossy_gml(n_nodes, loss, seed))
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
    if tcp_shape is not None:
        model = with_tcp_shape(model, tcp_shape)
    bw = bw_bits_per_sec_to_refill(20_000_000) if shaped else None
    st = init_state(cfg, model.init(device), tx_bytes_per_interval=bw,
                    rx_bytes_per_interval=bw, device=device)
    return cfg, model, tables, bootstrap(st, model, cfg)


def rebuilt_queue(st, capacity: int, we: int, extra: int = 0, seed: int = 0,
                  order: str = "random"):
    """A copy of `st` whose event queue has `capacity` slots. Each row keeps
    its earliest `capacity` events by (time, tie); on a seeded half of the
    rows it also gains up to `extra` timer events just below the window
    end `we` (the pump rejects a non-packet event, so the row's earlier
    events keep their outcome). Events sit at seeded random columns, or
    with order "reversed" in descending (time, tie) order from the last
    column down, so that a row's column order is the reverse of the
    order its events are taken in and its free columns come first. A row
    whose kept events fill `capacity` starts full."""
    from shadow_tpu_torch.events import KIND_INVALID, KIND_MODEL_BASE, pack_tie
    from shadow_tpu_torch.simtime import TIME_MAX

    q = st.queue
    dev = q.time.device
    h, cap0 = q.time.shape
    g = np.random.default_rng(seed)
    # each row's events in (time, tie) order: stable sorts, tie then time
    o = torch.sort(q.tie, dim=1, stable=True).indices
    o = torch.gather(o, 1, torch.sort(torch.gather(q.time, 1, o), dim=1, stable=True).indices)
    keep = torch.clamp(q.count.to(torch.int64), max=capacity)
    sel = torch.from_numpy(g.random(h) < 0.5).to(dev)
    ext = torch.where(sel, torch.clamp(capacity - keep, max=extra), 0)
    j = torch.arange(capacity, device=dev)[None, :].expand(h, capacity)
    real = j < keep[:, None]
    inj = ~real & (j < (keep + ext)[:, None])
    src = torch.gather(o, 1, torch.clamp(j, max=cap0 - 1))
    k_inj = j - keep[:, None]
    host = st.host_id.to(torch.int64)[:, None].expand(h, capacity)
    timer = torch.full_like(k_inj, KIND_MODEL_BASE)
    time = torch.where(real, torch.gather(q.time, 1, src),
                       torch.where(inj, int(we) - 1 - k_inj, TIME_MAX))
    tie = torch.where(real, torch.gather(q.tie, 1, src),
                      torch.where(inj, pack_tie(timer, host, (1 << 31) + k_inj), (1 << 63) - 1))
    kind = torch.where(real, torch.gather(q.kind, 1, src),
                       torch.where(inj, KIND_MODEL_BASE, KIND_INVALID)).to(torch.int32)
    data = torch.where(real[:, :, None], torch.gather(
        q.data, 1, src[:, :, None].expand(h, capacity, q.data.shape[2])), 0)
    aux = torch.where(real, torch.gather(q.aux, 1, src), 0).to(torch.int32)
    # list position i -> column col[h, i]
    if order == "reversed":
        col = (capacity - 1 - torch.arange(capacity, device=dev))[None, :].expand(h, capacity)
    else:
        col = torch.from_numpy(np.argsort(g.random((h, capacity)), axis=1)).to(dev)
    return dataclasses.replace(st.clone(), queue=dataclasses.replace(
        q,
        time=torch.empty_like(time).scatter_(1, col, time),
        tie=torch.empty_like(tie).scatter_(1, col, tie),
        kind=torch.empty_like(kind).scatter_(1, col, kind),
        data=torch.empty_like(data).scatter_(1, col[:, :, None].expand_as(data), data),
        aux=torch.empty_like(aux).scatter_(1, col, aux),
        count=(keep + ext).to(torch.int32),
        head_time=time.amin(dim=1),
    ))


def deferring_queue(st, we: int, n: int, seed: int = 0, group: int = 1):
    """A copy of `st` in which a seeded half of the rows with no event
    below the window end `we` each gain `n` unshaped packet events from
    the next host, at times just below `we`, in free columns, each of
    twice the row's rx refill, and an empty rx bucket (tokens 0, last
    refill at the first of them): every one waits for the bucket and the
    pump defers it (P1), so such a row takes n events in one launch, past
    a narrow instance's MAX_K list, and lands n defers. With group > 1,
    each run of `group` consecutive events shares one time and the events
    2j - 1 and 2j share a tie, so that ties, and then columns, order
    them (at group 3, events 39 and 40, 63 and 64, 79 and 80 are equal in
    both). Needs a shaped world (rx_refill > 0) and n free columns in
    those rows."""
    from shadow_tpu_torch.events import KIND_PACKET, pack_tie
    from shadow_tpu_torch.simtime import TIME_MAX

    st = st.clone()
    q, net = st.queue, st.net
    h = q.time.shape[0]
    dev = q.time.device
    g = torch.Generator().manual_seed(seed)
    pick = (q.head_time >= int(we)) & (torch.rand(h, generator=g) < 0.5).to(dev)
    free = q.time == TIME_MAX
    pick &= free.sum(dim=1) >= n
    # each picked row's first n free columns take the new events
    rank = torch.cumsum(free.to(torch.int64), dim=1) - 1
    put = pick[:, None] & free & (rank < n)
    t0 = int(we) - 1 - n
    src = ((st.host_id.to(torch.int64) + 1) % h)[:, None].expand_as(rank)
    seq = rank if group == 1 else (rank + 1) // 2
    q.time[put] = (t0 + rank // group)[put]
    q.tie[put] = pack_tie(torch.full_like(rank, KIND_PACKET), src, (1 << 31) + seq)[put]
    q.kind[put] = KIND_PACKET
    q.data[put] = 0
    q.aux[put] = (2 * net.rx_refill).clamp(max=(1 << 24) - 1).to(torch.int32)[:, None].expand_as(
        rank)[put]
    q.count += torch.where(pick, n, 0).to(torch.int32)
    q.head_time[pick] = t0
    net.rx_tokens[pick] = 0
    net.rx_last[pick] = t0
    return st


def ptxas_resources(log: str, shape=None) -> dict:
    """Registers, stack frame and spill stores and loads per thread and
    static shared memory per block of each template instance of the pump
    kernel in one library (by instance name: the model's, "_wide" for
    its wide instance, "@<ranges>x<segments>" for a library of another
    TCP shape than the default), from nvcc's -Xptxas -v log."""
    from shadow_tpu_torch.engine.megakernel import INSTANCES, MODEL_IDS, TCP_SHAPE, instance_name

    names = {v: k for k, v in MODEL_IDS.items()}
    keys = ("regs", "stack_bytes", "spill_store_bytes", "spill_load_bytes", "smem_bytes")
    out = {m: dict.fromkeys(keys) for m in INSTANCES}
    inside = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            m = re.search(r"15pump_megakernelILi(\d+)ELb([01])E", ln)
            inside = None
            if m and int(m.group(1)) in names:
                inside = names[int(m.group(1))] + ("_wide" if m.group(2) == "1" else "")
            continue
        for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores"),
                         ("spill_load_bytes", r"(\d+) bytes spill loads"),
                         ("regs", r"Used (\d+) registers"),
                         ("smem_bytes", r"(\d+) bytes smem")):
            m = re.search(pat, ln)
            if inside and m:
                out[inside][key] = int(m.group(1))
    shape = TCP_SHAPE if shape is None else tuple(shape)
    return {instance_name(m.removesuffix("_wide"), m.endswith("_wide"), shape): v
            for m, v in out.items()}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def compare_stage(st, we, model, tables, scfg):
    """One twin stage (with its class tallies) and one kernel stage on
    clones of `st` (one world, or an ensemble's rows view with [R] window
    ends): (ok, facts for the phase line, (twin result, tallies))."""
    from shadow_tpu_torch import equeue
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.pump import pump_stage
    from shadow_tpu_torch.engine.state import per_row

    steps = []
    twin, rej_t = pump_stage(st.clone(), we, model, tables, scfg, debug_out=steps)
    kern, rej_k = mk.megakernel_stage(st.clone(), we, model, tables, scfg)
    sync(st.device)
    bad, err = leaves_equal(twin, kern)
    classes = {k: sum(d[k] for d in steps) for k in ("p1", "p2", "p3", "rejected")}
    live = int((equeue.next_time(st.queue) < per_row(st, we)).sum())
    facts = dict(mismatched_leaves=bad, max_abs_err=err,
                 rejected=[rej_t.tolist(), rej_k.tolist()],
                 classes=classes, live_rows=live, pump_k=scfg.pump_k)
    return not bad and torch.equal(rej_t, rej_k), facts, (twin, steps)


def world_args(st, we):
    """The window end and a zeroed rejected flag as the kernel takes them:
    a scalar and one flag for one world, [R] each for an ensemble's rows."""
    from shadow_tpu_torch.engine.state import replicas_of

    r = replicas_of(st)
    w = torch.as_tensor(we, dtype=torch.int64, device=st.device).reshape(
        () if r is None else (r,))
    return w, torch.zeros((r or 1,), dtype=torch.int32, device=st.device)


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


def _descendants() -> "list[int]":
    """The pids of every process this one started, directly or through
    another (read from /proc)."""
    parent = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                parent[int(name)] = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue  # gone meanwhile
    out, todo = [], [os.getpid()]
    while todo:
        kids = [pid for pid, pp in parent.items() if pp == todo[-1]]
        todo.pop()
        out += kids
        todo += kids
    return out


@contextlib.contextmanager
def quiet_card(device):
    """Hold (SIGSTOP) every process this script started while a launch
    is timed on the card, and let them go on (SIGCONT) after: from phase
    9 on, the mesh and services runs share the card in processes of
    their own, and the card's time slices between processes would stretch
    the CUDA-event times. What they queued drains before the timing
    starts. On the CPU, and with nothing started, it does nothing."""
    pids = _descendants() if device.type == "cuda" else []
    held = []
    for pid in pids:
        try:
            os.kill(pid, signal.SIGSTOP)
            held.append(pid)
        except ProcessLookupError:
            pass
    try:
        if held:
            time.sleep(QUIET_DRAIN_S)
        yield
    finally:
        for pid in held:
            try:
                os.kill(pid, signal.SIGCONT)
            except ProcessLookupError:
                pass


def timed_ms(fn, reps: int, setup, device) -> float:
    """Mean ms of fn(setup()) over `reps` calls: CUDA events on the card
    (setup() runs untimed before each call; every process this script
    started held meanwhile), the host clock on the CPU."""
    total = 0.0
    with quiet_card(device):
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
    around each launch bracket the kernel alone, not the host's wrapper;
    every process this script started is held meanwhile (quiet_card)."""
    from shadow_tpu_torch.engine import megakernel as mk

    dev = st.device
    codel = mk.PUMP_KERNEL.codel_table(dev)
    prepared = []
    for _ in range(reps):
        w, rej = world_args(st, we)
        prepared.append(mk.kernel_args(st.clone(), w, model, tables, cfg, rej, codel))
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    with quiet_card(dev):
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
    the per-row scalars of a row that takes an event (not a wide
    instance's FIFO, the kernel's own scratch, which no input fills); the
    routing and CoDel tables once. Writes: exactly the elements that differ between
    `st` and `after` (the twin's result on the same input)."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.utils.tree import tree_leaves_with_path

    h, cap = st.queue.time.shape
    w, rej = world_args(st, we)
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
    # the stream counters are read by onion's veto only
    unread = ("fifo",) if mk.kernel_model(model) == "onion" else (
        "fifo", "streams_started", "streams_done")
    scalar_bytes = sum(
        row_bytes(t) for n, t in named.items()
        if n in ("q_count", "ob_fill") or (
            t.dim() >= 1 and t.shape[0] == h and n not in tcp_names
            and n not in table_names and n not in unread
            and not n.startswith(("q_", "ob_")))
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
    os.environ.setdefault("TEARDOWN_CUPTI", "1")  # as flightrec: no CUPTI left on later phases
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


def onion_counts(st) -> dict:
    """The onion model's counters the onion cell compares."""
    m = st.model
    return {k: int(getattr(m, k).sum()) for k in (
        "circuits_built", "circuits_rejected", "cells_relayed", "requests_served",
        "streams_started", "streams_done", "bytes_down")}


def onion_plain_run(hosts: int, end_ns: int, dev, out_path: str) -> int:
    """The onion cell's plain-engine run, for a process of its own
    (`--onion-plain OUT`): the onion world run with the plain engine to
    ONION_BURST_NS and on to end_ns (run_until twice, as the main path
    runs, so that rounds are grouped into chunks alike), its host_stats
    and model counters at both written to OUT (npz)."""
    from shadow_tpu_torch.engine.round import host_stats, run_until

    cfg, model, tables, st0 = onion_world(hosts, dev)
    plain = dataclasses.replace(cfg, engine="plain")
    out, t0 = {}, time.perf_counter()
    st = st0
    for at, until in (("burst", ONION_BURST_NS), ("end", end_ns)):
        st = run_until(st, until, model, tables, plain, rounds_per_chunk=16)
        sync(dev)
        out.update({f"{at}.hs.{k}": v for k, v in host_stats(st).items()})
        out.update({f"{at}.count.{k}": np.int64(v) for k, v in onion_counts(st).items()})
    out["wall_s"] = np.float64(time.perf_counter() - t0)
    np.savez(out_path, **out)
    return 0


def onion_plain_start(hosts: int, end_ns: int, dev) -> dict:
    """Start onion_plain_run to end_ns in a process of its own (this
    script with `--onion-plain`): a handle for onion_plain_finish."""
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "onion_plain.npz")
    cmd = [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--onion-plain", out]
    if dev.type == "cpu":
        cmd += ["--rehearse-cpu", "--hosts", str(hosts)]
    err_path = os.path.join(tmp.name, "stderr.txt")
    with open(err_path, "w") as err:
        # one host thread for torch's CPU ops, as the CLI runs beside it
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=err, stderr=subprocess.STDOUT,
                                env=dict(os.environ, OMP_NUM_THREADS="1"))
    STARTED.append(proc)
    return dict(proc=proc, out=out, stderr=err_path, tmp=tmp, hosts=hosts, end_ns=end_ns)


def onion_plain_finish(run) -> "dict | None":
    """Wait for the run onion_plain_start started: {"burst"/"end": {hs,
    counts}, "wall_s"}, or None (with a failing line) if it failed."""
    rc = run["proc"].wait()
    got = None
    if rc == 0:
        with np.load(run["out"]) as z:
            got = {"wall_s": float(z["wall_s"])}
            for at in ("burst", "end"):
                got[at] = dict(
                    hs={k.split(".", 2)[2]: z[k] for k in z.files if k.startswith(f"{at}.hs.")},
                    counts={k.split(".", 2)[2]: int(z[k]) for k in z.files
                            if k.startswith(f"{at}.count.")})
    else:
        with open(run["stderr"]) as f:
            line("onion_plain_engine", ok=False, hosts=run["hosts"], end_ns=run["end_ns"],
                 rc=rc, stderr_tail=f.read()[-2000:])
    run["tmp"].cleanup()
    return got


def onion_phase(hosts: int, end_ns: int, plain_run: dict, dev) -> "tuple[bool, dict, float]":
    """The onion cell: the main path with engine "auto" (the kernel's
    onion instance) to end_ns, pausing at the burst (ONION_BURST_NS);
    the plain engine's run on the same world (onion_plain_run, which ran
    in a process of its own beside the wide onion runs: `plain_run`, as
    onion_plain_finish returns it), whose host and model counters must
    agree with the main path's at the burst and at end_ns; the kernel
    against the twin at the burst, on the main path's state there, and
    at the main path's end (mid-run: streams are still flowing), each
    timed alone with its bound. Returns (ok, the instance's numbers for
    the kernels line, largest error)."""
    from shadow_tpu_torch import equeue
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.round import (
        _next_window_end,
        effective_engine,
        host_stats,
        run_until,
    )

    cfg, model, tables, st0 = onion_world(hosts, dev)
    scfg = mk.resolve_stage_cfg(cfg)
    eng = effective_engine(cfg, dev)
    reps, err, entry = 20, 0.0, {}
    counts = onion_counts

    # the main path
    counters = {}
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated() if dev.type == "cuda" else None
    mk.PUMP_KERNEL.launches_by_model["onion"] = 0
    t0 = time.perf_counter()
    out = run_until(st0, ONION_BURST_NS, model, tables, cfg, rounds_per_chunk=16,
                    counters=counters)
    sync(dev)
    t_b = time.perf_counter()
    at_burst = dict(hs=host_stats(out), counts=counts(out))
    st_b = out.clone()  # the burst launch's state (the kernel updates in place)
    sync(dev)
    t_b = time.perf_counter() - t_b  # the burst's fetch and copy are not the main path's time
    del st0
    out = run_until(out, end_ns, model, tables, cfg, rounds_per_chunk=16, counters=counters)
    sync(dev)
    wall = time.perf_counter() - t0 - t_b
    launches = mk.PUMP_KERNEL.launches_by_model["onion"]
    main = dict(hs=host_stats(out), counts=counts(out), events=int(out.events_handled.sum()))
    ok = (dev.type == "cpu" or (eng == "megakernel" and launches > 0)) and (
        main["counts"]["streams_done"] > 0)
    line("onion_main_path", ok=ok, engine=eng, hosts=hosts, clients=model.num_clients,
         relays=model.num_relays, sockets=model.tcp_params.num_sockets, end_ns=end_ns,
         wall_s=round(wall, 3), sim_s_per_wall_s=end_ns / 1e9 / wall,
         iters=counters.get("iters"), kernel_launches=launches, events=main["events"],
         allocated_at_start=allocated_at_start,
         max_memory_allocated=torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
         queue_hwm=int(out.tracker.queue_hwm.max()), outbox_hwm=int(out.tracker.outbox_hwm.max()),
         **main["counts"])
    if not ok:
        return False, entry, err

    # the plain engine's run against the main path, at the burst and at
    # its end
    diff = {at: [k for k in want["hs"] if k not in ("iters_done", "lanes_live")
                 and not np.array_equal(plain_run[at]["hs"].get(k), want["hs"][k])]
            for at, want in (("burst", at_burst), ("end", main))}
    ok_p = (not any(diff.values()) and plain_run["burst"]["counts"] == at_burst["counts"]
            and plain_run["end"]["counts"] == main["counts"])
    line("onion_plain_engine", ok=ok_p, hosts=hosts, burst_ns=ONION_BURST_NS, end_ns=end_ns,
         wall_s=round(plain_run["wall_s"], 3), beside="the wide onion runs and the CLI runs",
         events=int(plain_run["end"]["hs"]["events_handled"].sum()), differing=diff,
         **plain_run["end"]["counts"])

    def stage(name, st, at_ns):
        """Kernel vs twin on `st`, each timed: (ok, the stage's numbers,
        error). The burst must take client events."""
        # the window the next round would take, were the run to go on
        we = _next_window_end(st, ONION_WINDOW_CAP_NS, cfg, equeue.next_time(st.queue).amin(),
                              tables)
        return timed_stage("onion_kernel_vs_twin", st, we, model, tables, scfg, reps, dev,
                           must_take=name == "burst", launch=name, at_ns=at_ns, hosts=hosts)

    # comparison launches do not count
    ok_m, _, err_m = stage("mid", out, end_ns)
    del out
    ok_b, entry, err_b = stage("burst", st_b, ONION_BURST_NS)
    entry["launches"] = launches
    return ok_b and ok_m and ok_p, entry, max(err_b, err_m)


def wide_kernel_phase(st_b, we, cfg, model, tables, hosts: int, dev,
                      meanwhile=None) -> "tuple[bool, dict, float]":
    """wide_kernel: the kernel's wide instances, which take any pump_k and
    any socket count. tgen_wide: the bench world's burst launch at pump_k
    WIDE_PUMP_K (past a narrow instance's MAX_K), held against the twin
    and timed alone with its bound; the same launch on rebuilt queues of
    8 slots whose rows start full and of 1,100 slots whose rows hold more
    slots below the window end than a pass lists, and, with the narrow
    instance at MAX_K too, on the 30 ms state whose idle rows defer
    WIDE_PUMP_K arrivals each (deferring_queue); and its main path, the
    burst state run on to WIDE_RUN_NS at pump_k WIDE_PUMP_K, whose host
    and model counters must equal the plain engine's. onion_wide: the
    onion cell at each circuits_per_relay of ONION_WIDE_NS (33 and 65
    sockets per host, past the narrow instance's 32): its main path to
    that entry's time through the kernel, then kernel vs twin at that
    state, timed alone with its bound. `meanwhile()`, called before the
    onion runs, starts work elsewhere and returns a callable that waits
    for it and says whether it passed; the onion timings start after it.
    Launch counts are set to 0 just before each main path and read just
    after. Returns (ok, {instance: its numbers for the kernels line},
    largest error)."""
    from shadow_tpu_torch import equeue
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.round import _next_window_end, host_stats, run_until

    reps, err, out = 20, 0.0, {}
    wcfg = dataclasses.replace(mk.resolve_stage_cfg(cfg), pump_k=WIDE_PUMP_K)
    ok, entry, e = timed_stage(
        "wide_kernel_vs_twin", st_b, we, model, tables, wcfg, reps, dev, must_take=True,
        instance=mk.kernel_instance(model, wcfg), launch="burst", hosts=hosts)
    err = max(err, e)
    if not (ok and mk.kernel_instance(model, wcfg) == "tgen_wide"):
        return False, out, err
    for case, st_e in (
            ("queue_8_full", rebuilt_queue(st_b, SMALL_QUEUE, int(we))),
            ("queue_1100_over_stage", rebuilt_queue(
                st_b, LARGE_QUEUE, int(we), extra=LARGE_QUEUE_EXTRA, seed=3))):
        ok_e, facts, _ = compare_stage(st_e, we, model, tables, wcfg)
        err = max(err, facts["max_abs_err"])
        line("wide_kernel_vs_twin_edge", ok=ok_e, instance="tgen_wide", case=case, **facts)
        del st_e
        if not ok_e:
            return False, out, err
    # rows that take WIDE_PUMP_K events in one launch (every pass of a wide
    # list, a full FIFO) and land as many defers: the 30 ms state, whose
    # idle rows gain deferring arrivals; the narrow instance at MAX_K too
    st_r = run_until(st_b, REJECTS_NS, model, tables, dataclasses.replace(cfg, engine="plain"))
    we_r = _next_window_end(st_r, 10**9, cfg, equeue.next_time(st_r.queue).amin(), tables)
    st_d = deferring_queue(st_r, int(we_r), WIDE_PUMP_K)
    picked = int((st_d.queue.count != st_r.queue.count).sum())
    for k in (mk.MAX_K, WIDE_PUMP_K):
        ok_e, facts, _ = compare_stage(st_d, we_r, model, tables,
                                       dataclasses.replace(wcfg, pump_k=k))
        err = max(err, facts["max_abs_err"])
        ok_e = ok_e and picked > 0 and facts["classes"]["p1"] >= picked * k
        line("wide_kernel_vs_twin_edge", ok=ok_e, instance=mk.kernel_instance(
            model, dataclasses.replace(wcfg, pump_k=k)), case="rows_defer_past_max_k",
             rows_deferring=picked, **facts)
        if not ok_e:
            return False, out, err
    del st_d
    # rows with more slots below the window end than a wide pass stages
    # (its stage compacts), equal times and ties across the list's end,
    # columns in random order: at pump_k WIDE_PUMP_K (one pass), and at
    # WIDE_PAST_K in reverse column order, past the list and FIFO entries
    # a wide launch's shared memory holds (passes, FIFO scratch, a landing
    # past the recorded free columns)
    cap = int(st_r.queue.time.shape[1])
    for case, arrivals, k, order in (
            ("pass_boundary_ties", BOUNDARY_ARRIVALS, WIDE_PUMP_K, "random"),
            ("pump_k_past_shared_memory", WIDE_PAST_ARRIVALS, WIDE_PAST_K, "reversed")):
        st_e = rebuilt_queue(deferring_queue(st_r, int(we_r), arrivals, group=3), cap, int(we_r),
                             order=order)
        picked = int((st_e.queue.count != st_r.queue.count).sum())
        ecfg = dataclasses.replace(wcfg, pump_k=k)
        # the slots a wide row stages per read (the kernel's wide_stage)
        stage = max(mk.STAGE, -(-(min(k, mk.WIDE_LIST_CAP) + 2) // 16) * 16)
        over = int(((st_e.queue.time < int(we_r)).sum(dim=1) > stage).sum())
        ok_e, facts, _ = compare_stage(st_e, we_r, model, tables, ecfg)
        err = max(err, facts["max_abs_err"])
        reached = k == WIDE_PUMP_K or k > max(mk.WIDE_LIST_CAP, mk.WIDE_FIFO_CAP)
        ok_e = (ok_e and reached and picked > 0 and over > 0
                and facts["classes"]["p1"] >= picked * k)
        line("wide_kernel_vs_twin_edge", ok=ok_e, instance=mk.kernel_instance(model, ecfg),
             case=case, rows_deferring=picked, arrivals=arrivals, wide_stage=stage,
             rows_over_wide_stage=over, dynamic_smem_bytes=launch_smem(st_e, we_r, model, tables, ecfg),
             **facts)
        del st_e
        if not ok_e:
            return False, out, err
    del st_r

    def counts(st):
        m = st.model
        return {k: int(getattr(m, k).sum()) for k in ("streams_done", "bytes_down")}

    runs = {}
    for eng in ("megakernel", "plain"):
        rcfg = dataclasses.replace(cfg, engine=eng, pump_k=WIDE_PUMP_K)
        sync(dev)
        mk.PUMP_KERNEL.launches_by_model["tgen_wide"] = 0
        t0 = time.perf_counter()
        st = run_until(st_b, WIDE_RUN_NS, model, tables, rcfg, rounds_per_chunk=16)
        sync(dev)
        runs[eng] = dict(hs=host_stats(st), counts=counts(st), wall_s=time.perf_counter() - t0,
                         launches=mk.PUMP_KERNEL.launches_by_model["tgen_wide"])
        del st
    diff = [k for k in runs["plain"]["hs"] if k not in ("iters_done", "lanes_live")
            and not np.array_equal(runs["plain"]["hs"][k], runs["megakernel"]["hs"][k])]
    launches = runs["megakernel"]["launches"]
    ok = (not diff and runs["plain"]["counts"] == runs["megakernel"]["counts"]
          and (launches > 0 or dev.type == "cpu"))
    line("wide_kernel_main_path", ok=ok, instance="tgen_wide", pump_k=WIDE_PUMP_K,
         from_ns=BURST_NS, end_ns=WIDE_RUN_NS, kernel_launches=launches, differing=diff,
         events=int(runs["megakernel"]["hs"]["events_handled"].sum()),
         wall_s={k: round(v["wall_s"], 3) for k, v in runs.items()},
         **runs["megakernel"]["counts"])
    if not ok:
        return False, out, err
    out["tgen_wide"] = dict(entry, launches=launches, pump_k=WIDE_PUMP_K)

    finish = meanwhile() if meanwhile is not None else (lambda: True)
    reached = {}
    for circuits, end_o in ONION_WIDE_NS.items():
        ocfg, omodel, otables, o0 = onion_world(hosts, dev, circuits_per_relay=circuits)
        oscfg = mk.resolve_stage_cfg(ocfg)
        sockets = omodel.tcp_params.num_sockets
        sync(dev)
        mk.PUMP_KERNEL.launches_by_model["onion_wide"] = 0
        t0 = time.perf_counter()
        st = run_until(o0, end_o, omodel, otables, ocfg, rounds_per_chunk=16)
        sync(dev)
        wall = time.perf_counter() - t0
        launches = mk.PUMP_KERNEL.launches_by_model["onion_wide"]
        started = int(st.model.streams_started.sum())
        ok = (mk.kernel_instance(omodel, oscfg) == "onion_wide" and started > 0
              and (launches > 0 or dev.type == "cpu"))
        line("wide_kernel_onion_main_path", ok=ok, instance="onion_wide",
             circuits_per_relay=circuits, sockets=sockets, hosts=hosts, end_ns=end_o,
             wall_s=round(wall, 3), kernel_launches=launches, streams_started=started,
             events=int(st.events_handled.sum()), meanwhile=meanwhile is not None)
        if not ok:
            return False, out, err
        del o0
        reached[circuits] = (st, omodel, otables, ocfg, oscfg, sockets, end_o, launches)
    if not finish():
        return False, out, err
    cells, total = {}, 0
    for circuits in list(reached):
        st, omodel, otables, ocfg, oscfg, sockets, end_o, launches = reached.pop(circuits)
        we_o = _next_window_end(st, ONION_WINDOW_CAP_NS, ocfg,
                                equeue.next_time(st.queue).amin(), otables)
        ok, cell, e = timed_stage(
            "wide_kernel_vs_twin", st, we_o, omodel, otables, oscfg, reps, dev, must_take=True,
            instance="onion_wide", launch="burst", circuits_per_relay=circuits,
            sockets=sockets, at_ns=end_o, hosts=hosts)
        err = max(err, e)
        if ok and circuits == min(ONION_WIDE_NS):
            # past both narrow limits in one launch: the sockets and pump_k
            ecfg = dataclasses.replace(oscfg, pump_k=WIDE_PUMP_K)
            ok, facts, _ = compare_stage(st, we_o, omodel, otables, ecfg)
            err = max(err, facts["max_abs_err"])
            ok = ok and facts["live_rows"] > 0
            line("wide_kernel_vs_twin_edge", ok=ok, instance=mk.kernel_instance(omodel, ecfg),
                 case="onion_sockets_and_pump_k", circuits_per_relay=circuits, sockets=sockets,
                 at_ns=end_o, dynamic_smem_bytes=launch_smem(st, we_o, omodel, otables, ecfg),
                 **facts)
        del st
        if not ok:
            return False, out, err
        cells[circuits] = dict(cell, sockets=sockets, at_ns=end_o, launches=launches)
        total += launches
    first = cells[16]
    out["onion_wide"] = dict({k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "dynamic_smem_bytes")},
                             launches=total, by_circuits_per_relay=cells)
    return True, out, err


def host_leaves_equal(want: dict, st) -> "list[str]":
    """The leaves of `st` that differ from a host snapshot (state_to_host)
    in dtype, shape or value."""
    from shadow_tpu_torch.engine.state import state_to_numpy

    got = state_to_numpy(st)
    return [k for k in want if k not in got or got[k].dtype != want[k].dtype
            or got[k].shape != want[k].shape or not np.array_equal(got[k], want[k])]


def bench_counters(st) -> dict:
    return dict(events=int(st.events_handled.sum()),
                streams_done=int(st.model.streams_done.sum()),
                bytes_down=int(st.model.bytes_down.sum()))


def recovery_phase(hosts: int, end_ns: int, main_final: dict, dev) -> "tuple[bool, int]":
    """recovery: the bench world at an outbox of RECOVERY_OUTBOX slots, its
    main path (engine "auto": the kernel) to end_ns with recovery on
    (run_until_recovering, the CLI's default policy). It must recover at
    least once, reach the native oracle's counters, and end leaf-equal to
    the main path's final state, which started at the grown capacities.
    Then an R = RECOVERY_ENS_REPLICAS ensemble of that world, whole-batch
    regrowth, to RECOVERY_ENS_END_NS, leaf-equal to the ensemble started
    at the grown capacity. Launch counts are set to 0 just before each
    run and read just after. Returns (ok, the kernel's launches)."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.ensemble import (
        grow_ensemble_state,
        init_ensemble_state,
        run_ensemble_until,
    )
    from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill
    from shadow_tpu_torch.runtime.recovery import run_until_recovering

    cfg, model, tables, st0 = bench_world(hosts, dev, outbox_capacity=RECOVERY_OUTBOX)
    sync(dev)
    mk.PUMP_KERNEL.launches_by_model["tgen"] = 0
    t0 = time.perf_counter()
    final, recs = run_until_recovering(st0, end_ns, model, tables, cfg, rounds_per_chunk=16)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = mk.PUMP_KERNEL.launches_by_model["tgen"]
    got = bench_counters(final)
    want = dict(events=BENCH_EVENTS, streams_done=BENCH_STREAMS_DONE, bytes_down=BENCH_BYTES_DOWN)
    full = hosts == BENCH_HOSTS and end_ns == BENCH_END_NS
    bad = host_leaves_equal(main_final, final)
    ok = (len(recs) >= 1 and (got == want or not full) and not bad
          and (launches > 0 or dev.type == "cpu"))
    line("recovery", ok=ok, hosts=hosts, outbox_capacity=RECOVERY_OUTBOX, end_ns=end_ns,
         recoveries=recs, counters=got, pinned=want if full else None,
         mismatched_leaves_vs_main_path=bad, kernel_launches=launches, wall_s=round(wall, 3))
    del final
    if not ok:
        return False, launches

    bw = bw_bits_per_sec_to_refill(100_000_000)
    r = RECOVERY_ENS_REPLICAS

    def run_ens(c):
        def go(s, on_state=None):
            return run_ensemble_until(s, RECOVERY_ENS_END_NS, model, tables, c,
                                      rounds_per_chunk=16, on_state=on_state)
        return go

    e0 = init_ensemble_state(cfg, model, r, 1, bw, bw, device=dev)
    sync(dev)
    mk.PUMP_KERNEL.launches_by_model["tgen"] = 0
    t0 = time.perf_counter()
    ens, erecs = run_until_recovering(e0, RECOVERY_ENS_END_NS, cfg=cfg, runner_factory=run_ens,
                                      grow_fn=grow_ensemble_state)
    sync(dev)
    wall = time.perf_counter() - t0
    elaunch = mk.PUMP_KERNEL.launches_by_model["tgen"]
    grown = dataclasses.replace(cfg, outbox_capacity=erecs[-1]["outbox_capacity"] if erecs else
                                cfg.outbox_capacity)
    g0 = init_ensemble_state(grown, model, r, 1, bw, bw, device=dev)
    straight = run_ens(grown)(g0)
    ebad, _ = leaves_equal(straight, ens)
    ok = len(erecs) >= 1 and not ebad and (elaunch > 0 or dev.type == "cpu")
    line("recovery_ensemble", ok=ok, hosts=hosts, replicas=r, end_ns=RECOVERY_ENS_END_NS,
         recoveries=erecs, mismatched_leaves_vs_grown_start=ebad, kernel_launches=elaunch,
         events=[int(x) for x in ens.events_handled.sum(dim=1).tolist()],
         rows=r * hosts, wall_s=round(wall, 3))
    return ok, launches + elaunch


def checkpoint_phase(hosts: int, end_ns: int, dev) -> "tuple[bool, int]":
    """checkpoint: the bench main path at CHECKPOINT_RPC rounds per chunk,
    uninterrupted, then again with a checkpoint every
    CHECKPOINT_INTERVAL_NS and interrupted at CHECKPOINT_INTERRUPT_NS
    (the interrupt guard's deterministic sim-time knob: a final
    checkpoint, then RunInterrupted), resumed from the newest checkpoint
    file to end_ns; the resumed run's final state must equal the
    uninterrupted run's. Returns (ok, the kernel's launches over the
    interrupted and the resumed run)."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.round import RunInterrupted, run_until
    from shadow_tpu_torch.engine.state import state_to_host
    from shadow_tpu_torch.runtime.checkpoint import (
        CheckpointManager,
        InterruptGuard,
        StateTap,
        load_checkpoint,
    )

    cfg, model, tables, st0 = bench_world(hosts, dev)
    straight = state_to_host(run_until(st0, end_ns, model, tables, cfg,
                                       rounds_per_chunk=CHECKPOINT_RPC))
    with tempfile.TemporaryDirectory() as tmp:
        ck = CheckpointManager(tmp, CHECKPOINT_INTERVAL_NS, "bench")
        tap = StateTap(checkpoints=ck,
                       guard=InterruptGuard(test_interrupt_at_ns=CHECKPOINT_INTERRUPT_NS))
        sync(dev)
        mk.PUMP_KERNEL.launches_by_model["tgen"] = 0
        t0 = time.perf_counter()
        interrupted = False
        try:
            run_until(st0, end_ns, model, tables, cfg, rounds_per_chunk=CHECKPOINT_RPC,
                      on_state=tap)
        except RunInterrupted:
            interrupted = True
        path = CheckpointManager.latest_path(tmp)
        if path is None:
            line("checkpoint", ok=False, interrupted=interrupted, note="no checkpoint written")
            return False, 0
        restored, meta = load_checkpoint(path, st0, "bench")
        final = run_until(restored, end_ns, model, tables, cfg, rounds_per_chunk=CHECKPOINT_RPC)
        sync(dev)
        wall = time.perf_counter() - t0
        launches = mk.PUMP_KERNEL.launches_by_model["tgen"]
        written = [os.path.basename(p) for p in ck.written]
        size = os.path.getsize(path)
    bad = host_leaves_equal(straight, final)
    ok = interrupted and meta["final"] and not bad and (launches > 0 or dev.type == "cpu")
    line("checkpoint", ok=ok, hosts=hosts, interrupted=interrupted, resumed_from=meta["now_ns"],
         written=written, file_bytes=size, counters=bench_counters(final),
         mismatched_leaves_vs_uninterrupted=bad, kernel_launches=launches,
         wall_s=round(wall, 3))
    return ok, launches


def observability_phase(world, end_ns: int, main_final: dict, main_wall: float,
                        dev) -> "tuple[bool, int]":
    """observability-10240: the bench main path to end_ns through the
    kernel with the host-side planes attached: a Tracker (per-host
    heartbeats every OBS_HEARTBEAT_NS written through shadow_log to a
    file, a Chrome trace of the dispatch spans), an installed
    FlightRecorder with a metrics JSONL stream and a prom file, and a
    torch.profiler capture over chunks OBS_XPROF_CHUNKS. The final state
    must equal the untracked main path's, leaf for leaf, and reach the
    oracle's counters; the tracker's fold (without phases) must equal a
    fold of the main path's host_stats; the trace must hold OBS_SPANS;
    the stream one sample per chunk, each with the card's bytes in use;
    the profiler's trace must name pump_megakernel; the heartbeat file
    one line per host for each heartbeat. Prints the wall beside the main
    path's, and the wall of the main path run again after the capture has
    stopped, with nothing attached. `world` is the main path's (cfg,
    model, tables, initial state). Returns (ok, the kernel's launches)."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.round import host_stats, run_until
    from shadow_tpu_torch.engine.state import state_from_host
    from shadow_tpu_torch.runtime import flightrec
    from shadow_tpu_torch.runtime.flightrec import FlightRecorder
    from shadow_tpu_torch.utils import shadow_log
    from shadow_tpu_torch.utils.tracker import Tracker

    cfg, model, tables, st0 = world
    hosts = cfg.num_hosts
    names = [f"host{i}" for i in range(hosts)]
    hb_ns = min(OBS_HEARTBEAT_NS, end_ns // 2)  # a rehearsal's short run beats too
    with tempfile.TemporaryDirectory() as tmp:
        files = {k: os.path.join(tmp, k) for k in ("trace.json", "metrics.jsonl",
                                                   "metrics.prom", "xprof", "heartbeats.log")}
        tracker = Tracker(host_names=names, heartbeat_ns=hb_ns, trace_path=files["trace.json"])
        rec = FlightRecorder(num_hosts=hosts, metrics_path=files["metrics.jsonl"],
                             prom_path=files["metrics.prom"], heartbeat_ns=hb_ns,
                             tracker=tracker, xprof_dir=files["xprof"],
                             xprof_chunks=OBS_XPROF_CHUNKS, device=dev)
        sync(dev)
        mk.PUMP_KERNEL.launches_by_model["tgen"] = 0
        with open(files["heartbeats.log"], "w") as sink:
            shadow_log.set_sink(sink)
            t0 = time.perf_counter()
            try:
                with flightrec.installed(rec):
                    final = run_until(st0, end_ns, model, tables, cfg, rounds_per_chunk=16,
                                      tracker=tracker)
                sync(dev)
                wall = time.perf_counter() - t0
            finally:
                rec.close()
                shadow_log.flush()
                shadow_log.set_sink(None)
        launches = mk.PUMP_KERNEL.launches_by_model["tgen"]
        tracker.write_trace()
        bad = host_leaves_equal(main_final, final)
        got = bench_counters(final)
        want = dict(events=BENCH_EVENTS, streams_done=BENCH_STREAMS_DONE,
                    bytes_down=BENCH_BYTES_DOWN)
        full = hosts == BENCH_HOSTS and end_ns == BENCH_END_NS
        tracker.finalize(host_stats(final))
        fold = tracker.stats_dict()
        phases = fold.pop("phases")
        ref = Tracker(host_names=names)
        ref.finalize(host_stats(state_from_host(main_final, final)))
        ref_fold = ref.stats_dict()
        ref_fold.pop("phases")
        del final
        with open(files["trace.json"]) as f:
            spans = {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
        with open(files["metrics.jsonl"]) as f:
            samples = [s for s in map(json.loads, f) if s["type"] == "sample"]
        in_use = [s.get("device_bytes_in_use", 0) for s in samples]
        xprof = sorted(os.listdir(files["xprof"])) if os.path.isdir(files["xprof"]) else []
        xprof_bytes = names_kernel = 0
        for name in xprof:
            path = os.path.join(files["xprof"], name)
            xprof_bytes += os.path.getsize(path)
            with open(path) as f:
                names_kernel = names_kernel or "pump_megakernel" in f.read()
        with open(files["heartbeats.log"]) as f:
            hb = [ln for ln in f if " tracker: " in ln]
        beats = len(hb) // hosts if hosts else 0
        one_per_host = bool(hb) and len(hb) == beats * hosts and all(
            len({ln.split("] [", 2)[2].split("]", 1)[0] for ln in hb[b * hosts:(b + 1) * hosts]})
            == hosts for b in range(beats))
        prom = os.path.getsize(files["metrics.prom"])
    # the main path once more, nothing attached: what the capture leaves on
    # the process's later launches once it has stopped
    sync(dev)
    t0 = time.perf_counter()
    after = run_until(st0, end_ns, model, tables, cfg, rounds_per_chunk=16)
    sync(dev)
    wall_after = time.perf_counter() - t0
    got_after = bench_counters(after)
    del after
    on_card = dev.type == "cuda"
    checks = {
        "leaf_equal_to_main_path": not bad,
        "oracle_counters": got == want or not full,
        "fold_equals_main_path_fold": fold == ref_fold,
        # (a run of one chunk, as a small rehearsal may be, has no chunk_launch)
        "trace_spans": set(OBS_SPANS) - ({"chunk_launch"} if len(samples) == 1 else set())
        <= spans,
        "one_sample_per_chunk": len(samples) == phases["probe_fetch"]["count"] > 0,
        "device_bytes_in_use": all(b > 0 for b in in_use) or not on_card,
        "profiler_names_kernel": bool(names_kernel) or not on_card,
        "heartbeats_one_line_per_host": one_per_host,
        "kernel_launched": launches > 0 or not on_card,
        "main_path_after_at_oracle": got_after == got,
    }
    ok = all(checks.values())
    line("observability", ok=ok, cell=f"observability-{hosts}", checks=checks,
         mismatched_leaves_vs_main_path=bad, counters=got, wall_s=round(wall, 3),
         main_path_wall_s=round(main_wall, 3), overhead_s=round(wall - main_wall, 3),
         main_path_after_wall_s=round(wall_after, 3), kernel_launches=launches,
         chunks=len(samples), heartbeats=beats,
         heartbeat_lines=len(hb), spans=sorted(spans),
         phase_totals_s={k: v["total_s"] for k, v in phases.items()},
         phase_counts={k: v["count"] for k, v in phases.items()},
         device_bytes_in_use_max=max(in_use) if in_use else None,
         xprof_files=xprof, xprof_bytes=xprof_bytes, prom_bytes=prom,
         fold={k: fold[k] for k in ("events_by_kind", "drops", "high_water", "rounds")})
    return ok, launches


def grown_leaves_differ(want: dict, got: dict) -> "list[str]":
    """The leaves of a host snapshot `got`, whose queue a recovery regrew,
    that differ from `want`'s: the queue rows compared in pop order up to
    want's width (the grown slots past it must all be dead), every other
    leaf as it is."""
    a, b = pop_order(want), pop_order(got)
    width = want[".queue.time"].shape[1]
    bad = []
    for k, v in a.items():
        w = b.get(k)
        if w is not None and k.startswith(".queue.") and w.ndim >= 2 and k != ".queue.count":
            if k == ".queue.time" and not (w[:, width:] >= (1 << 62) - 1).all():
                bad.append(k + "[grown slots]")
            w = w[:, :width]
        if w is None or w.dtype != v.dtype or w.shape != v.shape or not np.array_equal(v, w):
            bad.append(k)
    return bad


def guards_phase(world, end_ns: int, main_final: dict, main_launches: int,
                 main_wall: float, dev) -> "tuple[bool, int]":
    """guards-10240: the bench main path to end_ns through TpuScheduler.run
    (recovery on, the CLI's default policy) under the run-loop guards,
    each run against the main path's final state:
      (a) chaos: an injected capacity error at chunk GUARD_CAPACITY_AT
          (the queue regrows, the run replays) and a stall of
          stall_s in chunk GUARD_STALL_AT's probe read under a watchdog
          of watchdog_s (both from `main_wall`; the chunk is abandoned and
          re-dispatched), at GUARD_CHAOS_RPC rounds a chunk: two recovery
          records, capacity then watchdog, one watchdog re-dispatch, and
          every leaf equal (the queue in pop order, up to the main path's
          width) but the idle-round count, which follows the chunking;
      (b) compile: an injected compile fault on the megakernel: one
          engine fallback, megakernel -> pump, and the run ends on the
          pump twin, no kernel launched, leaf-equal;
      (c) autotune: plan_rounds_per_chunk from an autotune.json holding
          GUARD_PROBE_WALL_S (source "cache"), GUARD_REQUESTED_RPC walked
          down to GUARD_RPC; run there, the kernel's launches equal the
          main path's and every leaf too;
      (d) a device-side stall: chunk GUARD_STALL_AT's launch first puts
          stall_s of spinning (torch.cuda._sleep; a host sleep off
          the card) on the stream, no chaos plan, at GUARD_CHAOS_RPC rounds
          a chunk under the watchdog of (a): the launch's first wait on
          the device blocks, the watchdog expires in the caller's thread,
          one watchdog recovery at that chunk, leaf-equal as in (a). The
          replay starts from the run's start (no snapshot is verified
          before chunk 2's probe) while the rest of the spin and the
          abandoned chunk still hold the stream and the host.
    Launch counts are set to 0 just before each run and read just after
    (in (d) they include the abandoned chunk's, which runs on).
    Returns (ok, the kernel's launches over the four runs)."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine import round as rnd
    from shadow_tpu_torch.engine.round import host_stats
    from shadow_tpu_torch.engine.state import state_from_host, state_to_numpy
    from shadow_tpu_torch.runtime import autotune, chaos
    from shadow_tpu_torch.runtime.recovery import RecoveryPolicy
    from shadow_tpu_torch.runtime.scheduler import TpuScheduler

    cfg, model, tables, st0 = world
    hosts = cfg.num_hosts
    full = hosts == BENCH_HOSTS and end_ns == BENCH_END_NS
    want = dict(events=BENCH_EVENTS, streams_done=BENCH_STREAMS_DONE, bytes_down=BENCH_BYTES_DOWN)
    main_hs = host_stats(state_from_host(main_final, st0))
    on_card = dev.type == "cuda"
    watchdog_s = max(GUARD_WATCHDOG_FLOOR_S, GUARD_WATCHDOG_OVER_MAIN * main_wall)
    stall_s = watchdog_s + GUARD_STALL_PAST_S

    def guarded(faults, rounds_per_chunk=GUARD_RPC, watchdog_s=0.0, before_count=None):
        sched = TpuScheduler(model, tables, cfg, rounds_per_chunk=rounds_per_chunk,
                             watchdog_s=watchdog_s, device=dev)
        plan = chaos.FaultPlan(faults=faults)
        sync(dev)
        mk.PUMP_KERNEL.launches_by_model["tgen"] = 0
        t0 = time.perf_counter()
        with chaos.installed(plan):
            final = sched.run(end_ns, start_state=st0, recovery=RecoveryPolicy())
        sync(dev)
        wall = time.perf_counter() - t0
        if before_count is not None:
            before_count()
        hs = host_stats(final)
        if rounds_per_chunk != GUARD_RPC:
            hs["rounds_idle"] = main_hs["rounds_idle"]  # follows the chunking
        report = sched.recovery_report
        out = dict(
            wall_s=round(wall, 3), kernel_launches=mk.PUMP_KERNEL.launches_by_model["tgen"],
            recoveries=report, engine_fallbacks=sched.engine_fallbacks,
            watchdog_redispatches=sum(r["kind"] == "watchdog" for r in report),
            chaos=plan.report(), counters=bench_counters(final),
            host_stats_equal=all(np.array_equal(main_hs[k], hs[k]) for k in main_hs),
            queue_capacity=int(final.queue.time.shape[1]))
        return out, state_to_numpy(final)

    # (a) capacity, then a stall under the watchdog
    a, host = guarded([{"kind": "capacity", "at": GUARD_CAPACITY_AT},
                       {"kind": "stall", "at": GUARD_STALL_AT, "stall_s": stall_s}],
                      rounds_per_chunk=GUARD_CHAOS_RPC, watchdog_s=watchdog_s)
    a["rounds_idle"] = [int(main_final[".tracker.rounds_idle"]),
                        int(host[".tracker.rounds_idle"])]
    a["mismatched_leaves"] = [k for k in grown_leaves_differ(main_final, host)
                              if k != ".tracker.rounds_idle"]
    del host
    a_ok = ([r["kind"] for r in a["recoveries"]] == ["capacity", "watchdog"]
            and a["recoveries"][0].get("injected") is True
            and a["recoveries"][1]["chunk"] == GUARD_STALL_AT
            and a["watchdog_redispatches"] == 1 and not a["engine_fallbacks"]
            and a["chaos"]["fired"] == [{"kind": "capacity", "at": GUARD_CAPACITY_AT},
                                        {"kind": "stall", "at": GUARD_STALL_AT}]
            and a["host_stats_equal"] and not a["mismatched_leaves"]
            and (a["counters"] == want or not full)
            and (a["kernel_launches"] > 0 or not on_card))

    # (b) an injected compile fault on the megakernel: the pump twin runs
    b, host = guarded([{"kind": "compile", "target": "megakernel"}])
    b["mismatched_leaves"] = snapshots_differ(main_final, host)
    del host
    fell = [(f["from"], f["to"]) for f in b["engine_fallbacks"]]
    b_ok = ((fell == [("megakernel", "pump")] or not on_card)
            and b["kernel_launches"] == 0 and not b["recoveries"]
            and b["chaos"]["fired"] == ([{"kind": "compile", "at": None, "target": "megakernel"}]
                                        if on_card else [])
            and not b["mismatched_leaves"] and (b["counters"] == want or not full))

    # (c) the autotuner from a cached probe wall
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "autotune.json")
        key = autotune._cache_key(cfg, autotune.PROBE_RPC, autotune.backend_name(dev))
        with open(cache, "w") as f:
            json.dump({key: {"probe_wall_s": GUARD_PROBE_WALL_S}}, f)

        def no_probe():
            raise AssertionError("autotune built a probe state despite its cache")

        plan = autotune.plan_rounds_per_chunk(no_probe, model, tables, cfg,
                                              requested=GUARD_REQUESTED_RPC,
                                              budget_s=GUARD_BUDGET_S, cache_path=cache,
                                              device=dev)
    c, host = guarded([], rounds_per_chunk=plan.rounds_per_chunk)
    c["plan"] = plan.as_dict()
    c["mismatched_leaves"] = snapshots_differ(main_final, host)
    del host
    c_ok = (plan.source == "cache" and plan.rounds_per_chunk == GUARD_RPC
            and (c["kernel_launches"] == main_launches or not on_card)
            and not c["mismatched_leaves"] and (c["counters"] == want or not full))

    # (d) a stall on the device at chunk GUARD_STALL_AT's launch
    if on_card:
        t = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t[0].record()
        torch.cuda._sleep(10**8)
        t[1].record()
        t[1].synchronize()
        cycles = int(stall_s * 10**8 / (t[0].elapsed_time(t[1]) / 1e3))
    real_run_chunk, chunk_calls = rnd._run_chunk, []

    def stalled_run_chunk(st, *args, **kwargs):
        if len(chunk_calls) == GUARD_STALL_AT:
            if on_card:
                torch.cuda._sleep(cycles)
            else:
                time.sleep(stall_s)
        chunk_calls.append(None)
        return real_run_chunk(st, *args, **kwargs)

    def abandoned_chunks_done():
        # the abandoned chunk's helper thread runs on after the replay
        # has begun; its launches are (d)'s, not a later phase's
        for t in threading.enumerate():
            if t.name.startswith("chunk-watchdog"):
                t.join()
        sync(dev)

    rnd._run_chunk = stalled_run_chunk
    try:
        d, host = guarded([], rounds_per_chunk=GUARD_CHAOS_RPC, watchdog_s=watchdog_s,
                          before_count=abandoned_chunks_done)
    finally:
        rnd._run_chunk = real_run_chunk
    d["device_stall_cycles"] = cycles if on_card else None
    d["mismatched_leaves"] = [k for k in grown_leaves_differ(main_final, host)
                              if k != ".tracker.rounds_idle"]
    del host
    d_ok = ([(r["kind"], r["chunk"]) for r in d["recoveries"]]
            == [("watchdog", GUARD_STALL_AT)]
            and d["watchdog_redispatches"] == 1 and not d["engine_fallbacks"]
            and d["chaos"]["fired"] == [] and d["wall_s"] >= watchdog_s
            and d["host_stats_equal"] and not d["mismatched_leaves"]
            and (d["counters"] == want or not full)
            and (d["kernel_launches"] > 0 or not on_card))

    ok = a_ok and b_ok and c_ok and d_ok
    line("guards", ok=ok, cell=f"guards-{hosts}", end_ns=end_ns,
         watchdog_s=round(watchdog_s, 3), stall_s=round(stall_s, 3),
         ok_by_run={"chaos": a_ok, "compile": b_ok, "autotune": c_ok, "device_stall": d_ok},
         chaos=a, compile=b, autotune=c, device_stall=d, main_path_launches=main_launches)
    return ok, sum(r["kernel_launches"] for r in (a, b, c, d))


def oracle_tcp_world(model_name: str, loss: float, shaped: bool, lanes: int, device):
    """tests/test_cpu_ref_{tgen,bulk}.py's _world, written against the
    port: 8 hosts on a seeded 4-node graph (1 ms self-loops, 2-5 ms links
    at `loss`), 20 Mbit shaping when `shaped`. (cfg, model, tables,
    host_node, per-host refill)."""
    from shadow_tpu_torch.engine.state import EngineConfig
    from shadow_tpu_torch.graph import NetworkGraph, compute_routing
    from shadow_tpu_torch.models.bulk import BulkTcpModel
    from shadow_tpu_torch.models.tgen import TgenModel
    from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill
    from shadow_tpu_torch.simtime import NS_PER_MS

    hosts, n_nodes = 8, 4
    rng_py = random.Random(13 if model_name == "tgen" else 11)
    lines = ["graph [", "  directed 0"]
    for i in range(n_nodes):
        lines.append(f"  node [ id {i} ]")
        lines.append(f'  edge [ source {i} target {i} latency "1 ms" ]')
    for i in range(n_nodes):
        for j in range(i + 1, n_nodes):
            lines.append(f'  edge [ source {i} target {j} latency '
                         f'"{rng_py.randrange(2, 6)} ms" packet_loss {loss} ]')
    lines.append("]")
    graph = NetworkGraph.from_gml("\n".join(lines))
    host_node = [i % n_nodes for i in range(hosts)]
    tables = compute_routing(graph, block=4, device=device).with_hosts(host_node)
    cfg = EngineConfig(num_hosts=hosts, queue_capacity=128 if model_name == "tgen" else 96,
                       outbox_capacity=16, runahead_ns=graph.min_latency_ns(),
                       seed=13 if model_name == "tgen" else 11, use_netstack=shaped,
                       active_lanes=lanes)
    if model_name == "tgen":
        model = TgenModel(num_hosts=hosts, num_clients=hosts // 2,
                          num_servers=hosts - hosts // 2, resp_bytes=25_000,
                          pause_ns=40 * NS_PER_MS)
    else:
        model = BulkTcpModel(num_hosts=hosts, num_pairs=hosts // 2, total_bytes=30_000)
    bw = bw_bits_per_sec_to_refill(20_000_000) if shaped else None
    return cfg, model, tables, host_node, bw


def oracle_phold_world(loss: float, device):
    """tests/test_engine_phold.py's _setup, written against the port: 6
    phold hosts on a seeded 3-node mesh (500 us self-loops, 1-8 ms links
    at `loss`)."""
    from shadow_tpu_torch.engine.state import EngineConfig
    from shadow_tpu_torch.graph import NetworkGraph, compute_routing
    from shadow_tpu_torch.models.phold import PholdModel
    from shadow_tpu_torch.simtime import NS_PER_MS

    hosts, n_nodes, seed = 6, 3, 11
    rng_py = random.Random(seed)
    lines = ["graph [", "  directed 0"]
    for i in range(n_nodes):
        lines.append(f'  node [ id {i} host_bandwidth_up "1 Gbit" host_bandwidth_down "1 Gbit" ]')
        lines.append(f'  edge [ source {i} target {i} latency "500 us" packet_loss {loss} ]')
    for i in range(n_nodes):
        for j in range(i + 1, n_nodes):
            if rng_py.random() < 0.7 or j == i + 1:
                lines.append(f'  edge [ source {i} target {j} latency '
                             f'"{rng_py.randrange(1, 9)} ms" packet_loss {loss} ]')
    lines.append("]")
    graph = NetworkGraph.from_gml("\n".join(lines))
    host_node = [i % n_nodes for i in range(hosts)]
    tables = compute_routing(graph, block=8, device=device).with_hosts(host_node)
    cfg = EngineConfig(num_hosts=hosts, queue_capacity=64, outbox_capacity=8,
                       runahead_ns=graph.min_latency_ns(), seed=seed)
    model = PholdModel(num_hosts=hosts, min_delay_ns=1 * NS_PER_MS, max_delay_ns=8 * NS_PER_MS)
    return cfg, model, tables, host_node, None


def queue_entries(q, host: int) -> list:
    """A host's live queue entries in pop order, as the oracles list them."""
    from shadow_tpu_torch.simtime import TIME_MAX

    time_, tie, kind, data = (x[host].tolist() for x in (q.time, q.tie, q.kind, q.data))
    return sorted((time_[i], tie[i], kind[i], tuple(data[i]))
                  for i in range(len(time_)) if time_[i] != TIME_MAX)


def oracle_differs(st, ref, counters, shaped: bool) -> "list[str]":
    """What of an engine run's final state differs from the oracle's: every
    TCP field (for the TCP models), the model's counters, the engine's
    counters and every leftover queue entry."""
    bad = []
    if hasattr(st.model, "tcp"):
        for f in TCP_FIELDS:
            got = getattr(st.model.tcp, f).cpu().numpy()
            if not np.array_equal(got, ref.tcp_field(f).astype(got.dtype)):
                bad.append(f"tcp.{f}")
    pairs = [(f"model.{n}", getattr(st.model, n), getattr(ref, r)) for n, r in counters]
    pairs += [(n, getattr(st, n), getattr(ref, n)) for n in ("packets_sent", "packets_dropped")]
    pairs += [("seq", st.seq, ref.seq), ("rng_counter", st.rng_counter, ref.ctr)]
    if hasattr(ref, "events_handled"):
        pairs.append(("events_handled", st.events_handled, ref.events_handled))
    if shaped:
        pairs += [(f"net.{n}", getattr(st.net, n), getattr(ref, n))
                  for n in ("codel_dropped", "bytes_sent", "bytes_recv")]
    bad += [name for name, got, want in pairs if got.tolist() != list(want)]
    bad += [f"queue[{h}]" for h in range(st.num_hosts)
            if queue_entries(st.queue, h) != ref.queue_contents(h)]
    return bad


def cpu_ref_run(dev, out_path: str) -> int:
    """The cpu-ref oracles (CpuRefTgen, CpuRefBulk, CpuRefPhold), run on
    the host, against the port's engine on `dev` (engine "auto": the
    kernel for tgen, the plain engine for the models without a kernel
    instance) on the reference tests' small worlds (ORACLE_*), for a
    process of its own (`--cpu-ref OUT`): one record per world, with what
    differs, written to OUT as JSON."""
    from shadow_tpu_torch.cpu_ref import CpuRefBulk, CpuRefPhold, CpuRefTgen
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.round import bootstrap, run_until
    from shadow_tpu_torch.engine.state import init_state
    from shadow_tpu_torch.simtime import NS_PER_MS

    worlds = [(f"tgen-{loss}-{'shaped' if shaped else 'unshaped'}-lanes{lanes}", CpuRefTgen,
               oracle_tcp_world("tgen", loss, shaped, lanes, dev), end_ms * NS_PER_MS, shaped,
               (("streams_started", "streams_started"), ("streams_done", "streams_done"),
                ("bytes_down", "bytes_down"), ("resets", "resets")))
              for loss, shaped, end_ms, lanes in ORACLE_TGEN]
    worlds += [(f"bulk-{loss}-{'shaped' if shaped else 'unshaped'}", CpuRefBulk,
                oracle_tcp_world("bulk", loss, shaped, 0, dev), end_ms * NS_PER_MS, shaped,
                (("conns_established", "conns_established"), ("conns_closed", "conns_closed"),
                 ("resets", "resets")))
               for loss, shaped, end_ms in ORACLE_BULK]
    worlds += [(f"phold-{loss}", CpuRefPhold, oracle_phold_world(loss, dev),
                ORACLE_PHOLD_END_NS, False, (("recv_count", "recv"), ("send_count", "send")))
               for loss in ORACLE_PHOLD_LOSS]
    records = []
    for name, cls, (cfg, model, tables, host_node, bw), end, shaped, counters in worlds:
        t0 = time.perf_counter()
        ref = cls(cfg, model, tables, host_node, tx_bytes_per_interval=bw,
                  rx_bytes_per_interval=bw)
        ref.bootstrap()
        ref.run_until(end)
        oracle_s = time.perf_counter() - t0
        st = bootstrap(init_state(cfg, model.init(dev), bw, bw, device=dev), model, cfg)
        mk.PUMP_KERNEL.launches = 0
        t0 = time.perf_counter()
        st = run_until(st, end, model, tables, cfg, rounds_per_chunk=16)
        sync(dev)
        records.append(dict(
            world=name, mismatched=oracle_differs(st, ref, counters, shaped),
            events=len(ref.trace), kernel_launches=mk.PUMP_KERNEL.launches,
            oracle_s=round(oracle_s, 3), engine_s=round(time.perf_counter() - t0, 3)))
    with open(out_path, "w") as f:
        json.dump(records, f)
    return 0


def cpu_ref_start(dev) -> dict:
    """Start cpu_ref_run in a process of its own (this script with
    `--cpu-ref`): a handle for cpu_ref_finish_oracles."""
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "cpu_ref.json")
    cmd = [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--cpu-ref", out]
    if dev.type == "cpu":
        cmd += ["--rehearse-cpu"]
    err_path = os.path.join(tmp.name, "stderr.txt")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=err, stderr=subprocess.STDOUT,
                                env=dict(os.environ, OMP_NUM_THREADS="1"))
    STARTED.append(proc)
    return dict(proc=proc, out=out, stderr=err_path, tmp=tmp, on_card=dev.type == "cuda")


def cpu_ref_finish_oracles(run) -> bool:
    """Wait for the run cpu_ref_start started: every world equal, every
    oracle run non-trivial, the kernel launched on the tgen worlds (on
    the card)."""
    rc = run["proc"].wait()
    records = []
    if rc == 0:
        with open(run["out"]) as f:
            records = json.load(f)
    with open(run["stderr"]) as f:
        tail = f.read()[-2000:]
    run["tmp"].cleanup()
    ok = rc == 0 and len(records) == len(ORACLE_TGEN) + len(ORACLE_BULK) + len(ORACLE_PHOLD_LOSS)
    ok = ok and all(not r["mismatched"] and r["events"] > 20 for r in records)
    ok = ok and all(r["kernel_launches"] > 0 or not run["on_card"]
                    for r in records if r["world"].startswith("tgen"))
    line("cpu_ref_oracles", ok=ok, rc=rc, worlds=records, stderr_tail=tail if not ok else "")
    return ok


def fattree_cli_start(dev) -> dict:
    """Start the CLI on examples/fattree, its graph from gen_fattree.py 8
    in a temporary directory (cli_start)."""
    gml_dir = tempfile.TemporaryDirectory()
    gml = os.path.join(gml_dir.name, "fattree.gml")
    with open(gml, "w") as f:
        subprocess.run([sys.executable, os.path.join(HERE, "examples", "fattree",
                                                     "gen_fattree.py"), "8"],
                       stdout=f, check=True)
    run = cli_start("fattree/shadow.yaml", dev, subs=[
        ("file: examples/fattree/fattree.gml", f"file: {gml}")])
    run["tmps"].append(gml_dir)
    return run


def fattree_cli_finish(run) -> bool:
    """The fattree run started by fattree_cli_start: recovery on by default
    must regrow the outbox twice (FATTREE_RECOVERIES) and the run must end
    with the reference's events (FATTREE_STATS)."""
    ok, stats = cli_finish(run, FATTREE_STATS)
    rec = stats.get("recovery") or {"events": []}
    got = [(e["queue_capacity"], e["outbox_capacity"]) for e in rec["events"]]
    ok = ok and got == FATTREE_RECOVERIES
    line("cli_recovery", ok=ok, example="fattree/shadow.yaml", recoveries=got,
         want=FATTREE_RECOVERIES, events=rec["events"])
    return ok


def observability_cli_start(dev) -> dict:
    """Start the CLI on examples/tgen at OBS_CLI_ROUNDS_PER_CHUNK rounds a
    chunk (so that the run has the chunks --xprof-dir's default window
    captures, and heartbeats fall inside it) with every host-side
    observability flag (--tracker, --trace-file, --metrics-file,
    --metrics-prom, --xprof-dir; their files in a temporary directory),
    and `mem --json` on the same example, each in a process of its own."""
    out_dir = tempfile.TemporaryDirectory()
    files = {k: os.path.join(out_dir.name, name) for k, name in (
        ("trace", "trace.json"), ("metrics", "metrics.jsonl"), ("prom", "metrics.prom"),
        ("xprof", "xprof"))}
    run = cli_start("tgen/shadow.yaml", dev, extra=(
        "--tracker", "--trace-file", files["trace"], "--metrics-file", files["metrics"],
        "--metrics-prom", files["prom"], "--xprof-dir", files["xprof"]),
        subs=(("rounds_per_chunk: 128", f"rounds_per_chunk: {OBS_CLI_ROUNDS_PER_CHUNK}"),))
    run["tmps"].append(out_dir)
    run["files"] = files
    run["on_card"] = dev.type == "cuda"
    mem_out = os.path.join(out_dir.name, "mem.json")
    with open(mem_out, "w") as f:
        run["mem"] = subprocess.Popen(
            [sys.executable, "-m", "shadow_tpu_torch", "mem",
             os.path.join(HERE, "examples", "tgen", "shadow.yaml"), "--json"],
            cwd=HERE, stdout=f, stderr=subprocess.STDOUT)
    STARTED.append(run["mem"])
    run["mem_out"] = mem_out
    return run


def observability_cli_finish(run) -> bool:
    """The run started by observability_cli_start: the pinned stats, and
    sim-stats carrying `tracker` (events by kind summing to the events),
    `metrics` (a sample a chunk) and `memory` (groups, dominant grid, the
    card's allocator block); the trace holds OBS_SPANS; the profiler's
    trace names pump_megakernel (on the card); the per-host heartbeats
    name each host once a heartbeat; `metrics FILE` renders the stream;
    `mem --json` prices the example's state at TGEN_EXAMPLE_STATE_BYTES.
    Reads the files before cli_finish removes them."""
    files = run["files"]
    rc = run["proc"].wait()
    spans, xprof_names_kernel = [], False
    with open(run["stderr"]) as f:
        hb = [ln for ln in f if " tracker: " in ln]
    hosts = TGEN_EXAMPLE_STATS["num_hosts"]
    beats = len(hb) // hosts
    one_per_host = bool(hb) and len(hb) == beats * hosts and all(
        len({ln.split("] [", 2)[2].split("]", 1)[0] for ln in hb[b * hosts:(b + 1) * hosts]})
        == hosts for b in range(beats))
    if rc == 0:
        with open(files["trace"]) as f:
            spans = sorted({e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"})
        for path in sorted(os.listdir(files["xprof"])) if os.path.isdir(files["xprof"]) else []:
            with open(os.path.join(files["xprof"], path)) as f:
                xprof_names_kernel = xprof_names_kernel or "pump_megakernel" in f.read()
    shown = subprocess.run([sys.executable, "-m", "shadow_tpu_torch", "metrics", files["metrics"]],
                           cwd=HERE, capture_output=True, text=True)
    run["mem"].wait()
    with open(run["mem_out"]) as f:
        mem_text = f.read()
    try:
        mem_total = json.loads(mem_text)["total_bytes"]
    except ValueError:
        mem_total = None
    ok, stats = cli_finish(run, TGEN_EXAMPLE_STATS)
    tr, met, memo = (stats.get(k) or {} for k in ("tracker", "metrics", "memory"))
    by_kind = tr.get("events_by_kind") or {}
    ok = (ok and sum(by_kind.values()) == stats.get("events_handled") and "phases" in tr
          and met.get("samples", 0) > max(OBS_XPROF_CHUNKS) and "file" in met and "prom" in met
          and set(OBS_SPANS) <= set(spans) and (xprof_names_kernel or not run["on_card"])
          and one_per_host
          and {"groups", "dominant"} <= set(memo) and ("device" in memo or not run["on_card"])
          and shown.returncode == 0 and "samples" in shown.stdout
          and run["mem"].returncode == 0 and mem_total == TGEN_EXAMPLE_STATE_BYTES)
    line("observability_cli", ok=ok, example="tgen/shadow.yaml",
         rounds_per_chunk=OBS_CLI_ROUNDS_PER_CHUNK, tracker_events_by_kind=by_kind,
         spans=spans, heartbeats=beats, heartbeat_lines=len(hb), metrics=met,
         memory_device=memo.get("device"),
         memory_total_bytes=memo.get("total_bytes"), xprof_names_kernel=xprof_names_kernel,
         metrics_cmd_rc=shown.returncode, metrics_cmd_head=shown.stdout.splitlines()[:1],
         mem_cmd_total_bytes=mem_total,
         mem_cmd_tail=mem_text[-500:] if mem_total is None else "")
    return ok


def ensemble_cli_finish(run, keep: "dict | None" = None) -> bool:
    """`run --replicas 2` on the phold example (stop time cut): the
    ensemble's sim-stats, whose replica 0 runs the config's own seed and
    so is the single run PHOLD_EXAMPLE_STATS pins (kept in `keep` for the
    mesh's CLI runs)."""
    ok, stats = cli_finish(
        run, {k: PHOLD_EXAMPLE_STATS[k] for k in ("sim_seconds", "num_hosts")})
    if keep is not None:
        keep["stats"] = stats
    per = (stats.get("ensemble") or {}).get("per_replica") or [{}, {}]
    first = {k: per[0].get(k) for k in ("events_handled", "packets_sent")}
    ok = (ok and stats.get("scheduler") == "tpu-ensemble" and len(per) == 2
          and first == {k: PHOLD_EXAMPLE_STATS[k] for k in first}
          and per[0]["events_handled"] != per[1].get("events_handled")
          and stats.get("events_handled") == sum(p["events_handled"] for p in per))
    line("ensemble_cli", ok=ok, per_replica=per)
    return ok


def trajectory_stats(stats: dict, drop=()) -> dict:
    """sim-stats without the wall clock, the execution shape (`memory`,
    `execution`) and the keys in `drop`."""
    return {k: v for k, v in stats.items()
            if k not in ("wall_seconds", "memory", "execution", *drop)}


def guards_cli_runs(dev) -> list:
    """The guards' CLI runs of examples/tgen, each in a process of its own
    (started by background_clis after its plain tgen run, whose sim-stats
    and hosts file `ref` receives): `--autotune` with a real probe;
    checkpoints under a ckpt-corrupt fault, interrupted and resumed;
    `scheduler: cpu-ref`. (handle, finish) pairs."""
    from shadow_tpu_torch.runtime.autotune import candidate_ladder
    from shadow_tpu_torch.runtime.checkpoint import CheckpointManager, verify_checkpoint

    on_card = dev.type == "cuda"

    def autotune_finish(run, ref):
        ok, stats = cli_finish(run, TGEN_EXAMPLE_STATS)
        plan = stats.get("autotune") or {}
        ok = (ok and trajectory_stats(stats, ("autotune",)) == trajectory_stats(ref["stats"])
              and plan.get("source") == "probe"
              and plan.get("backend") == ("gpu" if on_card else "cpu")
              and plan.get("rounds_per_chunk") in candidate_ladder(plan.get("requested", 0))
              and (plan.get("peak_hbm_bytes", 0) > 0 or not on_card))
        line("guards_cli_autotune", ok=ok, example="tgen/shadow.yaml", autotune=plan)
        return ok

    ckpt_dir = tempfile.TemporaryDirectory()

    def ckpt_finish(run, ref):
        run["proc"].wait()
        rc_interrupted = -1
        if os.path.exists(run["rc_path"]):
            with open(run["rc_path"]) as f:
                rc_interrupted = int(f.read().strip() or -1)
        ok, stats = cli_finish(run, TGEN_EXAMPLE_STATS)
        files = sorted(p for p in os.listdir(ckpt_dir.name) if p.startswith("ckpt-"))
        valid = [verify_checkpoint(os.path.join(ckpt_dir.name, p)) is None for p in files]
        newest_valid = CheckpointManager.latest_path(ckpt_dir.name)
        resumed = newest_valid is not None and (
            f"resuming from checkpoint {newest_valid}" in run["stderr_text"])
        ok = (ok and rc_interrupted == 130 and len(files) >= 2 and not valid[-1]
              and all(valid[:-1]) and resumed
              and trajectory_stats(stats) == trajectory_stats(ref["stats"]))
        line("guards_cli_checkpoint", ok=ok, example="tgen/shadow.yaml",
             fault=GUARD_CKPT_FAULT, interrupted_rc=rc_interrupted, files=files, valid=valid,
             resumed_from=os.path.basename(newest_valid or ""), resumed=resumed)
        ckpt_dir.cleanup()
        return ok

    def cpu_ref_finish(run, ref):
        pinned = {**TGEN_EXAMPLE_STATS, "scheduler": "cpu-ref"}
        ok, stats = cli_finish(run, pinned)
        same_hosts = run.get("hosts") is not None and run.get("hosts") == ref.get("hosts")
        ok = (ok and same_hosts and trajectory_stats(stats, ("scheduler",))
              == trajectory_stats(ref["stats"], ("scheduler",)))
        line("guards_cli_cpu_ref", ok=ok, example="tgen/shadow.yaml", same_hosts=same_hosts,
             stats={k: stats.get(k) for k in ("events_handled", "packets_sent", "scheduler")})
        return ok

    return [
        (cli_start("tgen/shadow.yaml", dev, extra=("--autotune", str(GUARD_CLI_AUTOTUNE_S))),
         autotune_finish),
        # at OBS_CLI_ROUNDS_PER_CHUNK rounds a chunk: the config's 128 make
        # one chunk of the whole run, with no boundary to checkpoint at
        # (the resumed run writes no checkpoint of its own before it ends,
        # so the directory keeps the interrupted run's files for the check)
        (cli_start("tgen/shadow.yaml", dev, extra=(
            "--checkpoint-dir", ckpt_dir.name, "--checkpoint-interval", GUARD_CKPT_INTERVAL,
            "--chaos-fault", GUARD_CKPT_FAULT), interrupt_ns=GUARD_INTERRUPT_NS,
            resume_extra=("--checkpoint-dir", ckpt_dir.name, "--checkpoint-interval",
                          GUARD_RESUME_INTERVAL),
            subs=(("rounds_per_chunk: 128", f"rounds_per_chunk: {OBS_CLI_ROUNDS_PER_CHUNK}"),)),
         ckpt_finish),
        (cli_start("tgen/shadow.yaml", dev, subs=(("scheduler: tpu", "scheduler: cpu-ref"),)),
         cpu_ref_finish),
        (cpu_ref_start(dev), lambda run, ref: cpu_ref_finish_oracles(run)),
    ]


def background_clis(dev, phold_replicas: dict):
    """Start every CLI run of the smoke, each in a process of its own: on
    the onion example (stop time cut), on examples/fattree, on
    examples/tgen (plain, and with the observability flags, `mem`
    beside it, and the guards' runs: guards_cli_runs), on the phold
    example (stop time cut) and `run --replicas 2` on it (its sim-stats
    kept in `phold_replicas` for the mesh's CLI runs); and the cpu-ref
    oracles against the engine on the card (cpu_ref_start). A callable
    that waits for all and says whether all passed."""
    tgen_ref = {}

    def tgen_finish(run):
        ok, tgen_ref["stats"] = cli_finish(run, TGEN_EXAMPLE_STATS)
        tgen_ref["hosts"] = run.get("hosts")
        return ok

    runs = [(cli_start("onion/onion.yaml", dev, ONION_EXAMPLE_STOP),
             lambda r: cli_finish(r, ONION_EXAMPLE_STATS)[0]),
            (fattree_cli_start(dev), fattree_cli_finish),
            (cli_start("tgen/shadow.yaml", dev), tgen_finish),
            (cli_start("phold/shadow.yaml", dev, PHOLD_EXAMPLE_STOP),
             lambda r: cli_finish(r, PHOLD_EXAMPLE_STATS)[0]),
            (cli_start("phold/shadow.yaml", dev, PHOLD_EXAMPLE_STOP, extra=("--replicas", "2")),
             lambda r: ensemble_cli_finish(r, phold_replicas)),
            (observability_cli_start(dev), observability_cli_finish)]
    runs += [(r, lambda r, f=f: f(r, tgen_ref)) for r, f in guards_cli_runs(dev)]
    return lambda: all([finish(r) for r, finish in runs])


def small_model_worlds():
    """(name, model, graph GML, loss) of the small worlds on which the
    models without a pump kernel run on the card and on the CPU: the
    reference's overlay test worlds and a lossy bulk-tcp pair world."""
    from shadow_tpu_torch.models.bulk import BulkTcpModel
    from shadow_tpu_torch.models.overlay import CdnModel, GossipModel
    from shadow_tpu_torch.models.phold import PholdModel

    return [
        ("phold", PholdModel(num_hosts=16), 0.0),
        ("bulk-tcp", BulkTcpModel(num_hosts=4, num_pairs=2, total_bytes=200_000), 0.02),
        ("cdn", CdnModel(num_hosts=12, num_mids=1, num_leaves=2, objects=32), 0.0),
        ("gossip", GossipModel(num_hosts=12, view_size=4, fanout=2, churn_ppm=100_000), 0.0),
    ]


def tri_node_gml(loss: float) -> str:
    """tests/test_overlay.py's three-node graph (1 ms self-loops, 3, 2 and
    5 ms between nodes, optionally lossy)."""
    lossy = f" packet_loss {loss}" if loss else ""
    return "\n".join([
        "graph [", "  directed 0", "  node [ id 0 ]", "  node [ id 1 ]", "  node [ id 2 ]",
        '  edge [ source 0 target 0 latency "1 ms" ]',
        '  edge [ source 1 target 1 latency "1 ms" ]',
        '  edge [ source 2 target 2 latency "1 ms" ]',
        f'  edge [ source 0 target 1 latency "3 ms"{lossy} ]',
        f'  edge [ source 1 target 2 latency "2 ms"{lossy} ]',
        f'  edge [ source 0 target 2 latency "5 ms"{lossy} ]',
        "]",
    ])


def small_world(model, loss: float, device, seed: int = 9):
    """(cfg, tables, bootstrapped state) of `model` on the three-node
    graph, hosts spread round-robin, tracker on (tests/test_overlay.py's
    _world)."""
    from shadow_tpu_torch.engine.round import bootstrap
    from shadow_tpu_torch.engine.state import EngineConfig, init_state
    from shadow_tpu_torch.graph import NetworkGraph, compute_routing

    graph = NetworkGraph.from_gml(tri_node_gml(loss))
    h = model.num_hosts
    tables = compute_routing(graph, device=device).with_hosts([i % 3 for i in range(h)])
    cfg = EngineConfig(num_hosts=h, queue_capacity=192, outbox_capacity=64,
                       runahead_ns=graph.min_latency_ns(), seed=seed, tracker=True)
    st = init_state(cfg, model.init(device), device=device)
    return cfg, tables, bootstrap(st, model, cfg)


def models_phase(dev, big_hosts: int) -> bool:
    """phold, bulk-tcp, cdn and gossip (no pump kernel: the plain engine)
    on the card and on the CPU in this process, leaf-equal; then phold at
    `big_hosts` hosts on the bench graph."""
    from shadow_tpu_torch.engine.round import bootstrap, run_until
    from shadow_tpu_torch.engine.state import EngineConfig, init_state, state_to_numpy
    from shadow_tpu_torch.graph import compute_routing
    from shadow_tpu_torch.models.phold import PholdModel

    cpu = torch.device("cpu")
    for name, model, loss in small_model_worlds():
        leaves, walls = {}, {}
        for d in (dev, cpu):
            cfg, tables, st = small_world(model, loss, d)
            t0 = time.perf_counter()
            out = run_until(st, SMALL_WORLD_END_NS, model, tables, cfg, rounds_per_chunk=8)
            sync(d)
            walls[d.type] = round(time.perf_counter() - t0, 3)
            leaves[d.type] = state_to_numpy(out)
        a, b = leaves[dev.type], leaves["cpu"]
        bad = [k for k in a if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
        events = int(a[".events_handled"].sum())
        ok = not bad and sorted(a) == sorted(b) and events > 0
        line("model_card_vs_cpu", ok=ok, model=name, hosts=model.num_hosts,
             end_ns=SMALL_WORLD_END_NS, events=events, mismatched_leaves=bad, wall_s=walls,
             packets_dropped=int(a[".packets_dropped"].sum()))
        if not ok:
            return False

    graph = bench_graph()
    model = PholdModel(num_hosts=big_hosts)
    tables = compute_routing(graph, block=64, device=dev).with_hosts(
        [i % 32 for i in range(big_hosts)])
    cfg = EngineConfig(num_hosts=big_hosts, queue_capacity=64, outbox_capacity=16,
                       runahead_ns=graph.min_latency_ns(), seed=7)
    st = bootstrap(init_state(cfg, model.init(dev), device=dev), model, cfg)
    counters = {}
    sync(dev)
    t0 = time.perf_counter()
    out = run_until(st, PHOLD_END_NS, model, tables, cfg, rounds_per_chunk=16, counters=counters)
    sync(dev)
    wall = time.perf_counter() - t0
    events = int(out.events_handled.sum())
    ok = events > 0 and int(out.model.recv_count.sum()) > 0
    line("phold_main_path", ok=ok, hosts=big_hosts, end_ns=PHOLD_END_NS, events=events,
         balls_received=int(out.model.recv_count.sum()), iters=counters.get("iters"),
         wall_s=round(wall, 3), sim_s_per_wall_s=PHOLD_END_NS / 1e9 / wall,
         events_per_wall_s=events / wall)
    return ok


# the CLI processes started by cli_start, stopped when the smoke ends
STARTED = []


def cli_start(example: str, dev, stop=None, extra=(), subs=(), interrupt_ns=None,
              resume_extra=(), env=None) -> dict:
    """Start `python -m shadow_tpu_torch run` on an example config in a
    process of its own (its data directory moved to a temporary one;
    `stop`, a pair of stop_time lines, shortens it; `subs`, more (old, new)
    pairs, edit it; `extra` adds flags; its output goes to files, so that
    it never waits on this process): a handle for cli_finish. With
    `interrupt_ns` the run is interrupted there (the interrupt guard's
    sim-time knob; its exit status goes to the handle's "rc_path") and
    then resumed with `--resume` and the flags `resume_extra` instead of
    `extra`, in one shell. `env` adds to its environment."""
    tmp = tempfile.TemporaryDirectory()
    src = open(os.path.join(HERE, "examples", example)).read()
    for old, new in ((stop,) if stop is not None else ()) + tuple(subs):
        if old not in src:
            raise ValueError(f"{example}: no {old!r} to edit")
        src = src.replace(old, new)
    data = os.path.join(tmp.name, "data")
    cfg_path = os.path.join(tmp.name, "config.yaml")
    with open(cfg_path, "w") as f:
        f.write(src.replace("data_directory: shadow.data", f"data_directory: {data}"))
    device = ["--device", "cpu"] if dev.type == "cpu" else []
    cmd = [sys.executable, "-m", "shadow_tpu_torch", "run", *extra, cfg_path, *device]
    rc_path = os.path.join(tmp.name, "interrupted_rc.txt")
    if interrupt_ns is not None:
        resume = [sys.executable, "-m", "shadow_tpu_torch", "run", *resume_extra, cfg_path,
                  *device, "--resume"]
        first, then = (" ".join(map(shlex.quote, c)) for c in (cmd, resume))
        cmd = ["/bin/sh", "-c", f"{INTERRUPT_ENV}={int(interrupt_ns)} {first}; "
               f"echo $? > {shlex.quote(rc_path)}; exec {then}"]
    err_path = os.path.join(tmp.name, "stderr.txt")
    with open(os.path.join(tmp.name, "stdout.txt"), "w") as out, open(err_path, "w") as err:
        t0 = time.perf_counter()
        # one host thread for torch's CPU ops: these processes run beside
        # the smoke's own host-bound runs
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=out, stderr=err,
                                env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})))
    STARTED.append(proc)
    return dict(example=example, extra=list(extra), proc=proc, t0=t0, data=data,
                stderr=err_path, tmps=[tmp], rc_path=rc_path)


def cli_finish(run: dict, pinned: dict) -> "tuple[bool, dict]":
    """Wait for a run that cli_start started: (ok, the run's sim-stats)."""
    rc = run["proc"].wait()
    cli_s = time.perf_counter() - run["t0"]
    stats = {}
    if rc == 0:
        with open(os.path.join(run["data"], "sim-stats.json")) as f:
            stats = json.load(f)
    got = {k: stats.get(k) for k in pinned}
    ok = rc == 0 and got == pinned
    with open(run["stderr"]) as f:
        stderr = f.read()
    hosts_path = os.path.join(run["data"], "hosts")
    if os.path.exists(hosts_path):
        with open(hosts_path) as f:
            run["hosts"] = f.read()
    run["stderr_text"] = stderr
    line("cli", ok=ok, example=run["example"], flags=run["extra"], rc=rc, stats=got,
         execution=stats.get("execution"), wall_s=round(cli_s, 3),
         stderr_tail=stderr[-2000:] if not ok else "")
    for tmp in run["tmps"]:
        tmp.cleanup()
    return ok, stats


def ensemble_window(rows, cfg, tables):
    """[R] window ends the next round of an ensemble's rows would take,
    were the run to go on."""
    from shadow_tpu_torch import equeue
    from shadow_tpu_torch.engine.round import _next_window_end
    from shadow_tpu_torch.engine.state import per_replica

    start = per_replica(rows, equeue.next_time(rows.queue)).amin(dim=1)
    return _next_window_end(rows, ONION_WINDOW_CAP_NS, cfg, start, tables)


def launch_smem(st, we, model, tables, scfg):
    """Bytes of dynamic shared memory the kernel launch for `st` takes (a
    wide instance's; 0 for a narrow one), or None on the CPU."""
    from shadow_tpu_torch.engine import megakernel as mk

    if st.device.type != "cuda":
        return None
    w, rej = world_args(st, we)
    args, _ = mk.kernel_args(st, w, model, tables, scfg, rej, mk.PUMP_KERNEL.codel_table(st.device))
    return mk.PUMP_KERNEL.dynamic_smem(args)


def timed_stage(name, st, we, model, tables, scfg, reps, dev, must_take=False, **fields):
    """Kernel vs twin on one launch (one world, or an ensemble's rows with
    [R] window ends), the kernel timed alone, with its bound, printed as
    line `name` with `fields`. Any launch must have live rows;
    `must_take`: it must take P2 or P3 events. Returns (ok, the launch's
    numbers, largest error)."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.pump import pump_stage
    from shadow_tpu_torch.engine.state import per_row

    ok, facts, (twin, steps) = compare_stage(st, we, model, tables, scfg)
    took = facts["classes"]["p2"] + facts["classes"]["p3"] > 0
    ok = ok and facts["live_rows"] > 0 and (took or not must_take)
    if dev.type == "cuda":
        ms_k = kernel_device_ms(st, we, model, tables, scfg, reps)
    else:
        ms_k = timed_ms(lambda s_: mk.megakernel_stage(s_, we, model, tables, scfg),
                        reps, st.clone, dev)
    ms_t = timed_ms(lambda s_: pump_stage(s_, we, model, tables, scfg), 5, st.clone, dev)
    tallies = {"steps": steps, "live_rows": facts["live_rows"]}
    bound_ms, bound_by, reck = pump_bound(st, we, model, tables, scfg, tallies, twin)
    # rows whose slots below the window end overflow the kernel's stage
    # take their list from device memory
    below = st.queue.time < per_row(st, we)[..., None]
    over = int((below.sum(dim=1) > mk.STAGE).sum())
    smem = launch_smem(st, we, model, tables, scfg)
    line(name, ok=ok, **fields, rows_over_stage=over, **facts,
         kernel_ms=ms_k, twin_ms=ms_t, bound_ms=bound_ms, bound_by=bound_by,
         share_of_bound=bound_ms / ms_k, dynamic_smem_bytes=smem, reckoning=reck)
    return ok, dict(ms=ms_k, plain_ms=ms_t, bound_ms=bound_ms, bound_by=bound_by,
                    dynamic_smem_bytes=smem), facts["max_abs_err"]


def ensemble_stage(cell, rows, we, model, tables, scfg, reps, dev, must_take=False):
    """timed_stage on one launch over an ensemble's rows."""
    h = int(rows.queue.time.shape[0])
    return timed_stage("ensemble_kernel_vs_twin", rows, we, model, tables, scfg, reps, dev,
                       must_take=must_take, cell=cell, rows=h,
                       rows_per_replica=h // int(we.shape[0]), window_end=we.tolist())


def ensemble_main_path(st0, model, tables, cfg, instance, ends, dev):
    """The ensemble plane's main path (engine "auto": the kernel on the
    card), run_ensemble_until to each of `ends` in turn, with the launch
    counts set to 0 just before and read just after: (states at each end,
    wall s, drain iterations, launches, peak device bytes)."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.ensemble import run_ensemble_until

    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counters = {}
    mk.PUMP_KERNEL.launches_by_model[instance] = 0
    t0 = time.perf_counter()
    outs, st = [], st0
    for end in ends:
        st = run_ensemble_until(st, end, model, tables, cfg, rounds_per_chunk=16,
                                counters=counters)
        outs.append(st)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = mk.PUMP_KERNEL.launches_by_model[instance]
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    return outs, wall, counters.get("iters", 0), launches, peak


def single_main_path(st0, model, tables, cfg, ends, dev):
    """One world's main path to each of `ends` in turn: (final state,
    wall s, drain iterations, peak device bytes)."""
    from shadow_tpu_torch.engine.round import run_until

    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counters = {}
    t0 = time.perf_counter()
    st = st0
    for end in ends:
        st = run_until(st, end, model, tables, cfg, rounds_per_chunk=16, counters=counters)
    sync(dev)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    return st, time.perf_counter() - t0, counters.get("iters", 0), peak


def ensemble_tgen_phase(hosts: int, end_ns: int, dev) -> "tuple[bool, dict, float]":
    """ensemble-tgen: the lossy tgen world (loss draws make its replicas
    diverge; the bench world's pairs share a node and never lose a
    packet) x ENS_TGEN_REPLICAS, seed stride 1, through the kernel. The
    main path pauses at the burst (LOSSY_MID_NS_SHAPED), as the single
    runs do, so that their rounds group into chunks alike; replicas 0 and
    R - 1 must equal single kernel runs with their seeds (the first is
    the R = 1 run the batch is compared with), the replicas must differ,
    and the kernel must have launched once per drain iteration of the
    batch. Then kernel vs twin at the batch's burst launch, timed.
    Returns (ok, the instance's ensemble numbers, largest error)."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.ensemble import init_ensemble_state, replica_slice
    from shadow_tpu_torch.engine.round import bootstrap, effective_engine
    from shadow_tpu_torch.engine.state import init_state, rows_view
    from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill

    r = ENS_TGEN_REPLICAS
    phase = f"ensemble-tgen-{hosts}x{r}"
    cfg, model, tables, _ = lossy_world(hosts, dev, n_nodes=ENS_TGEN_NODES)
    bw = bw_bits_per_sec_to_refill(20_000_000)
    scfg = mk.resolve_stage_cfg(cfg)
    ends = (LOSSY_MID_NS_SHAPED, end_ns)
    singles = {}
    for i in (0, r - 1):
        rcfg = dataclasses.replace(cfg, seed=cfg.seed + i)
        s0 = bootstrap(init_state(rcfg, model.init(dev), bw, bw, device=dev), model, rcfg)
        mk.PUMP_KERNEL.launches_by_model["tgen"] = 0
        out, wall, iters, peak = single_main_path(s0, model, tables, rcfg, ends, dev)
        singles[i] = dict(state=out, wall_s=round(wall, 3), iters=iters, peak=peak,
                          launches=mk.PUMP_KERNEL.launches_by_model["tgen"])
    ens0 = init_ensemble_state(cfg, model, r, 1, bw, bw, device=dev)
    (st_b, out), wall, iters, launches, peak = ensemble_main_path(
        ens0, model, tables, cfg, "tgen", ends, dev)
    eng = effective_engine(cfg, dev)
    bad = {i: leaves_equal(replica_slice(out, i), s["state"])[0] for i, s in singles.items()}
    events = out.events_handled.sum(dim=1).tolist()
    one = singles[0]
    drops = out.packets_dropped.sum(dim=1).tolist()
    ok = ((dev.type == "cpu" or (eng == "megakernel" and launches == iters > 0))
          and not any(bad.values()) and len(set(events)) > 1 and min(drops) > 0)
    line("ensemble_main_path", ok=ok, cell=phase, engine=eng, hosts=hosts, replicas=r,
         rows=hosts * r, end_ns=end_ns, wall_s=round(wall, 3),
         sim_s_per_wall_s=end_ns / 1e9 / wall,
         sim_sec_per_wall_sec_per_replica=end_ns / 1e9 / (wall / r),
         iters=iters, kernel_launches=launches, max_memory_allocated=peak,
         events_per_replica=events,
         packets_dropped_per_replica=drops,
         streams_done_per_replica=out.model.streams_done.sum(dim=1).tolist(),
         mismatched_leaves_vs_single=bad,
         r1={k: v for k, v in one.items() if k != "state"},
         r1_sim_s_per_wall_s=end_ns / 1e9 / one["wall_s"],
         single_last={k: v for k, v in singles[r - 1].items() if k != "state"})
    del out, singles, one
    if not ok:
        return False, {}, 0.0
    rows = rows_view(st_b)
    ok_s, entry, err = ensemble_stage(phase, rows, ensemble_window(rows, cfg, tables), model,
                                      tables, scfg, 20, dev, must_take=True)
    entry.update(phase=phase, launches=launches, iters=iters, replicas=r, rows=hosts * r)
    return ok and ok_s, entry, err


def ensemble_onion_phase(hosts: int, end_ns: int, dev) -> "tuple[bool, dict, float]":
    """ensemble-onion: the onion cell x ENS_ONION_REPLICAS through the
    kernel's onion instance to end_ns; replica 0 must equal a single
    onion kernel run to the same horizon, the replicas' circuit counts
    must differ, and the kernel launches once per drain iteration; then
    kernel vs twin at the batch's next launch, timed."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.ensemble import init_ensemble_state, replica_slice
    from shadow_tpu_torch.engine.round import effective_engine
    from shadow_tpu_torch.engine.state import rows_view
    from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill

    r = ENS_ONION_REPLICAS
    phase = f"ensemble-onion-{hosts}x{r}"
    cfg, model, tables, st0 = onion_world(hosts, dev)
    bw = bw_bits_per_sec_to_refill(100_000_000)
    single, wall1, iters1, peak1 = single_main_path(st0, model, tables, cfg, (end_ns,), dev)
    del st0
    ens0 = init_ensemble_state(cfg, model, r, 1, bw, bw, device=dev)
    (out,), wall, iters, launches, peak = ensemble_main_path(
        ens0, model, tables, cfg, "onion", (end_ns,), dev)
    del ens0
    eng = effective_engine(cfg, dev)
    bad = leaves_equal(replica_slice(out, 0), single)[0]
    circuits = out.model.circuits_built.sum(dim=1).tolist()
    ok = ((dev.type == "cpu" or (eng == "megakernel" and launches == iters > 0))
          and not bad and len(set(circuits)) > 1)
    line("ensemble_main_path", ok=ok, cell=phase, engine=eng, hosts=hosts, replicas=r,
         rows=hosts * r, end_ns=end_ns, wall_s=round(wall, 3),
         sim_s_per_wall_s=end_ns / 1e9 / wall,
         sim_sec_per_wall_sec_per_replica=end_ns / 1e9 / (wall / r),
         iters=iters, kernel_launches=launches, max_memory_allocated=peak,
         events_per_replica=out.events_handled.sum(dim=1).tolist(),
         circuits_built_per_replica=circuits,
         cells_relayed_per_replica=out.model.cells_relayed.sum(dim=1).tolist(),
         mismatched_leaves_vs_single=bad,
         r1=dict(wall_s=round(wall1, 3), iters=iters1, peak=peak1,
                 sim_s_per_wall_s=end_ns / 1e9 / wall1))
    del single
    if not ok:
        return False, {}, 0.0
    rows = rows_view(out)
    ok_s, entry, err = ensemble_stage(phase, rows, ensemble_window(rows, cfg, tables), model,
                                      tables, mk.resolve_stage_cfg(cfg), 20, dev)
    entry.update(phase=phase, launches=launches, iters=iters, replicas=r, rows=hosts * r)
    return ok and ok_s, entry, err


def ensemble_ragged_phase(hosts: int, dev) -> "tuple[bool, float]":
    """ensemble-ragged: the lossy tgen world at `hosts` (not a multiple of
    the rows a warp owns, so one warp holds rows of two replicas) x
    ENS_RAGGED_REPLICAS, advanced through the kernel to the burst; kernel
    vs twin on the batch's next launch."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.ensemble import init_ensemble_state, run_ensemble_until
    from shadow_tpu_torch.engine.state import rows_view
    from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill

    r = ENS_RAGGED_REPLICAS
    cfg, model, tables, _ = lossy_world(hosts, dev, n_nodes=ENS_TGEN_NODES)
    bw = bw_bits_per_sec_to_refill(20_000_000)
    ens0 = init_ensemble_state(cfg, model, r, 1, bw, bw, device=dev)
    rows = rows_view(run_ensemble_until(ens0, LOSSY_MID_NS_SHAPED, model, tables, cfg,
                                        rounds_per_chunk=16))
    straddled = hosts % mk.ROWS_PER_WARP != 0
    # replica i's window ends i ms early, so the warp that owns rows of
    # both replicas holds two window ends
    we = ensemble_window(rows, cfg, tables)
    we = we - 1_000_000 * torch.arange(r, device=we.device)
    ok, entry, err = ensemble_stage(f"ensemble-ragged-{hosts}x{r}", rows, we, model, tables,
                                    mk.resolve_stage_cfg(cfg), 5, dev, must_take=True)
    return ok and straddled, err


def pop_order(leaves: dict, drop=()) -> dict:
    """A host snapshot (state_to_host) with each queue row in (time, tie)
    pop order and dead slots' contents zeroed, without the leaves in
    `drop`: what two runs that lay out their slots differently (the
    segment landing) share."""
    out = {k: v for k, v in leaves.items() if k not in drop}
    time = leaves[".queue.time"]
    dead = time >= (1 << 62) - 1
    tie = np.where(dead, np.iinfo(np.int64).max, leaves[".queue.tie"])
    order = np.lexsort((tie, time), axis=1)
    oi = np.arange(time.shape[0])[:, None]
    out[".queue.time"], out[".queue.tie"] = time[oi, order], tie[oi, order]
    for f in ("kind", "aux"):
        out[f".queue.{f}"] = np.where(dead, 0, leaves[f".queue.{f}"])[oi, order]
    out[".queue.data"] = np.where(dead[:, :, None], 0, leaves[".queue.data"])[oi, order]
    return out


def snapshots_differ(want: dict, got: dict) -> "list[str]":
    return [k for k in want if k not in got or got[k].shape != want[k].shape
            or not np.array_equal(got[k], want[k])]


def exponential_draws(dev, n: int = PLANES_EXP_DRAWS) -> dict:
    """rng.exponential_ns on the card against the same draws on the CPU:
    how many of n f32 Exp(1) draws -log1p(-u) CUDA's log1pf makes differ
    from the CPU's, by how many ulps at most, and how many ns values
    differ (the uniforms are integer arithmetic, equal on both)."""
    from shadow_tpu_torch import rng

    keys = rng.host_keys(PLANES_EXP_SEED, n, dev)
    ctr = torch.arange(n, dtype=torch.int64, device=dev) & rng.MASK32
    u = rng.uniform_f32(keys, ctr)
    u_cpu = rng.uniform_f32(keys.cpu(), ctr.cpu())
    draw, draw_cpu = -torch.log1p(-u), -torch.log1p(-u_cpu)
    ulps = (draw.cpu().view(torch.int32).to(torch.int64)
            - draw_cpu.view(torch.int32).to(torch.int64)).abs()
    ns = rng.exponential_ns(keys, ctr, PLANES_EXP_MEAN_NS).cpu()
    ns_cpu = rng.exponential_ns(keys.cpu(), ctr.cpu(), PLANES_EXP_MEAN_NS)
    return dict(draws=n, uniforms_differing=int((u.cpu() != u_cpu).sum()),
                draws_differing=int((ulps > 0).sum()), max_ulps=int(ulps.max()),
                ns_differing=int((ns != ns_cpu).sum()),
                max_ns_diff=int((ns - ns_cpu).abs().max()), mean_ns=PLANES_EXP_MEAN_NS)


def planes_phase(hosts: int, end_ns: int, main_ref: dict, dev) -> "tuple[bool, dict]":
    """planes-10240: the segment exchange, active-set compaction and
    dynamic runahead through the kernel. bench-10240 to end_ns with
    exchange "segment", with active_lanes H / 8 and with both: each must
    reach the oracle's counters and equal the main path's final state
    (`main_ref`, in pop order) but for iters_done and lanes_live under
    compaction; with use_dynamic_runahead through the kernel and the twin
    engine, every leaf equal. Kernel against twin, timed: a compacted
    sub-state with sentinel lanes, a dyn_runahead launch whose min_used
    changes, and a compacted sub-state of the ragged ensemble world
    (replica-major, rows_per_replica = lanes). Then that ensemble with
    all three planes on to PLANES_RAGGED_END_NS, each replica equal to
    its single run. Launch counts are set to 0 just before each run and
    read just after. Returns (ok, {"launches", "timed", "max_abs_err",
    "exponential"})."""
    from shadow_tpu_torch import equeue
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.ensemble import init_ensemble_state, replica_slice
    from shadow_tpu_torch.engine.pump import pump_stage
    from shadow_tpu_torch.engine.round import (
        _next_window_end,
        bootstrap,
        gather_lanes,
        run_until,
    )
    from shadow_tpu_torch.engine.state import init_state, rows_view, state_to_host
    from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill
    from shadow_tpu_torch.simtime import TIME_MAX

    t_phase = time.perf_counter()
    cfg, model, tables, st0 = bench_world(hosts, dev)
    lanes = hosts // PLANES_LANES_DIV
    full = hosts == BENCH_HOSTS and end_ns == BENCH_END_NS
    want = dict(events=BENCH_EVENTS, streams_done=BENCH_STREAMS_DONE, bytes_down=BENCH_BYTES_DOWN)
    shape = (".iters_done", ".lanes_live")
    info = {"launches": {}, "timed": {}, "max_abs_err": 0.0}
    ok = True

    def counted(fn):
        """fn() with the tgen launch count set to 0 just before and read
        just after: (result, launches, drain iterations, wall s)."""
        counters = {}
        sync(dev)
        mk.PUMP_KERNEL.launches_by_model["tgen"] = 0
        t0 = time.perf_counter()
        out = fn(counters)
        sync(dev)
        return (out, mk.PUMP_KERNEL.launches_by_model["tgen"], counters.get("iters", 0),
                time.perf_counter() - t0)

    # bench-10240 through the kernel: segment, and segment with compaction
    # (compaction alone, 488 launches in ~19 s, is cut for the shapes
    # phase: the segment-compact run and the compacted launches below
    # still hold it)
    variants = {"segment": dict(exchange="segment"),
                "segment-compact": dict(exchange="segment", active_lanes=lanes)}
    for name, kw in variants.items():
        vcfg = dataclasses.replace(cfg, **kw)
        out, launches, iters, wall = counted(lambda c, v=vcfg: run_until(
            st0, end_ns, model, tables, v, rounds_per_chunk=16, counters=c))
        got = bench_counters(out)
        drop = shape if "compact" in name else ()
        bad = snapshots_differ(pop_order(main_ref, drop), pop_order(state_to_host(out), drop))
        v_ok = ((got == want or not full) and not bad
                and (dev.type == "cpu" or launches == iters > 0))
        info["launches"][f"planes-{name}"] = launches
        line("planes_bench", ok=v_ok, variant=name, hosts=hosts, end_ns=end_ns,
             active_lanes=vcfg.active_lanes, exchange=vcfg.exchange, counters=got,
             pinned=want if full else None, mismatched_leaves_vs_main_path=bad,
             iters=iters, kernel_launches=launches, wall_s=round(wall, 3),
             sim_s_per_wall_s=end_ns / 1e9 / wall,
             iters_done=int(out.iters_done.sum()), lanes_live=int(out.lanes_live.sum()))
        del out
        ok = ok and v_ok

    # dynamic runahead: the kernel engine against the twin engine
    dcfg = dataclasses.replace(cfg, use_dynamic_runahead=True)
    runs = {}
    for eng, ecfg in (("megakernel", dataclasses.replace(dcfg, engine="megakernel")),
                      ("pump", dataclasses.replace(dcfg, engine="pump",
                                                   pump_k=mk.resolve_stage_cfg(cfg).pump_k))):
        out, launches, iters, wall = counted(lambda c, e=ecfg: run_until(
            st0, end_ns, model, tables, e, rounds_per_chunk=16, counters=c))
        runs[eng] = dict(state=out, launches=launches, iters=iters, wall_s=round(wall, 3))
    bad, err = leaves_equal(runs["pump"]["state"], runs["megakernel"]["state"])
    k_run = runs["megakernel"]
    d_ok = (not bad and (dev.type == "cpu" or k_run["launches"] == k_run["iters"] > 0)
            and runs["pump"]["launches"] == 0 and int(k_run["state"].min_used_lat) < TIME_MAX)
    info["launches"]["planes-dynamic"] = k_run["launches"]
    info["max_abs_err"] = max(info["max_abs_err"], err)
    line("planes_dynamic", ok=d_ok, hosts=hosts, end_ns=end_ns, mismatched_leaves=bad,
         min_used_lat=int(k_run["state"].min_used_lat), now=int(k_run["state"].now),
         counters=bench_counters(k_run["state"]),
         rounds_live=int(k_run["state"].tracker.rounds_live),
         **{f"{e}_{k}": v for e, r in runs.items() for k, v in r.items() if k != "state"})
    ok = ok and d_ok
    del runs, k_run

    # kernel against twin at one launch each, timed. First a compacted
    # sub-state with sentinel lanes. The bench world's pairs run in
    # lockstep (a window holds all of them or none), so its state is the
    # lossy world's of the ensemble cells at full width, whose loss draws
    # spread its hosts: the plain engine's state at the first whole ms
    # past its burst whose next window holds some eligible rows but fewer
    # than `lanes`
    lcfg, lmodel, ltables, l0 = lossy_world(hosts, dev, n_nodes=ENS_TGEN_NODES)
    lplain = dataclasses.replace(lcfg, engine="plain")
    sentinel, st_s = None, l0
    for t in range(LOSSY_MID_NS_SHAPED, PLANES_SENTINEL_END_NS, 1_000_000):
        st_s = run_until(st_s, t, lmodel, ltables, lplain, rounds_per_chunk=16)
        we_s = _next_window_end(st_s, ONION_WINDOW_CAP_NS, lcfg,
                                equeue.next_time(st_s.queue).amin(), ltables)
        elig = int((equeue.next_time(st_s.queue) < we_s).sum())
        if 0 < elig < lanes:
            sentinel = (t, st_s, we_s, elig)
            break
    del l0
    if sentinel is None:
        line("planes_kernel_vs_twin", ok=False, launch="compacted_sentinel",
             note=f"no state to {PLANES_SENTINEL_END_NS} ns has 0 < eligible rows < {lanes}")
        return False, info
    t, st_s, we_s, elig = sentinel
    sub, _, live = gather_lanes(st_s, we_s, lanes)
    s_ok, entry, err = timed_stage("planes_kernel_vs_twin", sub, we_s, lmodel, ltables,
                                   mk.resolve_stage_cfg(lcfg), 20, dev,
                                   launch="compacted_sentinel", world=f"lossy-{hosts}",
                                   at_ns=t, lanes=lanes, eligible=elig,
                                   sentinel_lanes=int((~live).sum()))
    info["timed"]["compacted_sentinel"] = entry
    info["max_abs_err"] = max(info["max_abs_err"], err)
    ok = ok and s_ok and int((~live).sum()) > 0
    del sub, st_s

    # dyn_runahead=1 at the burst, min_used reset to TIME_MAX: the launch's
    # cross-host packets must fold into it
    st_d = run_until(st0, BURST_NS, model, tables, dataclasses.replace(cfg, engine="plain"))
    we = _next_window_end(st_d, end_ns, cfg, equeue.next_time(st_d.queue).amin(), tables)
    st_d.min_used_lat.fill_(TIME_MAX)
    dscfg = mk.resolve_stage_cfg(dcfg)
    d_ok, entry, err = timed_stage("planes_kernel_vs_twin", st_d, we, model, tables, dscfg, 20,
                                   dev, must_take=True, launch="dyn_runahead")
    after = pump_stage(st_d.clone(), we, model, tables, dscfg)[0]
    moved = int(after.min_used_lat)
    line("planes_min_used", ok=moved < TIME_MAX, launch="dyn_runahead", before=TIME_MAX,
         after=moved)
    info["timed"]["dyn_runahead"] = dict(entry, min_used_after=moved)
    info["max_abs_err"] = max(info["max_abs_err"], err)
    ok = ok and d_ok and moved < TIME_MAX
    del st_d, after, st0

    # the ragged ensemble world with all three planes
    r = ENS_RAGGED_REPLICAS
    rh = hosts - RAGGED_SHORT
    rcfg, rmodel, rtables, _ = lossy_world(rh, dev, n_nodes=ENS_TGEN_NODES)
    rlanes = lanes  # 2 x 1,280 rows at full width
    pcfg = dataclasses.replace(rcfg, exchange="segment", active_lanes=rlanes,
                               use_dynamic_runahead=True)
    bw = bw_bits_per_sec_to_refill(20_000_000)
    ends = (LOSSY_MID_NS_SHAPED, PLANES_RAGGED_END_NS)
    ens0 = init_ensemble_state(pcfg, rmodel, r, 1, bw, bw, device=dev)
    (mid, out), wall, iters, launches, _ = ensemble_main_path(
        ens0, rmodel, rtables, pcfg, "tgen", ends, dev)
    del ens0
    info["launches"][f"planes-ragged-{rh}x{r}"] = launches
    singles = {}
    for i in range(r):
        icfg = dataclasses.replace(pcfg, seed=pcfg.seed + i)
        s0 = bootstrap(init_state(icfg, rmodel.init(dev), bw, bw, device=dev), rmodel, icfg)
        one, wall1, iters1, _ = single_main_path(s0, rmodel, rtables, icfg, ends, dev)
        singles[i] = dict(bad=leaves_equal(replica_slice(out, i), one)[0],
                          wall_s=round(wall1, 3), iters=iters1)
        del one, s0
    e_ok = ((dev.type == "cpu" or launches == iters > 0)
            and not any(s["bad"] for s in singles.values())
            and len(set(out.events_handled.sum(dim=1).tolist())) > 1)
    line("planes_ragged_ensemble", ok=e_ok, cell=f"planes-ragged-{rh}x{r}", hosts=rh,
         replicas=r, active_lanes=rlanes, exchange="segment", dynamic_runahead=True,
         end_ns=PLANES_RAGGED_END_NS, wall_s=round(wall, 3), iters=iters,
         kernel_launches=launches, events_per_replica=out.events_handled.sum(dim=1).tolist(),
         min_used_lat=out.min_used_lat.tolist(),
         singles={i: {k: v for k, v in s.items()} for i, s in singles.items()})
    ok = ok and e_ok
    del out

    # a compacted sub-state of the ensemble's rows at the burst: R x lanes
    # rows, replica-major, each row reading its replica's window end
    rows = rows_view(mid)
    we_r = ensemble_window(rows, pcfg, rtables)
    sub, _, live = gather_lanes(rows, we_r, rlanes)
    c_ok, entry, err = timed_stage(
        "planes_kernel_vs_twin", sub, we_r, rmodel, rtables, mk.resolve_stage_cfg(pcfg), 20,
        dev, must_take=True, launch="ensemble_compacted", rows=int(sub.num_hosts),
        rows_per_replica=rlanes, replicas=r, sentinel_lanes=int((~live).sum()),
        window_end=we_r.tolist())
    info["timed"]["ensemble_compacted"] = entry
    info["max_abs_err"] = max(info["max_abs_err"], err)
    ok = ok and c_ok and int(sub.num_hosts) == r * rlanes
    del sub, rows, mid

    info["exponential"] = exponential_draws(dev)
    line("exponential_ns", **info["exponential"])
    line("planes", ok=ok, seconds=round(time.perf_counter() - t_phase, 3),
         launches=info["launches"])
    return ok, info


def build_guests(out_dir: str) -> dict:
    """examples/http's and examples/http-matrix's guests, built by `cc` as
    examples/http/shadow.yaml says: {(example, name): path}."""
    bins = {}
    for example in ("http", "http-matrix"):
        os.makedirs(os.path.join(out_dir, example))
        for name in MANAGED_GUESTS:
            # the binary's own name: guest output files are named after it
            dst = os.path.join(out_dir, example, name)
            subprocess.run(["cc", "-O2", "-o", dst,
                            os.path.join(HERE, "examples", example, f"{name}.c")], check=True)
            bins[(example, name)] = dst
    return bins


def managed_subs(bins: dict, serial: bool = False, parallel: bool = False) -> tuple:
    """(old, new) edits of examples/http/shadow.yaml: the built guests,
    and `scheduler: managed` or `parallelism: MANAGED_PARALLELISM`."""
    subs = [(f"examples/http/{g}", bins[("http", g)]) for g in MANAGED_GUESTS]
    if serial:
        subs.append(("network:\n", f"experimental:\n{MANAGED_SERIAL}network:\n"))
    if parallel:
        subs.append(("general:\n", f"general:\n  parallelism: {MANAGED_PARALLELISM}\n"))
    return tuple(subs)


def managed_http_config(tmp: str, name: str, subs: tuple) -> str:
    """examples/http/shadow.yaml edited by `subs`, with a data directory
    of its own under `tmp`, written there: its path."""
    src = open(os.path.join(HERE, "examples", MANAGED_HTTP)).read()
    for old, new in subs:
        if old not in src:
            raise ValueError(f"{MANAGED_HTTP}: no {old!r} to edit")
        src = src.replace(old, new)
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(src.replace("data_directory: shadow.data",
                            f"data_directory: {os.path.join(tmp, name)}"))
    return path


def managed_cli_finish(run: dict) -> dict:
    """Wait for a CLI run cli_start started on examples/http: its rc,
    wall, sim-stats and the files of its data directory (guest
    stdout/stderr, strace, hosts)."""
    rc = run["proc"].wait()
    out = dict(rc=rc, wall_s=round(time.perf_counter() - run["t0"], 3), stats={}, files={})
    if rc == 0:
        with open(os.path.join(run["data"], "sim-stats.json")) as f:
            out["stats"] = json.load(f)
        for root, _dirs, names in os.walk(run["data"]):
            for n in names:
                p = os.path.join(root, n)
                rel = os.path.relpath(p, run["data"])
                if rel not in ("sim-stats.json", "processed-config.json"):
                    with open(p, "rb") as f:
                        out["files"][rel] = f.read()
    with open(run["stderr"]) as f:
        out["stderr_tail"] = f.read()[-2000:]
    for tmp in run["tmps"]:
        tmp.cleanup()
    return out


def managed_http_start(dev, bins: dict, tmp: str) -> dict:
    """Start managed-http's CLI runs, each in a process of its own:
    examples/http through `python -m shadow_tpu_torch run` three ways, the
    hybrid with its device plane on `dev`, the same with `--device cpu`,
    and `scheduler: managed` (the serial host kernel, no device), plus the
    hybrid at parallelism MANAGED_PARALLELISM under a worker-kill fault
    with a metrics stream. A handle for managed_http_finish."""
    metrics = os.path.join(tmp, "kill-metrics.jsonl")
    cpu = torch.device("cpu")
    runs = {
        "hybrid_card": cli_start(MANAGED_HTTP, dev, subs=managed_subs(bins)),
        "hybrid_cpu": cli_start(MANAGED_HTTP, cpu, subs=managed_subs(bins)),
        "managed": cli_start(MANAGED_HTTP, dev, subs=managed_subs(bins, serial=True)),
        "parallel_kill": cli_start(
            MANAGED_HTTP, dev, subs=managed_subs(bins, parallel=True),
            extra=("--chaos-fault", MANAGED_KILL, "--metrics-file", metrics)),
    }
    return dict(runs=runs, metrics=metrics, t0=time.perf_counter())


def managed_http_finish(handle: dict) -> dict:
    """Wait for managed_http_start's runs: {way: managed_cli_finish's
    record}, the metrics stream's path and the runs' wall."""
    runs = {w: managed_cli_finish(r) for w, r in handle["runs"].items()}
    return dict(runs=runs, metrics=handle["metrics"],
                wall_s=round(time.perf_counter() - handle["t0"], 3))


def managed_http_phase(dev, bins: dict, tmp: str, cli: dict) -> bool:
    """managed-http: the CLI runs of managed_http_start (`cli`, as
    managed_http_finish returns them): every run's data directory (guest
    stdout, strace files, hosts) and sim-stats (but for wall clock,
    execution shape, the scheduler's name and the chaos section) are
    equal; the killed worker was respawned once. The three ways are also
    run in this process through Manager.run, whose packet event logs
    must be equal as time-sorted multisets."""
    from shadow_tpu_torch.config import load_config_file
    from shadow_tpu_torch.runtime.manager import Manager

    logs, walls = {}, {}
    for way, device in (("hybrid_card", dev), ("hybrid_cpu", torch.device("cpu")),
                        ("managed", dev)):
        cfg_path = managed_http_config(tmp, f"inproc_{way}",
                                       managed_subs(bins, serial=way == "managed"))
        t1 = time.perf_counter()
        res = Manager(load_config_file(cfg_path), device=device).run()
        walls[way] = round(time.perf_counter() - t1, 3)
        logs[way] = sorted(res.event_log)
    runs, metrics = cli["runs"], cli["metrics"]
    names = {"hybrid_card": "tpu-hybrid", "hybrid_cpu": "tpu-hybrid", "managed": "managed",
             "parallel_kill": "tpu-hybrid-par"}
    ref = runs["hybrid_cpu"]
    base = trajectory_stats(ref["stats"], drop=("scheduler",))
    differ = {w: [k for k in set(base) | set(trajectory_stats(r["stats"], ("scheduler", "chaos")))
                  if trajectory_stats(r["stats"], ("scheduler", "chaos")).get(k) != base.get(k)]
              for w, r in runs.items()}
    files_differ = {w: sorted(k for k in set(r["files"]) | set(ref["files"])
                              if r["files"].get(k) != ref["files"].get(k))
                    for w, r in runs.items()}
    respawns = []
    if os.path.exists(metrics):
        with open(metrics) as f:
            respawns = [e for e in map(json.loads, f)
                        if e.get("type") == "event" and e.get("kind") == "worker_respawn"]
    execution = {w: r["stats"].get("execution") for w, r in runs.items()}
    clients_done = all(b"client done" in ref["files"].get(f"client{i}/http_client.100{i}.stdout",
                                                           b"") for i in (1, 2))
    card_exec = execution["hybrid_card"] or {}
    checks = {
        "rc": all(r["rc"] == 0 for r in runs.values()),
        "schedulers": all(runs[w]["stats"].get("scheduler") == n for w, n in names.items()),
        "sim_stats": not any(differ.values()),
        "files": not any(files_differ.values()),
        "clients_done": clients_done,
        "chaos": runs["parallel_kill"]["stats"].get("chaos", {}).get("fired")
        == [{"kind": "worker-kill", "at": 2}],
        "one_respawn": len(respawns) == 1,
        "event_logs": logs["hybrid_card"] == logs["hybrid_cpu"] == logs["managed"]
        and len(logs["managed"]) > 0,
        "device_plane": str(card_exec.get("device", "")).startswith(dev.type)
        and card_exec.get("device_passes", 0) > 0,
        "serial_no_device": "device" not in (execution["managed"] or {}),
    }
    ok = all(checks.values())
    line("managed_http", ok=ok, checks=checks, config=MANAGED_HTTP, cli_runs_wall_s=cli["wall_s"],
         cli_wall_s={w: r["wall_s"] for w, r in runs.items()}, in_process_wall_s=walls,
         rc={w: r["rc"] for w, r in runs.items()},
         schedulers={w: r["stats"].get("scheduler") for w, r in runs.items()},
         sim_stats_differing=differ, files_differing=files_differ,
         files=len(ref["files"]), event_log_entries=len(logs["managed"]),
         event_logs_equal=logs["hybrid_card"] == logs["hybrid_cpu"] == logs["managed"],
         syscalls=ref["stats"].get("syscalls_handled"), packets=ref["stats"].get("packets_sent"),
         execution=execution, chaos=runs["parallel_kill"]["stats"].get("chaos"),
         respawn_events=respawns,
         stderr_tails={w: r["stderr_tail"] for w, r in runs.items() if r["rc"] != 0})
    return ok


def hybrid_matrix_phase(dev, bins: dict, tmp: str, pairs: int, full: bool) -> bool:
    """hybrid-http-matrix: tools/bench_hybrid.py's world built through the
    port's ParallelHybridScheduler with its device state on `dev`:
    `pairs` examples/http-matrix client/server pairs on two sites 10 ms
    apart, MATRIX_WORKERS kernel workers, one fetch of MATRIX_BYTES each.
    Every client fetched its document exactly; at full size the syscall,
    packet and device-pass counts equal the JAX package's (MATRIX_STATS).
    Prints the wall, phase_wall, the tracker's span totals and the device
    the engine state was on."""
    from shadow_tpu_torch.engine.state import EngineConfig
    from shadow_tpu_torch.graph import NetworkGraph, compute_routing
    from shadow_tpu_torch.hostk.kernel import ProcessSpec
    from shadow_tpu_torch.runtime.hybrid import ParallelHybridScheduler
    from shadow_tpu_torch.utils.tracker import Tracker

    graph = NetworkGraph.from_gml("""graph [
  directed 0
  node [ id 0 ]
  node [ id 1 ]
  edge [ source 0 target 0 latency "1 ms" ]
  edge [ source 1 target 1 latency "1 ms" ]
  edge [ source 0 target 1 latency "10 ms" ]
]""")
    names = [f"server{i}" for i in range(pairs)] + [f"client{i}" for i in range(pairs)]
    nodes = [0] * pairs + [1] * pairs
    tables = compute_routing(graph, device=dev).with_hosts(nodes)
    cfg = EngineConfig(num_hosts=2 * pairs, queue_capacity=256, outbox_capacity=64,
                       runahead_ns=graph.min_latency_ns(), seed=MATRIX_SEED)
    specs = []
    for i in range(pairs):
        specs.append(ProcessSpec(host=f"server{i}", args=[
            bins[("http-matrix", "http_server")], "8080", str(MATRIX_BYTES),
            str(MATRIX_FETCHES)]))
        specs.append(ProcessSpec(host=f"client{i}", args=[
            bins[("http-matrix", "http_client")], f"server{i}", "8080", str(MATRIX_FETCHES)],
            start_ns=(50 + (i % 200)) * 1_000_000))
    t0 = time.perf_counter()
    sched = ParallelHybridScheduler(
        tables, cfg, host_names=names, host_nodes=nodes, specs=specs,
        num_workers=MATRIX_WORKERS, seed=MATRIX_SEED, data_dir=os.path.join(tmp, "matrix"),
        device=dev)
    start_s = time.perf_counter() - t0
    sched.tracker = Tracker(host_names=names, counters=False)
    try:
        t0 = time.perf_counter()
        try:
            sched.run(MATRIX_SIM_NS)
        finally:
            sched.shutdown()
        sync(dev)
        wall = time.perf_counter() - t0
        stats = sched.stats()
        info = sched.proc_info()
    finally:
        sched.close()
    want = f"fetched {MATRIX_FETCHES}/{MATRIX_FETCHES}".encode()
    clients_ok = sum(1 for p in info if p["host"].startswith("client") and want in p["stdout"])
    got = {"syscalls": stats["syscalls_handled"], "packets": stats["packets_sent"],
           "device_passes": sched.device_passes}
    state_device = str(sched.st.device)
    ok = (clients_ok == pairs and (got == MATRIX_STATS or not full)
          and state_device.startswith(dev.type) and sched._respawns == [0] * MATRIX_WORKERS)
    line("hybrid_http_matrix", ok=ok, pairs=pairs, guests=2 * pairs, workers=MATRIX_WORKERS,
         fetches=MATRIX_FETCHES, nbytes=MATRIX_BYTES, sim_s=MATRIX_SIM_NS / 1e9,
         clients_ok=clients_ok, counters=got, pinned=MATRIX_STATS if full else None,
         state_device=state_device, wall_s=round(wall, 3), start_s=round(start_s, 3),
         sim_s_per_wall_s=MATRIX_SIM_NS / 1e9 / wall,
         phase_wall={k: round(v, 3) for k, v in sched.phase_wall.items()},
         span_totals=sched.tracker.phase_totals(),
         span_counts={k: v["count"] for k, v in sched.tracker.phase_stats().items()},
         respawns=sched._respawns)
    return ok


def managed_start(dev, tmp: str) -> dict:
    """Build the managed guests into `tmp` and start managed-http's CLI
    runs (managed_http_start): a handle for managed_phase."""
    t0 = time.perf_counter()
    bins = build_guests(tmp)
    line("managed_guests", ok=True, built=sorted(f"{e}/{n}" for e, n in bins),
         seconds=round(time.perf_counter() - t0, 3))
    return dict(bins=bins, tmp=tmp, cli=managed_http_start(dev, bins, tmp))


def managed_phase(dev, hosts: int, full: bool, started: dict, cli: dict) -> bool:
    """managed: managed-http on the CLI runs managed_start started (`cli`,
    as managed_http_finish returns them), then hybrid-http-matrix (at
    MATRIX_PAIRS on the card; a CPU rehearsal takes `hosts` / 2 pairs)."""
    bins, tmp = started["bins"], started["tmp"]
    if not managed_http_phase(dev, bins, tmp, cli):
        return False
    pairs = MATRIX_PAIRS if full else max(2, min(MATRIX_PAIRS, hosts // 2))
    return hybrid_matrix_phase(dev, bins, tmp, pairs, full)


def services_world(hosts: int, stop_ns: int, path: str = "tgen", args=None) -> dict:
    """The services cell's world as a config mapping (SERVICES_* above):
    lossy_world's graph style written as GML inline, host groups one a
    node, the first half of the nodes holding the clients; `path` names
    the registered model, `args` its args (tgen's by default)."""
    half, per_half = hosts // 2, SERVICES_NODES // 2
    sizes = [half // per_half + (i < half % per_half) for i in range(per_half)]
    sizes += [(hosts - half) // per_half + (i < (hosts - half) % per_half)
              for i in range(per_half)]
    if args is None:
        args = {"clients": half, "resp_bytes": 40_000, "pause": "30 ms"}
    proc = {"path": path, "args": args}
    return {
        "general": {"stop_time": f"{stop_ns} ns", "heartbeat_interval": None, "tracker": True},
        "network": {"graph": {"type": "gml", "inline": lossy_gml(SERVICES_NODES, 0.05, 11) + "\n"}},
        "experimental": {"rounds_per_chunk": SERVICES_RPC, "queue_capacity": 192,
                         "outbox_capacity": 32},
        "hosts": {f"n{i}": {"network_node_id": i, "quantity": q, "bandwidth_up": "20 Mbit",
                            "bandwidth_down": "20 Mbit", "processes": [proc]}
                  for i, q in enumerate(sizes)},
    }


def job_trajectory(stats: dict) -> dict:
    """A job's sim-stats without the wall clock and the execution shape
    (tests/test_sweep_cli.py::_stats's fields and the port's `execution`):
    a job in a batch and its single run must agree on the rest."""
    out = trajectory_stats(stats)
    tracker = dict(out.get("tracker") or {})
    tracker.pop("phases", None)
    if "window" in tracker:
        tracker["window"] = {k: v for k, v in tracker["window"].items()
                             if k not in ("iters", "lanes_live", "occupancy")}
    if tracker:
        out["tracker"] = tracker
    return out


def services_daemon_run(dev, out_path: str) -> int:
    """The services cell's daemon part, for a process of its own
    (`--services-daemon OUT`): three `serve` daemons on `dev` taking
    submitted tgen jobs (examples/tgen cut to SERVICES_DAEMON_STOP), each
    a process of its own with a bounded wait. The first stores its
    build in the persistent cache, where a `cache-corrupt` fault damages
    it, and is SIGKILLed by the chaos plane at chunk
    SERVICES_DAEMON_KILL_AT of its batch; the second, the restart,
    rebuilds the damaged entry with the sha-256 warning, replays the
    journal and resumes the batch from its newest checkpoint (no job
    lost, every job's sim-stats that of a single `run` of its seed
    here); the third starts on the warm spool with the HTTP front door
    on 127.0.0.1 (a POSTed job of the same world, its status and
    results, a 404 and a 400) and builds nothing: the persistent cache's
    disk hit. Writes the checks and figures to OUT (JSON)."""
    import signal
    import urllib.error
    import urllib.request

    import yaml

    from shadow_tpu_torch.runtime.cli_run import run_from_config, run_submit
    from shadow_tpu_torch.runtime.daemon import journal_terminal_map

    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    device = ["--device", "cpu"] if dev.type == "cpu" else []
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with open(os.path.join(HERE, "examples", "tgen", "shadow.yaml")) as f:
        base = yaml.safe_load(f)
    base["general"].pop("data_directory")
    base["general"].pop("seed")
    base["general"].update(stop_time=SERVICES_DAEMON_STOP, heartbeat_interval=None,
                           checkpoint_interval=SERVICES_DAEMON_CKPT)
    base["experimental"]["rounds_per_chunk"] = SERVICES_DAEMON_RPC
    out, checks, procs = {}, {}, []

    def spec(tenant, seeds) -> str:
        path = os.path.join(root, f"{tenant}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump({"job": {"tenant": tenant, "name": "tg", "seeds": list(seeds),
                                    "config": base}}, f)
        return path

    def serve(spool, *args, wait=True):
        cmd = [sys.executable, "-m", "shadow_tpu_torch", "serve", spool, *device,
               "--lease-s", SERVICES_DAEMON_LEASE_S, *args]
        if not wait:
            proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            procs.append(proc)
            return proc
        t0 = time.perf_counter()
        r = subprocess.run(cmd + ["--drain"], cwd=HERE, env=env, capture_output=True,
                           text=True, timeout=SERVICES_DAEMON_WAIT_S)
        return r.returncode, r.stdout + r.stderr, round(time.perf_counter() - t0, 3)

    def manifest(spool) -> dict:
        with open(os.path.join(spool, "daemon-manifest.json")) as f:
            return json.load(f)

    def job_stats(spool, job) -> dict:
        with open(os.path.join(spool, "jobs", job, "sim-stats.json")) as f:
            return json.load(f)

    try:
        spool, cache = os.path.join(root, "spool"), os.path.join(root, "cache")
        run_submit(spool, spec("alice", (1, 2)))
        rc, text, wall = serve(spool, "--cache-dir", cache, "--chaos-fault", "cache-corrupt@0",
                               "--chaos-fault",
                               f"daemon-kill@{SERVICES_DAEMON_KILL_AT}:target=chunk")
        checks["killed"] = rc in (-signal.SIGKILL, 128 + signal.SIGKILL)
        out["killed"] = dict(rc=rc, wall_s=wall, tail=text[-600:] if not checks["killed"] else "")
        rc, text, wall = serve(spool, "--cache-dir", cache)
        m = manifest(spool)
        resume = m["daemon"].get("resume", {})
        term = journal_terminal_map(spool)
        cache_stats = m["compile_cache"]
        warned = "failed its sha-256 integrity check; rebuilding" in text
        checks["restarted"] = (rc == 0 and resume.get("crashed") is True
                               and bool(resume.get("batches"))
                               and all(b["checkpoint"] for b in resume["batches"])
                               and term == {"alice.tg-s1": "done", "alice.tg-s2": "done"})
        checks["cache_corrupt_rebuilt"] = (
            warned and cache_stats["compiles"] == 1 and cache_stats["persistent"]["disk_skips"] == 1
            and cache_stats["persistent"]["disk_stores"] == 1)
        out["restarted"] = dict(rc=rc, wall_s=wall, resume=resume, terminal=term,
                                compile_cache=cache_stats, warned=warned,
                                tail=text[-600:] if not checks["restarted"] else "")
        singles = {}
        for seed in (1, 2):
            cfg = dict(base, general=dict(base["general"], seed=seed,
                                          data_directory=os.path.join(root, f"alone-{seed}")))
            path = os.path.join(root, f"alone-{seed}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f)
            assert run_from_config(path, device=str(dev.type)) == 0
            with open(os.path.join(root, f"alone-{seed}", "sim-stats.json")) as f:
                singles[seed] = job_trajectory(json.load(f))
        executions = {s: job_stats(spool, f"alice.tg-s{s}")["execution"] for s in (1, 2)}
        checks["jobs_equal_single_runs"] = all(
            job_trajectory(job_stats(spool, f"alice.tg-s{s}")) == singles[s] for s in (1, 2))
        out["executions"] = executions

        # the warm spool, its HTTP front door on 127.0.0.1
        d = serve(spool, "--cache-dir", cache, "--http", "127.0.0.1:0", "--poll-interval",
                  "0.2", wait=False)
        t0 = time.perf_counter()
        addr_file = os.path.join(spool, "http-address")
        while not os.path.exists(addr_file) and time.perf_counter() - t0 < 120:
            time.sleep(0.2)
        with open(addr_file) as f:
            url = f"http://{f.read().strip()}"

        def req(method, path, body=None):
            r = urllib.request.Request(url + path, method=method,
                                       data=body.encode() if body is not None else None)
            try:
                with urllib.request.urlopen(r, timeout=60) as resp:
                    return resp.status, resp.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        with open(spec("bob", (3, 4))) as f:
            code, body = req("POST", "/v1/jobs", f.read())
        codes = {"post": code, "ids": json.loads(body).get("job_ids")}
        status = {}
        while time.perf_counter() - t0 < SERVICES_DAEMON_WAIT_S:
            status = {j: json.loads(req("GET", f"/v1/jobs/{j}")[1] or "{}").get("status")
                      for j in ("bob.tg-s3", "bob.tg-s4")}
            if all(v in ("done", "failed", "quarantined") for v in status.values()):
                break
            time.sleep(0.5)
        code, body = req("GET", "/v1/jobs/bob.tg-s3/results")
        codes["results"] = code
        results_equal = code == 200 and json.loads(body) == job_stats(spool, "bob.tg-s3")
        codes["unknown"] = req("GET", "/v1/jobs/bob.nope-s9")[0]
        codes["bad_body"] = req("POST", "/v1/jobs", ":-not yaml: [")[0]
        d.send_signal(signal.SIGTERM)
        text = d.communicate(timeout=SERVICES_DAEMON_WAIT_S)[0]
        m = manifest(spool)
        cache_stats = m["compile_cache"]
        checks["http_warm"] = (
            d.returncode == 0 and codes == {"post": 202, "ids": ["bob.tg-s3", "bob.tg-s4"],
                                            "results": 200, "unknown": 404, "bad_body": 400}
            and status == {"bob.tg-s3": "done", "bob.tg-s4": "done"} and results_equal
            and cache_stats["compiles"] == 0 and cache_stats["persistent"]["disk_hits"] >= 1)
        out["http_warm"] = dict(rc=d.returncode, codes=codes, status=status,
                                results_equal=results_equal, compile_cache=cache_stats,
                                wall_s=round(time.perf_counter() - t0, 3),
                                tail=text[-600:] if not checks["http_warm"] else "")
    except Exception as e:  # noqa: BLE001 — reported, and the phase fails
        out["error"] = f"{type(e).__name__}: {e}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.cleanup()
    out["checks"] = checks
    out["ok"] = bool(checks) and all(checks.values()) and "error" not in out
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def services_daemon_start(dev) -> dict:
    """Start services_daemon_run in a process of its own (this script
    with `--services-daemon`), in a session of its own so that its serve
    daemons stop with it: a handle for services_daemon_finish."""
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "services_daemon.json")
    cmd = [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--services-daemon", out]
    if dev.type == "cpu":
        cmd += ["--rehearse-cpu", "--hosts", "64"]
    err_path = os.path.join(tmp.name, "stderr.txt")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=err, stderr=subprocess.STDOUT,
                                env=dict(os.environ, OMP_NUM_THREADS="1"),
                                start_new_session=True)
    proc.own_session = True
    STARTED.append(proc)
    return dict(proc=proc, out=out, stderr=err_path, tmp=tmp, t0=time.perf_counter())


def services_daemon_finish(run) -> dict:
    """Wait for services_daemon_run: its record, with the wall it took."""
    try:
        rc = run["proc"].wait(timeout=4 * SERVICES_DAEMON_WAIT_S)
    except subprocess.TimeoutExpired:
        rc = None
    got = {"ok": False, "rc": rc}
    if rc == 0 and os.path.exists(run["out"]):
        with open(run["out"]) as f:
            got = json.load(f)
    else:
        with open(run["stderr"]) as f:
            got["stderr_tail"] = f.read()[-2000:]
    got["wall_s"] = round(time.perf_counter() - run["t0"], 3)
    run["tmp"].cleanup()
    return got


def services_phase(hosts: int, dev, daemon: dict) -> "tuple[bool, int]":
    """services-10240: `sweep` in this process (SweepService.run, the
    entry point behind `python -m shadow_tpu_torch sweep`) over the
    services world (SERVICES_* above): the low-priority seeds in two
    batches of SERVICES_CAPACITY x H rows, the priority-1 job's arrival
    preempting the running batch through a verified final checkpoint, the
    batch resumed from it. Every job done; one preemption; builds equal
    to the distinct worlds (R = 4 and R = 1), hits for the resume and the
    second batch; every batch launched the kernel on the card; the
    SERVICES_KEEP jobs' final states leaf-equal to single runs of their
    seeds through TpuScheduler.run. Then the daemon part's record
    (`daemon`, as services_daemon_finish returns it). Returns (ok, the
    sweep's kernel launches)."""
    import yaml

    from shadow_tpu_torch.config.sweep import load_sweep_file
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.ensemble import replica_slice
    from shadow_tpu_torch.engine.state import state_to_host
    from shadow_tpu_torch.runtime.manager import Manager
    from shadow_tpu_torch.runtime.scheduler import TpuScheduler
    from shadow_tpu_torch.runtime.sweep import SweepService

    class KeptSweep(SweepService):
        """The sweep, keeping on the host the final states of the
        SERVICES_KEEP jobs as their batches publish them."""

        finals: dict = {}

        def _write_batch_outputs(self, batch, final, end, runner):
            for r, job in enumerate(batch.jobs):
                if job.name in SERVICES_KEEP:
                    self.finals[job.name] = state_to_host(replica_slice(final, r))
            super()._write_batch_outputs(batch, final, end, runner)

    tmp = tempfile.TemporaryDirectory()
    with open(os.path.join(tmp.name, "base.yaml"), "w") as f:
        yaml.safe_dump(services_world(hosts, SERVICES_END_NS), f)
    spec_path = os.path.join(tmp.name, "sweep.yaml")
    with open(spec_path, "w") as f:
        yaml.safe_dump({"sweep": {
            "name": f"services-{hosts}", "base": "base.yaml",
            "output_dir": os.path.join(tmp.name, "out"), "capacity": SERVICES_CAPACITY,
            "jobs": [{"name": "lo", "seed_range": [0, SERVICES_SEEDS], "priority": 0},
                     {"name": "hi", "seeds": [SERVICES_HI_SEED], "priority": 1,
                      "arrival": f"{SERVICES_ARRIVAL_NS} ns"}]}}, f)
    spec = load_sweep_file(spec_path)
    svc = KeptSweep(spec, device=dev)
    svc.finals = {}
    sync(dev)
    mk.PUMP_KERNEL.launches = 0
    t0 = time.perf_counter()
    m = svc.run()
    sync(dev)
    wall = time.perf_counter() - t0
    launches = mk.PUMP_KERNEL.launches
    execution = {}
    for job in spec.jobs:
        with open(os.path.join(job.config.general.data_directory, "sim-stats.json")) as f:
            execution[job.name] = json.load(f)["execution"]
    on_card = dev.type == "cpu" or (
        launches > 0 and all(e["engine"] == "megakernel" and e["kernel_launches"][
            "pump_megakernel"] > 0 for e in execution.values()))
    preempted = [b for b in m["batches"] if b["preemptions"]]
    cache = m["compile_cache"]
    ok = (m["jobs_done"] == len(spec.jobs) == SERVICES_SEEDS + 1 and m["preemptions"] == 1
          and len(preempted) == 1 and "lo-s0" in preempted[0]["jobs"]
          and (cache["compiles"], cache["hits"]) == (2, 2) and on_card)
    # the kept jobs against single runs of their seeds
    singles, bad = {}, {}
    for name in SERVICES_KEEP:
        job = next(j for j in spec.jobs if j.name == name)
        world = Manager(job.config, device=dev).build_world()
        sched = TpuScheduler(world.model, world.tables, world.ecfg, rounds_per_chunk=SERVICES_RPC,
                             tx_bytes_per_interval=world.tx_refill,
                             rx_bytes_per_interval=world.rx_refill, device=dev)
        t1 = time.perf_counter()
        final = sched.run(SERVICES_END_NS)
        sync(dev)
        singles[name] = round(time.perf_counter() - t1, 3)
        bad[name] = host_leaves_equal(svc.finals[name], final)
        del final
    ok = ok and len(svc.finals) == len(SERVICES_KEEP) and not any(bad.values())
    events = {j["name"]: j["stats"]["events_handled"] for j in m["jobs"] if "stats" in j}
    ok = ok and len(set(events.values())) > 1
    line("services_sweep", ok=ok, cell=f"services-{hosts}", hosts=hosts, end_ns=SERVICES_END_NS,
         wall_s=round(wall, 3), kernel_launches=launches, preemptions=m["preemptions"],
         jobs_done=m["jobs_done"], compile_cache=cache,
         batches=[{k: b[k] for k in ("index", "jobs", "replicas", "status", "wall_seconds",
                                     "preemptions")} for b in m["batches"]],
         launches_by_job={k: v["kernel_launches"]["pump_megakernel"] for k, v in execution.items()},
         events_by_job=events, single_runs_wall_s=singles, mismatched_leaves_vs_single=bad)
    tmp.cleanup()
    ok_d = bool(daemon.get("ok"))
    line("services_daemon", **{k: v for k, v in daemon.items()})
    return ok and ok_d, launches

def shape_builds_start() -> dict:
    """Build the libraries of SHAPE_MODELS' TCP shapes, one nvcc each in a
    thread of this process, started beside the default shape's build
    (phase 2) and going on through phase 3: a handle for
    shape_builds_finish."""
    from shadow_tpu_torch.engine import megakernel as mk

    started = {}
    t0 = time.perf_counter()
    for name, (_, shape) in SHAPE_MODELS.items():
        rec = {"shape": shape}

        def build(rec=rec):
            try:
                mk.PUMP_KERNEL.library(rec["shape"])
            except Exception as err:  # shape_builds_finish fails the smoke with it
                rec["error"] = err
            rec["done_s"] = time.perf_counter() - t0

        rec["thread"] = threading.Thread(target=build, daemon=True)
        rec["thread"].start()
        started[name] = rec
    return started


def shape_builds_finish(started) -> "tuple[bool, dict]":
    """Wait for shape_builds_start's builds and print a `build_shapes`
    line: per shape nvcc's seconds, its ptxas lines (registers, stack,
    spill stores and loads) and each instance's resources, or nvcc's
    output where a build failed (which fails the smoke: no twin runs in a
    kernel's place). Returns (ok, resources by instance name)."""
    from shadow_tpu_torch.engine import megakernel as mk

    t0 = time.perf_counter()
    ok, resources, out = True, {}, {}
    for name, rec in started.items():
        rec["thread"].join()
        shape = rec["shape"]
        if "error" in rec:
            ok = False
            out[name] = dict(shape=list(shape), error=str(rec["error"])[-6000:])
            continue
        log = mk.PUMP_KERNEL.build_log[shape]
        res = ptxas_resources(log, shape)
        resources.update(res)
        out[name] = dict(
            shape=list(shape), nvcc_seconds=mk.PUMP_KERNEL.build_seconds.get(shape),
            done_s=round(rec["done_s"], 3), instances=res,
            ptxas=[ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln or "stack frame" in ln])
    line("build_shapes", ok=ok, waited_s=round(time.perf_counter() - t0, 3), **out)
    return ok, resources


def onion_shape_run(hosts: int, dev, out_path: str) -> int:
    """onion_r2s2's main path, for a process of its own (`--onion-shape
    OUT`): SHAPE_MODELS' onion_r2s2 on onion_world (engine "auto": the
    kernel's onion instance at (2, 2) on the card) to each of
    ONION_SHAPE_NS in turn, the launches counted from 0 just before; its
    state at each (torch.save, OUT.<i>.pt) and its record (OUT, JSON)."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.round import effective_engine, run_until
    from shadow_tpu_torch.models import registry

    register_shape_models(registry)
    cfg, model, tables, st = onion_world(hosts, dev, path="onion_r2s2")
    name = mk.kernel_instance(model, mk.resolve_stage_cfg(cfg))
    if dev.type == "cuda":
        mk.PUMP_KERNEL.library(mk.tcp_shape(model))  # built, or loaded, before the wall
    counters, states, saving = {}, [], 0.0
    sync(dev)
    mk.PUMP_KERNEL.launches_by_model[name] = 0
    t0 = time.perf_counter()
    for i, at in enumerate(ONION_SHAPE_NS):
        st = run_until(st, at, model, tables, cfg, rounds_per_chunk=16, counters=counters)
        sync(dev)
        t1 = time.perf_counter()
        torch.save(st, f"{out_path}.{i}.pt")
        states.append(f"{out_path}.{i}.pt")
        saving += time.perf_counter() - t1
    wall = time.perf_counter() - t0 - saving
    record = dict(instance=name, engine=effective_engine(cfg, dev), hosts=hosts,
                  clients=model.num_clients, relays=model.num_relays,
                  sockets=model.tcp_params.num_sockets, shape=list(mk.tcp_shape(model)),
                  at_ns=list(ONION_SHAPE_NS), wall_s=round(wall, 3),
                  sim_s_per_wall_s=ONION_SHAPE_NS[-1] / 1e9 / wall,
                  iters=counters.get("iters"), launches=mk.PUMP_KERNEL.launches_by_model[name],
                  events=int(st.events_handled.sum()), states=states, **onion_counts(st))
    with open(out_path, "w") as f:
        json.dump(record, f)
    return 0


def onion_shape_start(hosts: int, dev) -> dict:
    """Start onion_shape_run in a process of its own (this script with
    `--onion-shape`): a handle for onion_shape_finish."""
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "onion_shape.json")
    cmd = [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--onion-shape", out]
    if dev.type == "cpu":
        cmd += ["--rehearse-cpu", "--hosts", str(hosts)]
    err_path = os.path.join(tmp.name, "stderr.txt")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=err, stderr=subprocess.STDOUT,
                                env=dict(os.environ, OMP_NUM_THREADS="1"))
    STARTED.append(proc)
    return dict(proc=proc, out=out, stderr=err_path, tmp=tmp)


def onion_shape_finish(run) -> "dict | None":
    """Wait for onion_shape_run: its record, or None (with nvcc's or the
    run's output in a failing line)."""
    if run["proc"].wait() == 0:
        with open(run["out"]) as f:
            return json.load(f)
    with open(run["stderr"]) as f:
        line("onion_shape_main_path", ok=False, output=f.read()[-6000:])
    return None


def shapes_phase(hosts: int, dev, onion_run) -> "tuple[bool, dict, float]":
    """shapes (phase 9e): SHAPE_MODELS through the kernel at their TCP
    shapes. tgen_ooo8, registered, runs services_world at full width to
    SHAPES_END_NS through the port's Manager in this process (the front
    door behind `run`), engine "auto", which the card resolves to the
    kernel (tgen@8x8), then at pump_k SHAPES_WIDE_K (tgen_wide@8x8), each
    with the launch counts set to 0 just before and read just after; its
    host_stats and model counters must equal the plain engine's run of
    the same config. Its kernel vs the twin at the burst
    (LOSSY_MID_NS_SHAPED) at pump_k 8, 16 and SHAPES_WIDE_K, timed alone
    with its bound. onion_r2s2's main path ran in a process of its own
    (onion_shape_run, `onion_run` its handle); its kernel vs the twin on
    that run's states, timed. Returns (ok, the instances' numbers for the
    kernels line, largest error)."""
    import yaml

    from shadow_tpu_torch import equeue
    from shadow_tpu_torch.config.options import load_config_str
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.round import _next_window_end, host_stats, run_until
    from shadow_tpu_torch.models import registry
    from shadow_tpu_torch.runtime.manager import Manager
    from shadow_tpu_torch.runtime.scheduler import TpuScheduler

    class KeptManager(Manager):
        """The front door's run, keeping its final state."""

        def _run_device(self, *args, **kw):
            self.final = super()._run_device(*args, **kw)
            return self.final

    register_shape_models(registry)
    tmp = tempfile.TemporaryDirectory()

    def config(engine: str, pump_k: int = 0):
        world = services_world(hosts, SHAPES_END_NS, path="tgen_ooo8")
        world["general"]["data_directory"] = os.path.join(tmp.name, f"{engine}-{pump_k}")
        world["experimental"].update(engine=engine, pump_k=pump_k)
        return load_config_str(yaml.safe_dump(world))

    def tgen_counts(st):
        m = st.model
        return {k: int(getattr(m, k).sum())
                for k in ("streams_started", "streams_done", "bytes_down", "resets")}

    entries, err, ok = {}, 0.0, True
    runs = {}
    for label, engine, pump_k in (("plain", "plain", 0), ("auto", "auto", 0),
                                  ("auto_wide", "auto", SHAPES_WIDE_K)):
        mgr = KeptManager(config(engine, pump_k), device=dev)
        world = mgr.build_world()
        name = mk.kernel_instance(world.model, mk.resolve_stage_cfg(world.ecfg))
        del world
        sync(dev)
        mk.PUMP_KERNEL.launches_by_model[name] = 0
        t0 = time.perf_counter()
        res = mgr.run()
        sync(dev)
        wall = time.perf_counter() - t0
        launches = mk.PUMP_KERNEL.launches_by_model[name]
        with open(os.path.join(mgr.config.general.data_directory, "sim-stats.json")) as f:
            execution = json.load(f)["execution"]
        final = mgr.final
        runs[label] = dict(hs=host_stats(final), counts=tgen_counts(final), instance=name,
                           launches=launches if engine == "auto" else 0, wall_s=round(wall, 3),
                           engine=execution["engine"], events=res.events_handled,
                           dropped=res.packets_dropped,
                           ranges_in_use_max=int((final.model.tcp.ooo[..., 0] >= 0).sum(-1).max()))
        del final, mgr
    want = runs["plain"]
    for label in ("auto", "auto_wide"):
        got = runs[label]
        diff = [k for k in want["hs"] if k not in ("iters_done", "lanes_live")
                and not np.array_equal(want["hs"][k], got["hs"][k])]
        on_card = dev.type == "cpu" or (got["engine"] == "megakernel" and got["launches"] > 0)
        ok_r = on_card and not diff and got["counts"] == want["counts"] and want["dropped"] > 0
        line("shapes_main_path", ok=ok_r, cell=f"services-{hosts}-tgen_ooo8", run=label,
             path="tgen_ooo8", shape=list(SHAPE_MODELS["tgen_ooo8"][1]), hosts=hosts,
             end_ns=SHAPES_END_NS, instance=got["instance"], engine=got["engine"],
             kernel_launches=got["launches"], wall_s=got["wall_s"],
             sim_s_per_wall_s=SHAPES_END_NS / 1e9 / got["wall_s"], plain_wall_s=want["wall_s"],
             events=got["events"], packets_dropped=got["dropped"],
             ranges_in_use_max=got["ranges_in_use_max"], differing=diff, **got["counts"])
        ok = ok and ok_r
        entries[got["instance"]] = dict(launches=got["launches"])
    if not ok:
        return False, entries, err

    # kernel vs twin at the burst, on the state the plain engine reaches
    # from the config's initial state
    world = Manager(config("auto"), device=dev).build_world()
    model, tables, cfg = world.model, world.tables, world.ecfg
    st0 = TpuScheduler(model, tables, cfg, rounds_per_chunk=SERVICES_RPC,
                       tx_bytes_per_interval=world.tx_refill,
                       rx_bytes_per_interval=world.rx_refill, device=dev).initial_state()
    st_b = run_until(st0, LOSSY_MID_NS_SHAPED, model, tables,
                     dataclasses.replace(cfg, engine="plain"), rounds_per_chunk=SERVICES_RPC)
    del st0
    we = _next_window_end(st_b, 10**9, cfg, equeue.next_time(st_b.queue).amin(), tables)
    for k in (8, 16, SHAPES_WIDE_K):
        scfg = dataclasses.replace(mk.resolve_stage_cfg(cfg), pump_k=k)
        name = mk.kernel_instance(model, scfg)
        ok_s, numbers, e = timed_stage("shapes_kernel_vs_twin", st_b, we, model, tables, scfg, 20,
                                       dev, must_take=True, instance=name, launch=f"burst_k{k}",
                                       at_ns=LOSSY_MID_NS_SHAPED, hosts=hosts)
        err = max(err, e)
        ok = ok and ok_s
        if k in (8, SHAPES_WIDE_K):
            entries[name].update(numbers)
        else:
            entries[name]["burst_k16"] = numbers
    del st_b

    # onion_r2s2: its main path's record and states
    rec = onion_shape_finish(onion_run)
    if rec is None:
        return False, entries, err
    name = rec["instance"]
    ok_o = dev.type == "cpu" or (rec["engine"] == "megakernel" and rec["launches"] > 0)
    line("onion_shape_main_path", ok=ok_o, **{k: v for k, v in rec.items() if k != "states"})
    ok = ok and ok_o
    ocfg, omodel, otables, _ = onion_world(hosts, dev, path="onion_r2s2")
    scfg = mk.resolve_stage_cfg(ocfg)
    entries[name] = dict(launches=rec["launches"])
    for i, (at, path) in enumerate(zip(rec["at_ns"], rec["states"])):
        st = torch.load(path, map_location=dev, weights_only=False)
        we = _next_window_end(st, ONION_WINDOW_CAP_NS, ocfg, equeue.next_time(st.queue).amin(),
                              otables)
        ok_s, numbers, e = timed_stage("shapes_kernel_vs_twin", st, we, omodel, otables, scfg,
                                       20, dev, must_take=True, instance=name,
                                       launch=f"main_path_{at // 1_000_000}ms", at_ns=at,
                                       hosts=hosts)
        err = max(err, e)
        ok = ok and ok_s
        if i == 0:
            entries[name].update(numbers)
        else:
            entries[name][f"at_{at // 1_000_000}ms"] = numbers
        del st
    onion_run["tmp"].cleanup()
    tmp.cleanup()
    return ok, entries, err


def logical_env() -> dict:
    """The environment that presents MESH_LOGICAL_DEVICES logical devices
    on each physical one (shadow_tpu_torch/device.py)."""
    from shadow_tpu_torch.device import LOGICAL_DEVICES_ENV

    return {LOGICAL_DEVICES_ENV: str(MESH_LOGICAL_DEVICES)}


def shard_stage(st_b, we, model, tables, scfg, reps, dev):
    """Kernel vs twin on one shard's rows of the bench world at its burst:
    shard 1 of MESH_SHARDS (hosts H/4 .. H/2 - 1, so row index != host
    id), at the world's window end (the sharded window is the pmin over
    the shards, the world's), timed with its bound. Returns timed_stage's
    (ok, numbers, largest error)."""
    from shadow_tpu_torch.engine.sharded import split_grid

    cell = split_grid(st_b, [[dev] * MESH_SHARDS])[0][1]
    rows = int(cell.num_hosts)
    ok, entry, err = timed_stage(
        "shard_kernel_vs_twin", cell, we, model, tables, scfg, reps, dev, must_take=True,
        cell=f"sharded-{int(st_b.num_hosts)}", shard=1, shards=MESH_SHARDS, rows=rows,
        first_host=int(cell.host_id[0]))
    entry["rows"] = rows
    return ok, entry, err


def mesh_cli_runs(dev) -> list:
    """The mesh's CLI runs, each in a process of its own with
    MESH_LOGICAL_DEVICES logical devices: `run --mesh 2x2` of the phold
    example (stop time cut) straight, and interrupted at
    MESH_CLI_INTERRUPT_NS then resumed with `--mesh 1x2 --replicas 2`
    (16 rounds a chunk, so that the interrupt falls mid-run), each held
    against `run --replicas 2` on it (`ref`, filled by background_clis)
    but for the mesh section and the execution shape, the resume's log
    naming the reshard; `sweep` of examples/tgen (stop time cut) seeds
    0-3 with `mesh: 2x2` and without, every job's sim-stats equal, the
    mesh sweep one batch with one build. (handle, finish) pairs."""
    ckpt_dir = tempfile.TemporaryDirectory()
    shape = ("mesh", "scheduler", "ensemble")

    def mesh_stats(stats):
        out = trajectory_stats(stats, shape)
        per = (stats.get("ensemble") or {}).get("per_replica") or []
        out["per_replica"] = [{k: v for k, v in p.items() if "wall" not in k} for p in per]
        return out

    def straight_finish(run, ref):
        ok, stats = cli_finish(run, {"scheduler": "tpu-mesh"})
        same = bool(ref.get("stats")) and mesh_stats(stats) == mesh_stats(ref["stats"])
        mesh = stats.get("mesh") or {}
        ok = ok and same and mesh.get("effective") == MESH_CLI_GRID
        line("mesh_cli", ok=ok, example="phold/shadow.yaml", grid=MESH_CLI_GRID, mesh=mesh,
             equals_replicas_run=same)
        return ok

    def resumed_finish(run, ref):
        run["proc"].wait()
        rc_interrupted = -1
        if os.path.exists(run["rc_path"]):
            with open(run["rc_path"]) as f:
                rc_interrupted = int(f.read().strip() or -1)
        ok, stats = cli_finish(run, {"scheduler": "tpu-mesh"})
        note = f", resharding {MESH_CLI_GRID} -> {MESH_CLI_RESUME_GRID}"
        logged = note in run.get("stderr_text", "")
        same = bool(ref.get("stats")) and mesh_stats(stats) == mesh_stats(ref["stats"])
        ok = ok and rc_interrupted == 130 and logged and same
        line("mesh_cli_resharded", ok=ok, example="phold/shadow.yaml",
             interrupted_rc=rc_interrupted, logged_reshard=logged, equals_replicas_run=same,
             mesh=stats.get("mesh"))
        ckpt_dir.cleanup()
        return ok

    rpc16 = (("rounds_per_chunk: 256", "rounds_per_chunk: 16"),)
    ckpt = ("--checkpoint-dir", ckpt_dir.name, "--checkpoint-interval", "100 ms")
    sweep = sweep_mesh_start(dev)
    return [
        (cli_start("phold/shadow.yaml", dev, PHOLD_EXAMPLE_STOP, extra=("--mesh", MESH_CLI_GRID),
                   env=logical_env()), straight_finish),
        (cli_start("phold/shadow.yaml", dev, PHOLD_EXAMPLE_STOP, subs=rpc16,
                   extra=("--mesh", MESH_CLI_GRID, *ckpt),
                   interrupt_ns=MESH_CLI_INTERRUPT_NS,
                   resume_extra=("--mesh", MESH_CLI_RESUME_GRID, "--replicas", "2", *ckpt),
                   env=logical_env()), resumed_finish),
        (sweep, lambda run, ref: sweep_mesh_finish(run)),
    ]


def sweep_mesh_start(dev) -> dict:
    """Start the two sweeps of examples/tgen (stop time cut; seeds 0 to
    MESH_SWEEP_SEEDS - 1 in one batch), one with `mesh: 2x2`, in processes
    of their own: a handle for sweep_mesh_finish."""
    tmp = tempfile.TemporaryDirectory()
    src = open(os.path.join(HERE, "examples", "tgen", "shadow.yaml")).read()
    old, new = MESH_SWEEP_STOP
    if old not in src:
        raise ValueError(f"examples/tgen/shadow.yaml: no {old!r} to edit")
    with open(os.path.join(tmp.name, "base.yaml"), "w") as f:
        f.write(src.replace(old, new))
    device = ["--device", "cpu"] if dev.type == "cpu" else []
    procs = {}
    for name, mesh in (("mesh", f"  mesh: {MESH_CLI_GRID}\n"), ("plain", "")):
        out = os.path.join(tmp.name, name)
        spec = os.path.join(tmp.name, f"{name}.yaml")
        with open(spec, "w") as f:
            f.write(f"sweep:\n  base: base.yaml\n  output_dir: {out}\n"
                    f"  capacity: {MESH_SWEEP_SEEDS}\n{mesh}  jobs:\n    - name: tg\n"
                    f"      seed_range: [0, {MESH_SWEEP_SEEDS}]\n")
        err = open(os.path.join(tmp.name, f"{name}.err"), "w")
        proc = subprocess.Popen([sys.executable, "-m", "shadow_tpu_torch", "sweep", spec, *device],
                                cwd=HERE, stdout=err, stderr=subprocess.STDOUT,
                                env=dict(os.environ, OMP_NUM_THREADS="1", **logical_env()))
        err.close()
        STARTED.append(proc)
        procs[name] = dict(proc=proc, out=out, err=err.name)
    return dict(procs=procs, tmp=tmp, t0=time.perf_counter())


def sweep_mesh_finish(run) -> bool:
    """Wait for both sweeps: every job done, each job's sim-stats (but for
    the execution shape) equal between them, the mesh sweep one 2x2
    batch and one build."""
    rcs, manifests = {}, {}
    for name, p in run["procs"].items():
        rcs[name] = p["proc"].wait()
        path = os.path.join(p["out"], "sweep-manifest.json")
        if os.path.exists(path):
            with open(path) as f:
                manifests[name] = json.load(f)
    differing = []
    m = manifests.get("mesh") or {}
    for seed in range(MESH_SWEEP_SEEDS):
        got = {}
        for name, p in run["procs"].items():
            path = os.path.join(p["out"], "jobs", f"tg-s{seed}", "sim-stats.json")
            if os.path.exists(path):
                with open(path) as f:
                    got[name] = trajectory_stats(json.load(f))
        if len(got) != 2 or got["mesh"] != got["plain"]:
            differing.append(seed)
    batches = m.get("batches") or []
    ok = (rcs == {"mesh": 0, "plain": 0} and not differing and m.get("mesh") == MESH_CLI_GRID
          and m.get("jobs_done") == MESH_SWEEP_SEEDS and len(batches) == 1
          and batches[0].get("mesh_effective") == MESH_CLI_GRID
          and (m.get("compile_cache") or {}).get("compiles") == 1)
    tail = ""
    if not ok:
        for p in run["procs"].values():
            with open(p["err"]) as f:
                tail += f.read()[-1500:]
    line("mesh_cli_sweep", ok=ok, example="tgen/shadow.yaml", seeds=MESH_SWEEP_SEEDS,
         rcs=rcs, jobs_differing=differing, batches=[{k: b.get(k) for k in (
             "replicas", "mesh_effective", "status")} for b in batches],
         compile_cache=m.get("compile_cache"), wall_s=round(time.perf_counter() - run["t0"], 3),
         stderr_tail=tail)
    run["tmp"].cleanup()
    return ok


def batch_pop_order(host: dict, drop=()) -> dict:
    """pop_order of a stacked ensemble snapshot ([R, H, ...] leaves): its
    queue grids taken as R * H rows."""
    grids = (".queue.time", ".queue.tie", ".queue.kind", ".queue.aux", ".queue.data")
    return pop_order({k: v.reshape((-1,) + v.shape[2:]) if k in grids else v
                      for k, v in host.items()}, drop)


def mesh_phase(hosts: int, end_ns: int, main_final: dict, dev, started: dict
               ) -> "tuple[bool, dict]":
    """9d. mesh: the multi-device planes on MESH_LOGICAL_DEVICES logical
    devices of the one card (see the constants). In the foreground,
    sharded-10240 through TpuScheduler(parallelism=4), equal to the main
    path's final state but for the per-shard diagnostics, at the oracle's
    counters; then what mesh_start started at phase 9: the lossy grid cell
    (mesh_lossy_run, a process of its own) and the mesh's CLI runs. The
    sharded path runs with the kernel's launch count set to 0 just before
    it and read just after. Returns (ok, record)."""
    from shadow_tpu_torch.device import LOGICAL_DEVICES_ENV

    prev = os.environ.get(LOGICAL_DEVICES_ENV)
    os.environ.update(logical_env())
    try:
        ok, record = mesh_sharded(hosts, end_ns, main_final, dev)
    finally:
        if prev is None:
            os.environ.pop(LOGICAL_DEVICES_ENV, None)
        else:
            os.environ[LOGICAL_DEVICES_ENV] = prev
    lossy = mesh_lossy_finish(started["lossy"])
    ok_clis = all([finish(r, started["ref"]) for r, finish in started["clis"]])
    record["launches"].update(lossy.get("launches", {}))
    record["walls"].update(lossy.get("walls", {}))
    return ok and lossy.get("ok", False) and ok_clis, record


def mesh_sharded(hosts: int, end_ns: int, main_final: dict, dev) -> "tuple[bool, dict]":
    """sharded-10240: the bench world's hosts over MESH_SHARDS logical
    devices (all_to_all, the auto bucket) to end_ns, against the main
    path's final state and the oracle's counters."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.runtime.scheduler import TpuScheduler

    cfg, model, tables, st0 = bench_world(hosts, dev)
    scfg = dataclasses.replace(cfg, exchange="all_to_all", a2a_capacity=0)
    sched = TpuScheduler(model, tables, scfg, parallelism=MESH_SHARDS, rounds_per_chunk=16,
                         device=dev)
    cell = f"sharded-{hosts}"
    sync(dev)
    mk.PUMP_KERNEL.launches = 0
    t0 = time.perf_counter()
    final = sched.run(end_ns, start_state=st0)
    sync(dev)
    wall = round(time.perf_counter() - t0, 3)
    launches = mk.PUMP_KERNEL.launches
    bad = [k for k in host_leaves_equal(main_final, final) if k not in MESH_DROP]
    got = bench_counters(final)
    want = dict(events=BENCH_EVENTS, streams_done=BENCH_STREAMS_DONE, bytes_down=BENCH_BYTES_DOWN)
    full = hosts == BENCH_HOSTS and end_ns == BENCH_END_NS
    ok = (not bad and sched.num_devices == MESH_SHARDS and (got == want or not full)
          and (launches > 0 and sched.engine == "megakernel" or dev.type == "cpu"))
    line("mesh_sharded", ok=ok, cell=cell, shards=sched.num_devices,
         logical_devices=[d.id for d in sched.devices], engine=sched.engine,
         a2a_capacity=sched._runner.cfg.a2a_capacity, counters=got,
         pinned=want if full else None, mismatched_leaves=bad, wall_s=wall,
         kernel_launches=launches, sim_s_per_wall_s=end_ns / 1e9 / wall)
    return ok, {"launches": {cell: launches}, "walls": {cell: wall}}


def mesh_start(hosts: int, dev, ref: dict) -> dict:
    """Start, at phase 9, what the mesh phase ends: the lossy grid cell in
    a process of its own (this script with `--mesh-lossy`) and the mesh's
    CLI runs (mesh_cli_runs, held against `ref`, the `run --replicas 2`
    stats background_clis kept)."""
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "mesh_lossy.json")
    cmd = [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--mesh-lossy", out]
    if dev.type == "cpu":
        cmd += ["--rehearse-cpu", "--hosts", str(hosts)]
    err_path = os.path.join(tmp.name, "stdout.txt")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=err, stderr=subprocess.STDOUT,
                                env=dict(os.environ, OMP_NUM_THREADS="1", **logical_env()))
    STARTED.append(proc)
    lossy = dict(proc=proc, out=out, stderr=err_path, tmp=tmp, t0=time.perf_counter())
    return dict(lossy=lossy, clis=mesh_cli_runs(dev), ref=ref)


def mesh_lossy_finish(run) -> dict:
    """Wait for the lossy grid cell's process: print its lines and return
    its record ({"ok": False} with a failing line if it failed)."""
    rc = run["proc"].wait()
    record = {"ok": False}
    if rc == 0 and os.path.exists(run["out"]):
        with open(run["out"]) as f:
            record = json.load(f)
        for text in record.pop("lines"):
            print(text, flush=True)
    if not record.get("ok"):
        with open(run["stderr"]) as f:
            line("mesh_lossy_process", ok=False, rc=rc, stdout_tail=f.read()[-3000:])
    line("mesh_lossy_wall", wall_s=round(time.perf_counter() - run["t0"], 3))
    run["tmp"].cleanup()
    return record


def mesh_lossy_run(hosts: int, dev, out_path: str) -> int:
    """mesh-2x4-lossy-10240x2 in a process of its own: the lossy world x
    MESH_REPLICAS on the MESH_GRID grid with the segment exchange's ring
    to MESH_END_NS, plain, under a device loss of MESH_LOSS_DEVICE at
    launch MESH_LOSS_AT (degraded to 2x2), and interrupted at
    MESH_INTERRUPT_NS then resumed on MESH_RESUME_GRID; each replica
    equal, in pop order and but for the per-shard diagnostics, to the
    same batch through run_ensemble_until (held against the JAX package
    by the tests). Each run with the launch count set to 0 just before it
    and read just after. Writes {ok, launches, walls, lines} to
    out_path."""
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.ensemble import init_ensemble_state, run_ensemble_until
    from shadow_tpu_torch.engine.mesh import MeshPlan
    from shadow_tpu_torch.engine.round import RunInterrupted
    from shadow_tpu_torch.engine.state import state_to_host
    from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill
    from shadow_tpu_torch.runtime import chaos
    from shadow_tpu_torch.runtime.checkpoint import (
        CheckpointManager,
        InterruptGuard,
        load_checkpoint,
        reshard_note,
    )
    from shadow_tpu_torch.runtime.mesh import MeshRunner
    from shadow_tpu_torch.runtime.recovery import RecoveryPolicy

    on_card = dev.type == "cuda"
    record = {"ok": False, "launches": {}, "walls": {}}

    def timed(name, fn):
        sync(dev)
        mk.PUMP_KERNEL.launches = 0
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            sync(dev)
            record["walls"][name] = round(time.perf_counter() - t0, 3)
            record["launches"][name] = mk.PUMP_KERNEL.launches

    def check():
        lcfg, lmodel, ltables, _ = lossy_world(hosts, dev)
        lcfg = dataclasses.replace(lcfg, exchange="segment")
        bw = bw_bits_per_sec_to_refill(20_000_000)
        r, (rows, shards) = MESH_REPLICAS, MESH_GRID
        cell = f"mesh-{rows}x{shards}-lossy-{hosts}x{r}"
        ens0 = init_ensemble_state(lcfg, lmodel, r, 1, bw, bw, device=dev)
        ref = timed("ensemble-reference", lambda: batch_pop_order(state_to_host(
            run_ensemble_until(ens0, MESH_END_NS, lmodel, ltables, lcfg,
                               rounds_per_chunk=MESH_RPC)), MESH_DROP))

        def runner(grid):
            return MeshRunner(lmodel, ltables, lcfg, MeshPlan(r, grid[1], grid[0]),
                              seed_stride=1, rounds_per_chunk=MESH_RPC,
                              tx_bytes_per_interval=bw, rx_bytes_per_interval=bw, device=dev)

        def differ(out):
            return snapshots_differ(ref, batch_pop_order(state_to_host(out), MESH_DROP))

        plain = runner(MESH_GRID)
        bad = differ(timed(cell, lambda: plain.run(MESH_END_NS, start_state=ens0)))
        ok = not bad and (record["launches"][cell] > 0 or not on_card)
        line("mesh_grid", ok=ok, cell=cell, grid=f"{rows}x{shards}", engine=plain.engine,
             exchange=plain.cfg.exchange, mismatched_leaves_vs_ensemble=bad,
             wall_s=record["walls"][cell], ensemble_wall_s=record["walls"]["ensemble-reference"],
             kernel_launches=record["launches"][cell],
             ensemble_launches=record["launches"]["ensemble-reference"],
             logical_devices=list(plain._get_mesh().ids))
        if not ok:
            return False

        lossy = runner(MESH_GRID)
        fault = chaos.FaultPlan(seed=0, faults=[{"kind": "device-loss", "at": MESH_LOSS_AT,
                                                 "target": str(MESH_LOSS_DEVICE)}])
        name = f"{cell}-device-loss"
        with chaos.installed(fault):
            out = timed(name, lambda: lossy.run(MESH_END_NS, start_state=ens0,
                                                recovery=RecoveryPolicy(max_recoveries=2)))
        bad = differ(out)
        del out
        grid_ids = list(lossy._get_mesh().ids)
        degraded = f"{lossy.plan.rows}x{lossy.plan.shards}"
        ok = (not bad and degraded == "2x2" and len(lossy.mesh_degradations) == 1
              and lossy.mesh_degradations[0].get("device") == MESH_LOSS_DEVICE
              and MESH_LOSS_DEVICE not in grid_ids
              and [x["kind"] for x in lossy.recovery_report] == ["device-loss"]
              and (record["launches"][name] > 0 or not on_card))
        line("mesh_device_loss", ok=ok, cell=cell, degraded_to=degraded,
             degradations=lossy.mesh_degradations, recovery=lossy.recovery_report,
             logical_devices=grid_ids, fired=fault.report().get("fired"),
             mismatched_leaves_vs_ensemble=bad, wall_s=record["walls"][name],
             kernel_launches=record["launches"][name])
        if not ok:
            return False

        ckpt_dir = tempfile.TemporaryDirectory()
        grid_from = f"{rows}x{shards}"
        grid_to = f"{MESH_RESUME_GRID[0]}x{MESH_RESUME_GRID[1]}"
        first = runner(MESH_GRID)
        ckpt = CheckpointManager(ckpt_dir.name, 0, "mesh-smoke", layout=grid_from)
        interrupted = False
        try:
            timed(f"{cell}-interrupted", lambda: first.run(
                MESH_END_NS, start_state=ens0, checkpoints=ckpt,
                guard=InterruptGuard(MESH_INTERRUPT_NS)))
        except RunInterrupted:
            interrupted = True
        path = CheckpointManager.latest_path(ckpt_dir.name)
        second = runner(MESH_RESUME_GRID)
        bad, note, meta = ["no checkpoint"], "", {}
        resumed = f"{cell}-resumed-{grid_to}"
        if path is not None:
            start, meta = load_checkpoint(path, second.initial_state(), "mesh-smoke",
                                          layout=grid_to)
            note = reshard_note(meta.get("mesh"), grid_to)
            bad = differ(timed(resumed, lambda: second.run(MESH_END_NS, start_state=start)))
        ckpt_dir.cleanup()
        launches = record["launches"].get(resumed, 0)
        ok = (interrupted and not bad and note == f", resharding {grid_from} -> {grid_to}"
              and 0 < meta.get("now_ns", 0) < MESH_END_NS and (launches > 0 or not on_card))
        line("mesh_resharded", ok=ok, cell=cell, interrupted=interrupted,
             checkpoint_now_ns=meta.get("now_ns"), saved_grid=meta.get("mesh"),
             resumed_on=grid_to, log_note=note, mismatched_leaves_vs_ensemble=bad,
             walls=record["walls"], kernel_launches=launches)
        return ok

    record["ok"] = check()
    record["lines"] = PRINTED
    with open(out_path, "w") as f:
        json.dump(record, f)
    return 0 if record["ok"] else 1


def main(argv=None) -> int:
    try:
        return run_phases(argv)
    finally:
        for proc in STARTED:
            if proc.poll() is None:
                if getattr(proc, "own_session", False):
                    # with the processes it started (serve daemons)
                    os.killpg(proc.pid, 9)
                else:
                    proc.kill()
                proc.wait()


def run_phases(argv=None) -> int:
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
    ap.add_argument(
        "--onion-plain", metavar="OUT",
        help="only run the onion cell's plain-engine run and write its "
        "counters to OUT (the smoke starts this in a process of its own)",
    )
    ap.add_argument(
        "--services-daemon", metavar="OUT",
        help="only run the services cell's daemon part (serve daemons killed, "
        "restarted, warm over HTTP, their cache corrupted) and write its record "
        "to OUT (the smoke starts this in a process of its own)",
    )
    ap.add_argument(
        "--mesh-lossy", metavar="OUT",
        help="only run the mesh phase's lossy grid cell (plain, under a device "
        "loss, interrupted and resumed on another grid) and write its record to "
        "OUT (the smoke starts this in a process of its own)",
    )
    ap.add_argument(
        "--onion-shape", metavar="OUT",
        help="only run onion_r2s2's main path (the shapes phase's onion cell) "
        "and write its record and states beside OUT (the smoke starts this "
        "in a process of its own)",
    )
    ap.add_argument(
        "--cpu-ref", metavar="OUT",
        help="only hold the cpu-ref oracles against the engine on the "
        "reference tests' small worlds and write the records to OUT (the "
        "smoke starts this in a process of its own)",
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

    if args.onion_plain:
        dev = torch.device("cpu") if args.rehearse_cpu else torch.device("cuda", 0)
        return onion_plain_run(args.hosts, ONION_END_NS, dev, args.onion_plain)
    if args.onion_shape:
        return onion_shape_run(
            args.hosts, torch.device("cpu") if args.rehearse_cpu else torch.device("cuda", 0),
            args.onion_shape)
    if args.cpu_ref:
        return cpu_ref_run(torch.device("cpu") if args.rehearse_cpu else torch.device("cuda", 0),
                           args.cpu_ref)
    if args.mesh_lossy:
        return mesh_lossy_run(
            args.hosts, torch.device("cpu") if args.rehearse_cpu else torch.device("cuda", 0),
            args.mesh_lossy)
    if args.services_daemon:
        return services_daemon_run(
            torch.device("cpu") if args.rehearse_cpu else torch.device("cuda", 0),
            args.services_daemon)
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

        # 2. build: the default shape's library here, the shapes phase's
        # libraries in threads beside it and phase 3
        shape_builds = shape_builds_start()
        t0 = time.perf_counter()
        mk.PUMP_KERNEL.library()
        build_log = mk.PUMP_KERNEL.build_log[mk.TCP_SHAPE]
        resources = ptxas_resources(build_log)
        ptxas = [ln.strip() for ln in build_log.splitlines()
                 if "registers" in ln or "spill" in ln or "stack frame" in ln]
        line("build", seconds=round(time.perf_counter() - t0, 3),
             nvcc_seconds=mk.PUMP_KERNEL.build_seconds.get(mk.TCP_SHAPE), ptxas=ptxas,
             instances=resources)

    # 3. kernel vs twin at full width, in the burst
    cfg, model, tables, st0 = bench_world(args.hosts, dev)
    stage_cfg = mk.resolve_stage_cfg(cfg)
    plain = dataclasses.replace(cfg, engine="plain")
    t0 = time.perf_counter()
    st_b = run_until(st0, BURST_NS, model, tables, plain)
    sync(dev)
    advance_s = time.perf_counter() - t0

    def window(st):
        return _next_window_end(st, args.end_ns, cfg, equeue.next_time(st.queue).amin(), tables)

    def compare(st, we, scfg, m=model, t=tables):
        return compare_stage(st, we, m, t, scfg)

    we = window(st_b)
    launches0 = mk.PUMP_KERNEL.launches
    ok3, facts, (twin, steps) = compare(st_b, we, stage_cfg)
    tallies = {"steps": steps, "live_rows": facts["live_rows"]}
    ok3 = ok3 and all(facts["classes"][k] > 0 for k in ("p1", "p2", "p3"))
    max_abs_err = facts["max_abs_err"]
    line("kernel_vs_twin", ok=ok3, **facts, advance_s=round(advance_s, 3))
    if not ok3:
        return 1

    # the kernel alone at four launches of the bench world, each also held
    # against the twin; then kernel vs twin where the kernel meets its
    # edges. Each runs in a function, so that its states are freed when it
    # returns and the main path's memory peak (phase 4) is its own.
    reps = 20

    def timed_launches():
        """(ok, the kernel's time at each launch, largest error)."""
        st_m = run_until(st_b, MID_NS, model, tables, plain)
        st_r = run_until(st_m, REJECTS_NS, model, tables, plain)
        timed = {
            "burst_k8": (st_b, we, stage_cfg),
            "burst_k16": (st_b, we, dataclasses.replace(stage_cfg, pump_k=16)),
            "mid_20ms_k8": (st_m, window(st_m), stage_cfg),
            "rejects_30ms_k8": (st_r, window(st_r), stage_cfg),
        }
        launch_ms, err = {}, 0.0
        for name, (st_l, we_l, scfg) in timed.items():
            if name != "burst_k8":
                ok_l, facts_l, _ = compare(st_l, we_l, scfg)
                err = max(err, facts_l["max_abs_err"])
                line("kernel_vs_twin", ok=ok_l, launch=name, **facts_l)
                if not ok_l:
                    return False, launch_ms, err
            if dev.type == "cuda":
                launch_ms[name] = kernel_device_ms(st_l, we_l, model, tables, scfg, reps)
            else:
                launch_ms[name] = timed_ms(
                    lambda s, w=we_l, c=scfg: mk.megakernel_stage(s, w, model, tables, c),
                    reps, st_l.clone, dev)
        return True, launch_ms, err

    def edge_cases():
        """Kernel vs twin on rows that start full, rows with more slots
        below the window end than the kernel stages, and a last warp that
        owns fewer rows than the others: (ok, largest error)."""
        edge = {
            "queue_8_full": (rebuilt_queue(st_b, SMALL_QUEUE, int(we)), we, model, tables),
            "queue_1100_over_stage": (
                rebuilt_queue(st_b, LARGE_QUEUE, int(we), extra=LARGE_QUEUE_EXTRA, seed=3),
                we, model, tables),
        }
        rcfg, rmodel, rtables, r0 = bench_world(args.hosts - RAGGED_SHORT, dev)
        st_rg = run_until(r0, BURST_NS, rmodel, rtables,
                          dataclasses.replace(rcfg, engine="plain"))
        edge["ragged_hosts"] = (st_rg, _next_window_end(
            st_rg, args.end_ns, rcfg, equeue.next_time(st_rg.queue).amin(), rtables),
            rmodel, rtables)
        err = 0.0
        for name, (st_e, we_e, m_e, t_e) in edge.items():
            q = st_e.queue
            below = (q.time < we_e).sum(dim=1)
            reached = dict(
                hosts=int(q.time.shape[0]), queue_capacity=int(q.time.shape[1]),
                full_rows=int((q.count == q.time.shape[1]).sum()),
                rows_over_stage=int((below > mk.STAGE).sum()),
                rows_in_last_warp=int(q.time.shape[0] % mk.ROWS_PER_WARP),
            )
            ok_e, facts_e, _ = compare(st_e, we_e, stage_cfg, m_e, t_e)
            err = max(err, facts_e["max_abs_err"])
            hit = {"queue_8_full": reached["full_rows"] > 0,
                   "queue_1100_over_stage": reached["rows_over_stage"] > 0,
                   "ragged_hosts": reached["rows_in_last_warp"] > 0}[name]
            line("kernel_vs_twin_edge", ok=ok_e and hit, case=name, **reached, **facts_e)
            if not (ok_e and hit):
                return False, err
        return True, err

    ok_t, launch_ms, err = timed_launches()
    max_abs_err = max(max_abs_err, err)
    if not ok_t:
        return 1
    ms_k = launch_ms["burst_k8"]
    ms_t = timed_ms(lambda s: pump_stage(s, we, model, tables, stage_cfg), 5, st_b.clone, dev)
    bound_ms, bound_by, reck = pump_bound(st_b, we, model, tables, stage_cfg, tallies, twin)
    line("kernel_time", kernel_ms=ms_k, twin_ms=ms_t, bound_ms=bound_ms, bound_by=bound_by,
         share_of_bound=bound_ms / ms_k, reckoning=reck, reps=reps, launch_ms=launch_ms,
         rows_per_warp=mk.ROWS_PER_WARP, stage=mk.STAGE)
    del twin
    # one shard's rows of the burst (the mesh phase's sharded cell runs the
    # kernel on such rows), held against the twin and timed
    ok_sh, shard_launch, err = shard_stage(st_b, we, model, tables, stage_cfg, reps, dev)
    max_abs_err = max(max_abs_err, err)
    if not ok_sh:
        return 1
    ok_e, err = edge_cases()
    max_abs_err = max(max_abs_err, err)
    if not ok_e:
        return 1
    shape_resources = {}
    if dev.type == "cuda":
        ok_b, shape_resources = shape_builds_finish(shape_builds)
        if not ok_b:
            return 1

    # 3a. wide_kernel: the wide instances (pump_k past MAX_K, onion past 32
    # sockets), each held against the twin and timed, and their main paths;
    # every CLI run and the onion cell's plain-engine run meanwhile
    onion_plain, managed_cli, services_daemon, phold_replicas = {}, {}, {}, {}
    managed_tmp = tempfile.TemporaryDirectory()

    def meanwhile():
        plain_run = onion_plain_start(args.hosts, ONION_END_NS, dev)
        clis = background_clis(dev, phold_replicas)
        managed = managed_start(dev, managed_tmp.name)

        def finish():
            ok_clis = clis()
            got = onion_plain_finish(plain_run)
            onion_plain.update(got or {})
            # judged in the managed and services phases, which print what
            # differs
            managed_cli.update(started=managed, cli=managed_http_finish(managed["cli"]))
            return ok_clis and got is not None
        return finish

    t0 = time.perf_counter()
    ok_w, wide, err_w = wide_kernel_phase(st_b, we, cfg, model, tables, args.hosts, dev,
                                          meanwhile=meanwhile)
    line("wide_kernel", ok=ok_w, seconds=round(time.perf_counter() - t0, 3),
         instances={k: dict(v) for k, v in wide.items()})
    if not ok_w:
        return 1
    mk.PUMP_KERNEL.launches = launches0  # comparison launches do not count
    del st_b

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
        sync(dev)
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
    # freed before the peak is reset, so the peak is the main path's; the
    # line also gives what was still allocated when it started: the
    # initial state and the tables)
    eng = effective_engine(dataclasses.replace(cfg, engine="auto"), dev)
    counters = {}
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated() if dev.type == "cuda" else None
    mk.PUMP_KERNEL.launches = 0
    t0 = time.perf_counter()
    final = run_until(st0, args.end_ns, model, tables, cfg, rounds_per_chunk=16,
                      counters=counters)
    sync(dev)
    wall = time.perf_counter() - t0
    main_launches = mk.PUMP_KERNEL.launches
    got = bench_counters(final)
    want = dict(events=BENCH_EVENTS, streams_done=BENCH_STREAMS_DONE, bytes_down=BENCH_BYTES_DOWN)
    ok4 = (eng == "megakernel" and main_launches > 0) or dev.type == "cpu"
    ok4 = ok4 and (got == want or not full)
    line("main_path", ok=ok4, engine=eng, counters=got, pinned=want if full else None,
         wall_s=round(wall, 3), sim_s_per_wall_s=args.end_ns / 1e9 / wall,
         kernel_launches=main_launches, iters=counters.get("iters"),
         allocated_at_start=allocated_at_start,
         max_memory_allocated=torch.cuda.max_memory_allocated() if dev.type == "cuda" else None)
    if not ok4:
        return 1
    from shadow_tpu_torch.engine.state import state_to_host

    main_final = state_to_host(final)  # the recovery phase ends here
    main_wall = wall
    del final

    # 5. engines agree on the card
    short = min(100_000_000, args.end_ns)
    hs, walls = {}, {}
    for eng_name in ("plain", "megakernel"):
        sync(dev)
        t0 = time.perf_counter()
        out = run_until(st0, short, model, tables, dataclasses.replace(cfg, engine=eng_name),
                        rounds_per_chunk=16)
        sync(dev)
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

    # 5a. recovery and checkpoint/resume on the main path's world
    ok_r, recovery_launches = recovery_phase(args.hosts, args.end_ns, main_final, dev)
    if not ok_r:
        return 1
    ok_c, checkpoint_launches = checkpoint_phase(args.hosts, args.end_ns, dev)
    if not ok_c:
        return 1
    # 6. observability-10240: the main path with the tracker, the flight
    # recorder and a profiler capture attached
    ok_o, observability_launches = observability_phase((cfg, model, tables, st0), args.end_ns,
                                                       main_final, main_wall, dev)
    if not ok_o:
        return 1
    # 6a. guards-10240: the main path under chaos faults and the watchdog,
    # down the engine ladder, and at an autotuned rounds_per_chunk
    ok_g, guards_launches = guards_phase((cfg, model, tables, st0), args.end_ns, main_final,
                                         main_launches, main_wall, dev)
    if not ok_g:
        return 1

    # 7. the onion cell through its kernel instance, at full width
    launches_by_model = {"tgen": main_launches}
    ok8, onion_entry, err = onion_phase(args.hosts, ONION_END_NS, onion_plain, dev)
    if not ok8:
        return 1
    launches_by_model["onion"] = onion_entry.pop("launches")
    max_err = {"tgen": max_abs_err, "onion": err}

    # 8. the models without a pump kernel, card against CPU; phold at
    # full width
    if not models_phase(dev, args.hosts):
        return 1

    # the mesh phase's lossy grid cell and CLI runs go on in processes of
    # their own from here to the mesh phase (9d), the services' daemon
    # part to the services phase (9c): started here, not beside the wide
    # onion runs, whose phase the background runs already bound
    mesh_started = mesh_start(args.hosts, dev, phold_replicas)
    daemon = services_daemon_start(dev)
    onion_shape = onion_shape_start(args.hosts, dev)

    # 9. the ensemble plane: tgen and onion replicas through the kernel,
    # a ragged batch
    ok9, ens_tgen, err = ensemble_tgen_phase(args.hosts, ENS_TGEN_END_NS, dev)
    max_err["tgen"] = max(max_err["tgen"], err)
    if not ok9:
        return 1
    ok9, err = ensemble_ragged_phase(args.hosts - RAGGED_SHORT, dev)
    max_err["tgen"] = max(max_err["tgen"], err)
    if not ok9:
        return 1
    ok9, ens_onion, err = ensemble_onion_phase(args.hosts, ENS_ONION_END_NS, dev)
    max_err["onion"] = max(max_err["onion"], err)
    if not ok9:
        return 1

    # 9a. planes-10240: the segment exchange, compaction and dynamic
    # runahead through the kernel, against the main path and the twin
    ok_p, planes = planes_phase(args.hosts, args.end_ns, main_final, dev)
    main_final_mesh = main_final  # the mesh phase's sharded cell is held against it
    del main_final
    max_err["tgen"] = max(max_err["tgen"], planes["max_abs_err"])
    if not ok_p:
        return 1

    # 9b. managed: examples/http three ways and under a worker kill, and
    # the 1,024-guest http matrix through the parallel hybrid
    t0 = time.perf_counter()
    ok_m = managed_phase(dev, args.hosts, full, managed_cli["started"], managed_cli["cli"])
    managed_tmp.cleanup()
    line("managed", ok=ok_m, seconds=round(time.perf_counter() - t0, 3))
    if not ok_m:
        return 1

    # 9c. services: the full-width sweep with a preemption, and the
    # daemon part that ran in a process of its own since phase 9
    t0 = time.perf_counter()
    services_daemon.update(services_daemon_finish(daemon))
    ok_s, services_launches = services_phase(args.hosts, dev, services_daemon)
    line("services", ok=ok_s, seconds=round(time.perf_counter() - t0, 3),
         daemon_wall_s=services_daemon.get("wall_s"))
    if not ok_s:
        return 1

    # 9d. mesh: the sharded engine and the 2-D mesh on logical devices of
    # the card, a device loss and a resume on another grid
    t0 = time.perf_counter()
    ok_mesh, mesh = mesh_phase(args.hosts, args.end_ns, main_final_mesh, dev, mesh_started)
    del main_final_mesh
    line("mesh", ok=ok_mesh, seconds=round(time.perf_counter() - t0, 3),
         launches=mesh["launches"], walls=mesh["walls"])
    if not ok_mesh:
        return 1

    # 9e. shapes: tgen_ooo8 through the front door and the kernel at
    # (8, 8), its plain run, kernel vs twin; onion_r2s2's run at (2, 2)
    # in a process of its own since phase 9, kernel vs twin on its states
    t0 = time.perf_counter()
    ok_sh, shapes, err_sh = shapes_phase(args.hosts, dev, onion_shape)
    line("shapes", ok=ok_sh, seconds=round(time.perf_counter() - t0, 3),
         instances={k: {n: v for n, v in e.items() if not isinstance(v, dict)}
                    for k, e in shapes.items()})
    if not ok_sh:
        return 1

    if dev.type == "cpu":
        line("rehearsal_done", note="no result: the kernel runs only on the card")
        return 3

    # 10. the kernels line (the kernel once per template instance: its
    # launches on its main path, its burst launch's times and bound, its
    # ptxas resources), the card line, and the result
    # the narrow instances' R = 1 launches of this run beside the earlier record
    line("r1_launches", this_run_ms=dict(launch_ms, onion_burst=onion_entry["ms"]),
         earlier_ms=EARLIER_LAUNCH_MS, card=smi, ptxas={m: resources[m] for m in ("tgen", "onion")})
    # the wide instances' launches of this run beside the record from
    # before their redesign, with their static and dynamic shared memory
    by_c = wide["onion_wide"]["by_circuits_per_relay"]
    line("wide_launches", this_run_ms={
        "tgen_wide_burst_k40": wide["tgen_wide"]["ms"],
        **{f"onion_wide_{c['sockets']}_sockets": c["ms"] for c in by_c.values()}},
         earlier_ms=EARLIER_WIDE_LAUNCH_MS, card=smi,
         ptxas={m: resources[m] for m in ("tgen_wide", "onion_wide")},
         dynamic_smem_bytes={"tgen_wide_burst_k40": wide["tgen_wide"]["dynamic_smem_bytes"],
                             **{f"onion_wide_{c['sockets']}_sockets": c["dynamic_smem_bytes"]
                                for c in by_c.values()}})
    timing = {"tgen": dict(ms=ms_k, plain_ms=ms_t, bound_ms=bound_ms, bound_by=bound_by),
              "onion": onion_entry}
    for m in ("tgen_wide", "onion_wide"):
        timing[m] = {k: v for k, v in wide[m].items() if k != "launches"}
        launches_by_model[m] = wide[m]["launches"]
        max_err[m] = err_w
    # the phases that launched each instance over replica batches (R > 1),
    # with that phase's launches on its main path and its timed launch
    ensemble = {"tgen": [ens_tgen["phase"], f"ensemble-ragged-{args.hosts - RAGGED_SHORT}x"
                         f"{ENS_RAGGED_REPLICAS}", f"recovery-ensemble-{args.hosts}x"
                         f"{RECOVERY_ENS_REPLICAS}", f"planes-ragged-{args.hosts - RAGGED_SHORT}x"
                         f"{ENS_RAGGED_REPLICAS}"],
                "onion": [ens_onion["phase"]], "tgen_wide": [], "onion_wide": []}
    ens_launch = {"tgen": ens_tgen, "onion": ens_onion, "tgen_wide": None, "onion_wide": None}
    # launches on the paths of this slice's phases, besides the main path's
    more = {"tgen": {"recovery": recovery_launches, "checkpoint": checkpoint_launches,
                     "observability": observability_launches, "guards": guards_launches,
                     **planes["launches"], "services": services_launches,
                     **{f"mesh:{k}": v for k, v in mesh["launches"].items()}}}
    # the instance on mesh shards: the launches of the sharded and grid
    # cells, one shard's burst launch timed with its bound
    mesh_shards = {"tgen": dict(launches=mesh["launches"], **shard_launch)}
    # the launches planes-10240 timed: on compacted sub-states and with
    # dyn_runahead set
    planes_timed = {"tgen": planes["timed"]}
    # the instances at the shapes phase's TCP shapes: their main paths'
    # launches, their timed launches, their libraries' ptxas resources
    for m, e in shapes.items():
        launches_by_model[m] = e["launches"]
        timing[m] = {k: v for k, v in e.items() if k != "launches"}
        max_err[m] = err_sh
        resources[m] = shape_resources[m]
        ensemble[m], ens_launch[m] = [], None
    print(json.dumps({"kernels": [{
        "name": f"pump_megakernel[{m}]",
        "route": "cuda",
        "source": "shadow_tpu_torch/csrc/pump_megakernel.cu",
        "replaces": "shadow_tpu/engine/megakernel.py:211",
        "launches": launches_by_model[m],
        "max_abs_err": max_err[m],
        **timing[m],
        "library_ms": None,
        **resources[m],
        "launched_with_replicas_by": ensemble[m],
        "ensemble": ens_launch[m],
        "launches_on_other_paths": more.get(m, {}),
        "planes": planes_timed.get(m, {}),
        "mesh_shards": mesh_shards.get(m, {}),
    } for m in (*mk.INSTANCES, *shapes)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
