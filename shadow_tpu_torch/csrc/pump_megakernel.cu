// Pump megakernel for Hopper (sm_90a): `pump_k` packet-pump microsteps
// per host row in one launch, followed by the row's carry landing.
//
// Replaces the TPU kernel shadow_tpu/engine/megakernel.py::_launch (the
// package's one pl.pallas_call), whose body is
// shadow_tpu/engine/pump.py::pump_microstep. The plain PyTorch twin of
// this file is shadow_tpu_torch/engine/pump.py::pump_stage; every
// statement of the microstep has its counterpart there, and the two are
// held leaf-equal on the card (chip_smoke.py) and on the CPU through the
// JAX reference (tests/test_torch_megakernel.py, test_torch_onion.py).
//
// Models. The microstep consults its model twice: the veto
// (pump_spec.block) and the passive bookkeeping (pump_spec.apply). The
// kernel is a template on the model, one instance for each model with a
// pump_spec (tgen, onion), so an instance carries only its own rules and
// its shared memory is sized for its model's sockets per row.
//
// What bounds it: memory. A microstep does a few hundred integer
// operations per live host against a few KB of row state, so the least
// time is the bytes the live rows must move over the card's memory rate
// (3.35 TB/s on an H100 SXM). The largest part is the [H, Q] queue's
// `time` row of each live row (Q x 8 B), then the selected slots and the
// [S] flow-table row. In practice the kernel is bound by latency: chains
// of dependent loads and integer work per event, one row per lane. The
// design reads the queue once, coalesced, batches the gathers of a warp's
// rows, and keeps a microstep's working set out of local memory.
//
// Design. A block is one warp and owns ROWS_PER_WARP consecutive host
// rows; lane l < ROWS_PER_WARP runs row l's microsteps, and the whole
// warp does the row's queue work.
// A. Selection, once per launch per live row (count > 0, head < window
//    end). Within a launch the kernel only pops a row's queue (pushes wait
//    for the landing, C), and each pop takes the minimum by (time, tie)
//    with the lowest slot winning a tie (equeue.peek_min). So the queue
//    events a launch can take are the row's first pump_k entries in
//    (time, tie, slot) order. The warp streams each live row's `time` row
//    through shared memory in pieces (cp.async, several pieces in flight,
//    32 lanes x 8 B per copy; a lane then reads two slots at a time) and,
//    in that one pass, stages the slots
//    below the window end (STAGE of them, in slot order), the least time
//    at or past it, and the row's first free columns. Then, for all rows
//    at once, it gathers the staged slots' ties and ranks the staged
//    entries by (time, tie, slot), a lane per entry across the rows:
//    ranks below pump_k form the row's list,
//    and the time after the list is the head once the list is popped. A
//    row with more slots below the window end than STAGE takes its list
//    from pump_k + 1 rounds of a warp-wide minimum over its device-memory
//    row instead, so no queue capacity is out of reach.
// B. The microsteps, per lane, statement for statement the reference's
//    microstep; the queue candidate is list entry `qi`, whose payload
//    (kind, aux, data) is staged in shared memory. Only the head's payload
//    is staged before the first microstep: a row that rejects its head
//    stops there, and the warp stages the rest of the lists only for rows
//    that took their head. A pop writes the two key slots; count and head
//    are written once at the end. The defer FIFO, and the socket-matching
//    fields of each row's S sockets (kept up to date), live in shared
//    memory; the per-event range sets and segment lanes are register
//    arrays, sized at compile time for TCP's one shape (NR, NSEG) and
//    indexed only by unrolled loops.
// C. The landing, per lane: leftover defers go to the row's free columns
//    after the pops in column order (the free columns found in A merged
//    with the popped slots), with overflow counted as push_self_lanes
//    counts it.
//
// Wide instances. The design above holds a row's list (pump_k <= MAX_K
// entries), its defer FIFO and its sockets' matching fields (S <= the
// instance's *_MAX_S, one bit each in a 32-bit match mask) in shared
// memory sized at compile time. A launch past either limit runs the wide
// instance of its model (template flag WIDE), chosen by the wrapper. Its
// lists, staged keys, payloads, defer FIFO, free columns and socket-match
// bits live in dynamic shared memory sized at launch (WideLayout) from
// C = min(pump_k, WIDE_LIST_CAP) list entries and F = min(pump_k,
// WIDE_FIFO_CAP) FIFO entries per row:
//  - selection is A's one streamed read, for all the rows that need a
//    list at once: it stages up to SC slots below the window end per
//    row, ranks them and lists the first min(C, the row's remaining
//    pump_k). A row with more slots below the window end than the stage
//    holds keeps, whenever its stage fills, the best list length + 1
//    entries (ranked with their ties) and from then on stages only slots
//    no later than the last of them, so one read still finds the row's
//    first entries. pump_k past C takes the list in passes: a row that
//    has popped its pass while its next head is below the window end
//    takes the next pass by another such read (popped slots read
//    TIME_MAX in device memory, so it stages only what is left);
//  - sockets: at the top of each microstep the going rows' event 4-tuples
//    go to shared memory and the warp scans the rows' S sockets (8 x S
//    consecutive ints per field) 32 at a time, coalesced, building one
//    match bit per socket with __ballot_sync; each lane then walks its
//    row's bits as the narrow body walks its mask. The scan reads `st`
//    after the last microstep's commit, so a FIN_WAIT_1 write is seen;
//  - the defer FIFO's first F entries per row live in shared memory: with
//    one pass per launch (pump_k <= C) an entry names the list entry
//    whose payload it carries, as in the narrow instance; past C it
//    carries its own payload, since a later pass reuses the list. Entries
//    past F go to a device scratch of pump_k - F entries per row;
//  - the landing takes the free columns recorded in the row's last read,
//    merged with the slots its pass popped; past the last recorded column
//    (only when more defers land than C), it scans device memory from
//    there.
// The per-event body is the narrow instance's; each difference is an
// `if constexpr (WIDE)`, so the narrow instances compile as before.
//
// Replicas. An ensemble of R worlds is one launch over its R x H rows
// (rows_per_replica = H; a single world is R = 1). A row reads its own
// replica's window end, folds into its replica's min_used and flags its
// replica's rejection. A warp's rows may straddle two replicas, so the
// warp-wide work of A compares each row's slots with that row's own
// window end, kept per row in shared memory.
//
// Integer semantics follow jax under x64: i64 floor division (fdiv),
// wrapping u32 counters held in i64, arithmetic shifts on i32 lanes,
// int32 wire lanes built from u32 bit patterns. Floats: the loss
// uniform is bitcast(bits >> 9 | 0x3F800000) - 1.0f, compared with an
// f32 path reliability; no multiply-add is formed.

#include <cstdint>
#include <type_traits>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int64_t TIME_MAX = (int64_t(1) << 62) - 1;
constexpr int64_t I64_MAX = INT64_MAX;
constexpr int64_t MASK32 = 0xFFFFFFFFLL;
constexpr int KIND_PACKET = 0;
constexpr int64_t AUX_SIZE_MASK = (1 << 24) - 1;
constexpr int32_t AUX_SHAPED_BIT = 1 << 24;
constexpr int64_t REFILL_INTERVAL_NS = 1000000;
constexpr int64_t CODEL_TARGET_NS = 10000000;
constexpr int64_t CODEL_INTERVAL_NS = 100000000;
constexpr int64_t MTU_BYTES = 1500;
constexpr int CODEL_TABLE_LEN = 1024;
constexpr int FLAG_FIN = 0x01, FLAG_SYN = 0x02, FLAG_RST = 0x04, FLAG_ACK = 0x10;
constexpr int ST_CLOSED = 0, ST_LISTEN = 1, ST_ESTABLISHED = 4, ST_FINWAIT1 = 5;
constexpr int LANES = 8;  // PAYLOAD_LANES
// The list entries a narrow instance holds (its pump_k limit), and the
// entries of one pass of a wide instance's list.
constexpr int MAX_K = 16;
// The models whose pump rules the kernel carries (a narrow and a wide
// template instance each), and the sockets per host row each narrow
// instance is built for: tgen's 4 (TGEN_TCP) fit 8, as before; onion's
// 1 + 2 x circuits_per_relay (17 at the default) fit 32, the width of a
// row's socket-match bitmask. A wide instance takes any socket count.
constexpr int MODEL_TGEN = 0, MODEL_ONION = 1;
constexpr int TGEN_MAX_S = 8, ONION_MAX_S = 32;
// int64 words of a wide instance's defer-FIFO entry in device scratch:
// time, tie, kind, aux, then the payload's 8 int32 lanes in 4 words
constexpr int FIFO_WORDS = 8;
// TCP's shape, the one shape the kernel is built for: out-of-order ranges
// and segments per flush (TGEN_TCP); the wrapper refuses any other
constexpr int NR = 4, NSEG = 4;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

// Host rows per warp (a block is one warp); 8 beat 16 at mid-run, all-rejected and main-path launches (H100, PERF.md).
constexpr int ROWS_PER_WARP = 8;
// Queue slots below the window end that a row stages in shared memory
// (one per lane); a row with more takes its list from device memory.
constexpr int STAGE = 32;
// `time` slots per piece of a streamed queue row, and pieces in flight.
constexpr int PIECE = 512;
constexpr int PIECES_IN_FLIGHT = 3;
// A wide instance's dynamic shared memory holds the list entries of one
// pass (pump_k past it: more passes), the defer-FIFO entries of a row
// (pump_k past it: the rest in device scratch) and the words of the
// warp's socket-match bits (ROWS_PER_WARP x S, one each; past it: device
// scratch), each taken at min(what the launch needs, this cap).
constexpr int WIDE_LIST_CAP = 64;
constexpr int WIDE_FIFO_CAP = 64;
constexpr int WIDE_MATCH_WORDS = 2048;
// slots a wide row stages per read: room for the list + 1 and more
__host__ __device__ constexpr int wide_stage(int c) {
  return (c + 2 + 15) / 16 * 16 > STAGE ? (c + 2 + 15) / 16 * 16 : STAGE;
}
constexpr int WIDE_MAX_SC = wide_stage(WIDE_LIST_CAP);

template <int MODEL>
__host__ __device__ constexpr int max_sockets() {
  return MODEL == MODEL_ONION ? ONION_MAX_S : TGEN_MAX_S;
}

static_assert(ONION_MAX_S <= 32 && ROWS_PER_WARP <= WARP && STAGE == WARP && STAGE > MAX_K && PIECE % (2 * WARP) == 0,
              "layout");
static_assert(WIDE_MAX_SC <= 255 && WIDE_LIST_CAP <= 127,
              "wide layout: list entries index the stage in a byte");

}  // namespace

extern "C" {

// One field per tensor or scalar; the ctypes Structure in
// engine/megakernel.py declares the same fields in the same order (all
// pointers are void*, all scalars int64, so the layout has no padding).
struct PumpArgs {
  // event queue [H, Q] (+ [H, Q, 8] data) and per-row counters [H]
  void *q_time, *q_tie, *q_kind, *q_data, *q_aux, *q_count, *q_overflow, *q_head;
  // netstack [H]
  void *tx_refill, *tx_tokens, *tx_last, *rx_refill, *rx_tokens, *rx_last;
  void *codel_first_above, *codel_drop_next, *codel_count, *codel_dropping;
  void *rx_backlog, *codel_dropped, *bytes_sent, *bytes_recv;
  // TCP flow table [H, S] (ooo/sacked [H, S, R, 2])
  void *st, *lport, *rport, *rhost, *snd_una, *snd_nxt, *snd_max, *snd_end;
  void *fin_pending, *fin_sent, *peer_wnd, *rcv_nxt, *rcv_fin, *delivered;
  void *ooo, *sacked, *cwnd, *ssthresh, *dupacks, *in_rec, *srtt, *rttvar, *rto;
  void *rtt_pending, *rtt_seq, *rtt_ts, *rto_expire, *backoff, *tev_time;
  void *retransmits, *segs_in, *segs_out;
  // model state [H]: bytes_down is written; the stream counters are read
  // by onion's veto
  void *bytes_down, *streams_started, *streams_done;
  // outbox [H, O] (+ [H, O, 8] data), [H]
  void *ob_valid, *ob_dst, *ob_time, *ob_tie, *ob_data, *ob_aux, *ob_fill, *ob_overflow;
  // per-host counters [H]
  void *seq, *rng_counter, *events_handled, *packets_sent, *packets_dropped;
  void *packets_unroutable;
  // tracker lanes [H] (unused when tracker == 0)
  void *trk_bytes_ctrl, *trk_bytes_data, *trk_retrans;
  // per replica [R]: window_end (i64, read), min_used_lat (i64,
  // atomicMin), rejected flag (i32, set to 1 by any of the replica's
  // rows that the pump could not finish)
  void *window_end, *min_used, *rejected;
  // read-only context
  void *host_id, *rng_key, *host_node, *lat_ns, *rel, *codel_table;
  // a wide instance's scratch (unused by a narrow instance): the defer
  // FIFO entries past WIDE_FIFO_CAP [H, pump_k - WIDE_FIFO_CAP,
  // FIFO_WORDS] i64, and the socket-match words past WIDE_MATCH_WORDS
  // [blocks, ceil(ROWS_PER_WARP * S / 32)] i32; each is empty when
  // shared memory holds it all
  void *fifo, *match;
  // shapes and static parameters; wide: run the model's wide instance
  int64_t H, Q, O, S, R, N, num_global_hosts, pump_k, wide;
  int64_t rows_per_replica;  // H of one world: row h is replica h / rows_per_replica's
  int64_t bootstrap_end_ns;
  int64_t use_netstack, use_sack, tracker, dyn_runahead;
  int64_t model, num_clients, num_servers, req_bytes, num_relays, resp_span;
  int64_t mss, header_bytes, rcv_wnd, rto_min_ns, rto_max_ns, granularity_ns;
  int64_t segs_per_flush, draws_per_event, packet_emits;
};

}  // extern "C"

namespace {

__device__ __forceinline__ int64_t fdiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
// fdiv for a divisor known only at run time: 32-bit division where both
// operands fit (the common case: bytes and byte rates), exact either way
__device__ __forceinline__ int64_t fdiv_rt(int64_t a, int64_t b) {
  if (((a | b) >> 31) == 0) return int64_t(uint32_t(a) / uint32_t(b));
  return fdiv(a, b);
}
__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ int64_t clampi(int64_t x, int64_t lo, int64_t hi) {
  return imin(imax(x, lo), hi);
}

// ---- threefry2x32 (jax's 20 rounds) and the f32 uniform ----
__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}
__device__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t &x0, uint32_t &x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k0, k1, k2};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
}
// uniform_f32(fold_in(key, counter))
__device__ float uniform_draw(uint32_t k0, uint32_t k1, uint32_t counter) {
  uint32_t a = 0, b = counter;  // fold_in: threefry(key, (0, data))
  threefry2x32(k0, k1, a, b);
  uint32_t c = 0, d = 0;  // random_bits: threefry(key', (0, 0)), b0 ^ b1
  threefry2x32(a, b, c, d);
  const uint32_t bits = c ^ d;
  return __int_as_float(int((bits >> 9) | 0x3F800000u)) - 1.0f;
}

__device__ __forceinline__ int64_t unwrap32(int64_t near, int32_t wire) {
  const int64_t wire_u = int64_t(wire) & MASK32;
  const int64_t delta =
      ((wire_u - (near & MASK32) + (int64_t(1) << 31)) & MASK32) - (int64_t(1) << 31);
  return near + delta;
}
__device__ __forceinline__ int32_t to_wire32(int64_t x) {
  return int32_t(uint32_t(x & MASK32));
}

// closed-form token bucket (netstack.tb_depart) for one packet
__device__ void tb_depart(int64_t tokens, int64_t last, int64_t refill, int64_t now,
                          int64_t size, bool charge, int64_t &depart,
                          int64_t &tokens_out, int64_t &last_out) {
  const bool limited = charge && refill > 0;
  const int64_t safe = imax(refill, 1);
  const int64_t cap = refill + MTU_BYTES;
  const int64_t intervals = fdiv(imax(now - last, 0), REFILL_INTERVAL_NS);
  const int64_t cur = imin(cap, tokens + intervals * safe);
  const int64_t cur_last = last + intervals * REFILL_INTERVAL_NS;
  const int64_t deficit = imax(size - cur, 0);
  const int64_t k = fdiv_rt(deficit + safe - 1, safe);
  const int64_t wait_end = cur_last + k * REFILL_INTERVAL_NS;
  depart = limited ? (deficit > 0 ? wait_end : now) : now;
  tokens_out = limited ? cur + k * safe - size : tokens;
  last_out = limited ? (deficit > 0 ? wait_end : cur_last) : last;
}

// [NR, 2] range-set helpers (transport/tcp.py _ooo_absorb / _ooo_insert).
// The sets are register arrays of NR ranges, indexed by unrolled loops
// only.
__device__ __forceinline__ void ooo_absorb(int64_t &rcv, int64_t (&ooo)[NR][2], bool m) {
#pragma unroll
  for (int it = 0; it < NR; ++it) {
    int64_t reach = -1;
    unsigned hit = 0;
#pragma unroll
    for (int r = 0; r < NR; ++r)
      if (m && ooo[r][0] >= 0 && ooo[r][0] <= rcv) {
        hit |= 1u << r;
        reach = imax(reach, ooo[r][1]);
      }
    rcv = imax(rcv, reach);
#pragma unroll
    for (int r = 0; r < NR; ++r)
      if ((hit >> r) & 1u) ooo[r][0] = ooo[r][1] = -1;
  }
}
__device__ __forceinline__ void ooo_insert(int64_t (&ooo)[NR][2], bool m, int64_t s, int64_t e) {
  int64_t ms = int64_t(1) << 60, me = -1;
  unsigned overlap = 0;
  int ins = -1;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const bool empty = ooo[r][0] < 0;
    const bool ov = m && !empty && s <= ooo[r][1] && e >= ooo[r][0];
    if (ov) {
      overlap |= 1u << r;
      ms = imin(ms, ooo[r][0]);
      me = imax(me, ooo[r][1]);
    }
    if ((ov || (empty && m)) && ins < 0) ins = r;
  }
  ms = imin(s, ms);
  me = imax(e, me);
  // the overlapped ranges are cleared, then the merged range lands in the
  // first available one
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if ((overlap >> r) & 1u) ooo[r][0] = ooo[r][1] = -1;
    if (m && r == ins) {
      ooo[r][0] = ms;
      ooo[r][1] = me;
    }
  }
}

// ---- warp primitives ----
__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// i64 warp minimum from two 32-bit redux.sync steps (signed high word,
// then unsigned low word among the lanes that hold the minimum high word)
__device__ __forceinline__ int64_t warp_min_i64(int64_t v) {
  const int hi = int(v >> 32);
  const int m_hi = __reduce_min_sync(FULL, hi);
  const unsigned m_lo = __reduce_min_sync(FULL, hi == m_hi ? unsigned(v) : 0xFFFFFFFFu);
  return int64_t((uint64_t(uint32_t(m_hi)) << 32) | m_lo);
}

// A queue entry's order key: (time, tie, slot), compared in that order.
struct Key {
  int64_t time, tie;
  int slot;
};
__device__ __forceinline__ bool key_less(const Key &x, const Key &y) {
  return x.time < y.time || (x.time == y.time && (x.tie < y.tie || (x.tie == y.tie && x.slot < y.slot)));
}
__device__ __forceinline__ Key warp_min_key(Key k) {
#pragma unroll
  for (int d = WARP / 2; d > 0; d /= 2) {
    Key o;
    o.time = __shfl_xor_sync(FULL, k.time, d);
    o.tie = __shfl_xor_sync(FULL, k.tie, d);
    o.slot = __shfl_xor_sync(FULL, k.slot, d);
    if (key_less(o, k)) k = o;
  }
  return k;
}

// The nth (from 0) set bit of m.
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  for (int i = 0; i < n; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

// One warp's working set in shared memory. Per-row arrays whose rows a
// lane reads for itself are row-minor ([..][ROWS_PER_WARP]) or padded, so
// that the lanes of a warp fall into different banks. MAX_S sizes the
// socket arrays for the instance's model, so tgen's block keeps its size.
template <int MAX_S>
struct WarpSmem {
  // streamed pieces of `time` rows
  alignas(16) int64_t piece[PIECES_IN_FLIGHT][PIECE];
  int64_t lim[ROWS_PER_WARP];  // each row's window end (its replica's), capped at TIME_MAX
  // a row's staged slots below the window end, in slot order
  int64_t st_time[ROWS_PER_WARP][STAGE + 1];
  int64_t st_tie[ROWS_PER_WARP][STAGE + 1];
  int32_t st_slot[ROWS_PER_WARP][STAGE + 1];
  int32_t n_below[ROWS_PER_WARP];         // slots below the window end
  int64_t rest[ROWS_PER_WARP];            // least time at or past it
  int64_t after[ROWS_PER_WARP];           // head time once the list is popped
  int32_t n_free[ROWS_PER_WARP];
  int32_t free_col[ROWS_PER_WARP][MAX_K];  // first free columns, ascending
  int8_t list[MAX_K][ROWS_PER_WARP];       // list entry i: its staged index
  // payloads of the list entries
  int32_t p_kind[MAX_K][ROWS_PER_WARP];
  int32_t p_aux[MAX_K][ROWS_PER_WARP];
  alignas(16) int32_t p_data[ROWS_PER_WARP][MAX_K * LANES + 4];
  // the defer FIFO; f_src: the list entry whose payload an entry carries
  int64_t f_time[MAX_K][ROWS_PER_WARP];
  int64_t f_tie[MAX_K][ROWS_PER_WARP];
  int32_t f_aux[MAX_K][ROWS_PER_WARP];
  int8_t f_src[MAX_K][ROWS_PER_WARP];
  // socket-matching fields of the rows' sockets, [row * S + s]
  int32_t sk_st[ROWS_PER_WARP * MAX_S];
  int32_t sk_lport[ROWS_PER_WARP * MAX_S];
  int32_t sk_rport[ROWS_PER_WARP * MAX_S];
  int32_t sk_rhost[ROWS_PER_WARP * MAX_S];
};

// A wide launch's dynamic shared memory: its sizes and the byte offset
// of each array (16-byte aligned), from pump_k (K) and the socket count
// (S). The launch sizes the block with it; the kernel finds its arrays.
struct WideLayout {
  int32_t C;    // list entries a pass holds
  int32_t SC;   // slots a row stages per read
  int32_t F;    // defer-FIFO entries a row keeps here
  int32_t own;  // FIFO entries carry their payload (K > C: passes reuse the list)
  int32_t MW;   // socket-match words here (0: in device scratch)
  uint32_t st_time, st_tie, f_time, f_tie, st_slot, p_kind, p_aux, p_data, f_aux, f_kind, f_data,
      free_col, match, list, f_src, bytes;
};
__host__ __device__ inline int64_t match_words(int64_t S) {
  return (ROWS_PER_WARP * S + WARP - 1) / WARP;
}
__host__ __device__ inline uint32_t wide_take(uint32_t &end, int64_t bytes) {
  const uint32_t at = end;
  end = uint32_t((end + bytes + 15) / 16 * 16);
  return at;
}
__host__ __device__ inline WideLayout wide_layout(int64_t K, int64_t S) {
  WideLayout L;
  L.C = int(K < WIDE_LIST_CAP ? K : WIDE_LIST_CAP);
  L.SC = wide_stage(L.C);
  L.F = int(K < WIDE_FIFO_CAP ? K : WIDE_FIFO_CAP);
  L.own = K > L.C;
  L.MW = match_words(S) <= WIDE_MATCH_WORDS ? int(match_words(S)) : 0;
  const int64_t R = ROWS_PER_WARP, SP = L.SC + 1, C = L.C, F = L.F;
  uint32_t end = 0;
  L.st_time = wide_take(end, R * SP * 8);  // [row][SC + 1], slot order
  L.st_tie = wide_take(end, R * SP * 8);
  L.f_time = wide_take(end, F * R * 8);  // [entry][row]
  L.f_tie = wide_take(end, F * R * 8);
  L.st_slot = wide_take(end, R * SP * 4);
  L.p_kind = wide_take(end, C * R * 4);  // [list entry][row]
  L.p_aux = wide_take(end, C * R * 4);
  L.p_data = wide_take(end, R * (C * LANES + 4) * 4);  // [row][C * LANES + 4]
  L.f_aux = wide_take(end, F * R * 4);
  L.f_kind = wide_take(end, L.own ? F * R * 4 : 0);
  L.f_data = wide_take(end, L.own ? R * (F * LANES + 4) * 4 : 0);
  L.free_col = wide_take(end, R * C * 4);  // [row][C], ascending
  L.match = wide_take(end, int64_t(L.MW) * 4);
  L.list = wide_take(end, C * R);  // [list entry][row]: its staged index
  L.f_src = wide_take(end, F * R);
  L.bytes = end;
  return L;
}

// A wide instance's static shared memory (the rest is WideLayout's).
struct WideSmem {
  alignas(16) int64_t piece[PIECES_IN_FLIGHT][PIECE];
  int64_t lim[ROWS_PER_WARP];
  int64_t rest[ROWS_PER_WARP];   // least time at or past the window end
  int64_t after[ROWS_PER_WARP];  // head time once the pass is popped
  int32_t n_st[ROWS_PER_WARP];    // staged slots
  int32_t n_tied[ROWS_PER_WARP];  // the first of them, whose ties are staged
  int32_t n_free[ROWS_PER_WARP];  // free columns seen (the first C recorded)
  int32_t len[ROWS_PER_WARP];     // the pass's list length
  int32_t want[ROWS_PER_WARP];    // entries the pass may list
  // each going row's event, for the socket match: on (a packet), ports, source host
  int32_t m_on[ROWS_PER_WARP], m_dport[ROWS_PER_WARP], m_sport[ROWS_PER_WARP], m_src[ROWS_PER_WARP];
  WideLayout lay;
  // never read: the body's SK names them where a wide instance reads device memory
  int32_t sk_st[1], sk_lport[1], sk_rport[1], sk_rhost[1];
};

__device__ __forceinline__ unsigned char *wide_dynamic_smem() {
  extern __shared__ __align__(16) unsigned char dyn[];
  return dyn;
}

// The arrays of a wide launch's dynamic shared memory.
struct WideView {
  unsigned char *d;
  const WideLayout *L;
  template <class T>
  __device__ __forceinline__ T *at(uint32_t off) const { return reinterpret_cast<T *>(d + off); }
  // staged slot e of row r: time, tie, column
  __device__ __forceinline__ int64_t &time(int r, int e) const { return at<int64_t>(L->st_time)[r * (L->SC + 1) + e]; }
  __device__ __forceinline__ int64_t &tie(int r, int e) const { return at<int64_t>(L->st_tie)[r * (L->SC + 1) + e]; }
  __device__ __forceinline__ int32_t &slot(int r, int e) const { return at<int32_t>(L->st_slot)[r * (L->SC + 1) + e]; }
  // list entry i of row r: its staged index and payload
  __device__ __forceinline__ uint8_t &list(int i, int r) const { return at<uint8_t>(L->list)[i * ROWS_PER_WARP + r]; }
  __device__ __forceinline__ int32_t &kind(int i, int r) const { return at<int32_t>(L->p_kind)[i * ROWS_PER_WARP + r]; }
  __device__ __forceinline__ int32_t &aux(int i, int r) const { return at<int32_t>(L->p_aux)[i * ROWS_PER_WARP + r]; }
  __device__ __forceinline__ int32_t *data(int r, int i) const {
    return at<int32_t>(L->p_data) + r * (L->C * LANES + 4) + i * LANES;
  }
  __device__ __forceinline__ int32_t &free_col(int r, int i) const { return at<int32_t>(L->free_col)[r * L->C + i]; }
  // defer-FIFO entry k (< F) of row r
  __device__ __forceinline__ int64_t &f_time(int k, int r) const { return at<int64_t>(L->f_time)[k * ROWS_PER_WARP + r]; }
  __device__ __forceinline__ int64_t &f_tie(int k, int r) const { return at<int64_t>(L->f_tie)[k * ROWS_PER_WARP + r]; }
  __device__ __forceinline__ int32_t &f_aux(int k, int r) const { return at<int32_t>(L->f_aux)[k * ROWS_PER_WARP + r]; }
  __device__ __forceinline__ int32_t &f_kind(int k, int r) const { return at<int32_t>(L->f_kind)[k * ROWS_PER_WARP + r]; }
  __device__ __forceinline__ int32_t *f_data(int r, int k) const {
    return at<int32_t>(L->f_data) + r * (L->F * LANES + 4) + k * LANES;
  }
  __device__ __forceinline__ int8_t &f_src(int k, int r) const { return at<int8_t>(L->f_src)[k * ROWS_PER_WARP + r]; }
  __device__ __forceinline__ uint32_t *match() const { return at<uint32_t>(L->match); }
};
struct NoView {};

template <bool WIDE, class Smem>
__device__ __forceinline__ auto wide_view(Smem &w) {
  if constexpr (WIDE)
    return WideView{wide_dynamic_smem(), &w.lay};
  else
    return NoView{};
}

// Row r's stage is full: keep its best L + 1 entries by (time, tie,
// slot), in that order at its front (the ties of [n_tied, n) are
// gathered first). Warp-wide; n and n_tied become L + 1.
__device__ __forceinline__ void wide_compact(const WideView &v, const int64_t *q_tie, int64_t row, int64_t Q,
                             int r, int L, int &n, int &n_tied, int lane) {
  for (int e = n_tied + lane; e < n; e += WARP) v.tie(r, e) = q_tie[row * Q + v.slot(r, e)];
  __syncwarp();
  constexpr int CH = (WIDE_MAX_SC + WARP - 1) / WARP;
  Key k[CH];
  int rank[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int e = c * WARP + lane;
    k[c] = {TIME_MAX, I64_MAX, 0x7FFFFFFF};
    rank[c] = WIDE_MAX_SC;
    if (e < n) {
      k[c] = {v.time(r, e), v.tie(r, e), v.slot(r, e)};
      int rk = 0;
      for (int j = 0; j < n; ++j) {
        const Key kj = {v.time(r, j), v.tie(r, j), v.slot(r, j)};
        rk += key_less(kj, k[c]) ? 1 : 0;
      }
      rank[c] = rk;
    }
  }
  __syncwarp();  // every entry is read before any moves
#pragma unroll
  for (int c = 0; c < CH; ++c)
    if (rank[c] <= L) {
      v.time(r, rank[c]) = k[c].time;
      v.tie(r, rank[c]) = k[c].tie;
      v.slot(r, rank[c]) = k[c].slot;
    }
  __syncwarp();
  n = n_tied = L + 1;
}

// A wide instance's pass, for every row of `rows` at once (warp-wide):
// one streamed read of each row's `time` row stages its slots below the
// window end (compacting to the best want + 1 whenever the stage fills,
// then staging only slots no later than the last kept), the least time at
// or past it and its first C free columns; then the staged slots' ties,
// gathered for all rows at once, and each row's ranks: the first
// min(want, staged) form its list (len), and the time after the list is
// the head once it is popped (after). Reads w.lim and w.want.
__device__ __forceinline__ void wide_read(WideSmem &w, const WideView &v, const int64_t *q_time,
                          const int64_t *q_tie, int64_t row0, int64_t Q, unsigned rows, int lane) {
  const int SC = w.lay.SC, FC = w.lay.C;
  const int per_row = int((Q + PIECE - 1) / PIECE);
  const int n_pieces = __popc(rows) * per_row;
  auto fetch = [&](int p) {  // piece p: row p / per_row of `rows`, its chunk p % per_row
    if (p < n_pieces) {
      const int r = nth_bit(rows, p / per_row);
      const int64_t base = int64_t(p % per_row) * PIECE;
      const int n = int(imin(PIECE, Q - base));
      const int64_t *src = q_time + (row0 + r) * Q + base;
      int64_t *dst = w.piece[p % PIECES_IN_FLIGHT];
      for (int j = lane; j < n; j += WARP) __pipeline_memcpy_async(dst + j, src + j, 8);
    }
    __pipeline_commit();
  };
  for (int p = 0; p < PIECES_IN_FLIGHT - 1; ++p) fetch(p);
  int n = 0, n_tied = 0, n_free = 0, want = 0;
  int64_t rest = TIME_MAX, cut = TIME_MAX;  // cut: the last kept time once the stage compacted
  for (int p = 0; p < n_pieces; ++p) {
    fetch(p + PIECES_IN_FLIGHT - 1);
    __pipeline_wait_prior(PIECES_IN_FLIGHT - 1);
    __syncwarp();  // piece p has landed, every lane's part of it
    const int r = nth_bit(rows, p / per_row);
    const int64_t base = int64_t(p % per_row) * PIECE;
    const int np = int(imin(PIECE, Q - base));
    const int64_t *t = w.piece[p % PIECES_IN_FLIGHT];
    const int64_t lim = w.lim[r];
    if (p % per_row == 0) want = w.want[r];
    for (int j0 = 0; j0 < np; j0 += 2 * WARP) {
      const int j = j0 + 2 * lane;
      const longlong2 x = *reinterpret_cast<const longlong2 *>(t + j);
      const int64_t t0 = x.x, t1 = x.y;
      const bool in0 = j < np, in1 = j + 1 < np;
      // 64 free slots add nothing once C free columns are recorded
      if (n_free >= FC && !__any_sync(FULL, (in0 && t0 != TIME_MAX) || (in1 && t1 != TIME_MAX)))
        continue;
      if (in0 && t0 >= lim) rest = imin(rest, t0);
      if (in1 && t1 >= lim) rest = imin(rest, t1);
      const bool b0 = in0 && t0 < lim && t0 <= cut, b1 = in1 && t1 < lim && t1 <= cut;
      const unsigned below = lanes_below(lane);
      const unsigned m0 = __ballot_sync(FULL, b0), m1 = __ballot_sync(FULL, b1);
      const int add = __popc(m0) + __popc(m1);
      const int i0 = __popc(m0 & below) + __popc(m1 & below), i1 = i0 + b0;
      // the iteration's staged slots, in slot order; a full stage compacts
      for (int done = 0;;) {
        const int room = SC - n;
        if (b0 && i0 >= done && i0 - done < room) {
          v.time(r, n + i0 - done) = t0;
          v.slot(r, n + i0 - done) = int(base + j);
        }
        if (b1 && i1 >= done && i1 - done < room) {
          v.time(r, n + i1 - done) = t1;
          v.slot(r, n + i1 - done) = int(base + j + 1);
        }
        const int wrote = add - done < room ? add - done : room;
        n += wrote;
        done += wrote;
        if (done == add) break;
        __syncwarp();
        wide_compact(v, q_tie, row0 + r, Q, r, want, n, n_tied, lane);
        cut = v.time(r, want);
      }
      const bool f0 = in0 && t0 == TIME_MAX, f1 = in1 && t1 == TIME_MAX;
      const unsigned g0 = __ballot_sync(FULL, f0), g1 = __ballot_sync(FULL, f1);
      const int fat = n_free + __popc(g0 & below) + __popc(g1 & below);
      if (f0 && fat < FC) v.free_col(r, fat) = int(base + j);
      if (f1 && fat + f0 < FC) v.free_col(r, fat + f0) = int(base + j + 1);
      n_free += __popc(g0) + __popc(g1);
    }
    if (p % per_row == per_row - 1) {  // the row's last piece
      const int64_t m = warp_min_i64(rest);
      if (lane == 0) {
        w.n_st[r] = n;
        w.n_tied[r] = n_tied;
        w.n_free[r] = n_free;
        w.rest[r] = m;
      }
      n = n_tied = n_free = 0;
      rest = cut = TIME_MAX;
    }
    __syncwarp();  // done with the piece's buffer before it is refilled
  }
  // the ties of the staged slots not yet tied, for all rows at once
  for (int c0 = 0;; c0 += WARP) {
    int64_t tie[ROWS_PER_WARP];
    bool any = false;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int e = w.n_tied[r] + c0 + lane;
      const bool m = ((rows >> r) & 1u) && e < w.n_st[r];
      tie[r] = m ? q_tie[(row0 + r) * Q + v.slot(r, e)] : 0;
      any = any || m;
    }
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int e = w.n_tied[r] + c0 + lane;
      if (((rows >> r) & 1u) && e < w.n_st[r]) v.tie(r, e) = tie[r];
    }
    if (!__any_sync(FULL, any)) break;
  }
  __syncwarp();
  // each row's list: its staged slots ranked by (time, tie, slot), a lane
  // per entry across the rows; ranks below want form the list, rank want
  // is the head once it is popped
  int total = 0;
  for (int r = 0; r < ROWS_PER_WARP; ++r) total += ((rows >> r) & 1u) ? w.n_st[r] : 0;
  for (int g0 = 0; g0 < total; g0 += WARP) {
    const int g = g0 + lane;
    int r = -1, e = 0;
    for (int rr = 0, off = 0; rr < ROWS_PER_WARP && r < 0; ++rr) {
      const int nr = ((rows >> rr) & 1u) ? w.n_st[rr] : 0;
      if (g < off + nr) {
        r = rr;
        e = g - off;
      }
      off += nr;
    }
    if (r < 0) continue;
    const int n_r = w.n_st[r], want_r = w.want[r];
    const Key ke = {v.time(r, e), v.tie(r, e), v.slot(r, e)};
    int rank = 0;
#pragma unroll 4
    for (int j = 0; j < n_r; ++j) {
      const Key kj = {v.time(r, j), v.tie(r, j), v.slot(r, j)};
      rank += key_less(kj, ke) ? 1 : 0;
    }
    if (rank < want_r) v.list(rank, r) = uint8_t(e);
    if (rank == want_r) w.after[r] = ke.time;
  }
  if (lane < ROWS_PER_WARP && ((rows >> lane) & 1u)) {
    const int n_r = w.n_st[lane], want_r = w.want[lane];
    if (n_r <= want_r) w.after[lane] = w.rest[lane];  // the row's every slot below the window end is listed
    w.len[lane] = n_r < want_r ? n_r : want_r;
  }
  __syncwarp();
}

// A wide instance's socket match for the warp's rows (warp-wide): bit
// r * S + s of `bits` is set where row r's event (w.m_*, for rows with
// m_on) matches its socket s: established (not CLOSED or LISTEN) on the
// packet's 4-tuple. The rows' sockets are ROWS_PER_WARP * S consecutive
// ints of each field, read 32 at a time; only the words of the rows with
// m_on (`on_rows`) are written.
__device__ __forceinline__ void wide_match(const WideSmem &w, uint32_t *bits, const int32_t *st,
                           const int32_t *lport, const int32_t *rport, const int32_t *rhost,
                           int64_t row0, int S, unsigned on_rows, int lane) {
  const int64_t first = row0 * S;
  const int lo = (__ffs(on_rows) - 1) * S, hi = (32 - __clz(on_rows)) * S;
#pragma unroll 4
  for (int g0 = lo / WARP * WARP; g0 < hi; g0 += WARP) {
    const int g = g0 + lane;
    bool hit = false;
    if (g >= lo && g < hi) {
      const int r = g / S;
      if (w.m_on[r]) {
        const int32_t s_st = st[first + g];
        hit = s_st != ST_CLOSED && s_st != ST_LISTEN && lport[first + g] == w.m_dport[r] &&
              rhost[first + g] == w.m_src[r] && rport[first + g] == w.m_sport[r];
      }
    }
    const unsigned word = __ballot_sync(FULL, hit);
    if (lane == 0) bits[g0 / WARP] = word;
  }
}

__device__ __forceinline__ void prefetch_l2(const void *p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Bits [lo, lo + n) of a bit array's word wd, in place.
__device__ __forceinline__ unsigned bits_in(unsigned word, int wd, int lo, int n) {
  const int a = lo - wd * WARP, b = lo + n - wd * WARP;  // the range within the word: [a, b)
  const unsigned from = a <= 0 ? FULL : (a >= WARP ? 0u : FULL << a);
  const unsigned to = b >= WARP ? FULL : (b <= 0 ? 0u : FULL >> (WARP - b));
  return word & from & to;
}

// Stage list entry i of row r of a wide pass (any lane may call it).
__device__ __forceinline__ void wide_stage_payload(const WideView &v, const int32_t *kind,
                                                   const int32_t *aux, const int32_t *data,
                                                   int64_t row, int64_t Q, int r, int i) {
  const int64_t at = row * Q + v.slot(r, v.list(i, r));
  __pipeline_memcpy_async(&v.kind(i, r), kind + at, 4);
  __pipeline_memcpy_async(&v.aux(i, r), aux + at, 4);
  __pipeline_memcpy_async(v.data(r, i), data + at * LANES, 16);
  __pipeline_memcpy_async(v.data(r, i) + 4, data + at * LANES + 4, 16);
}

// A wide row's defer-FIFO entry k: below F in shared memory (its payload
// that of list entry f_src, or with pump_k past C its own), past it in
// the row's device scratch `gf` (FIFO_WORDS words).
__device__ __forceinline__ int64_t wf_time(const WideView &v, const int64_t *gf, int k, int r) {
  const int F = v.L->F;
  return k < F ? v.f_time(k, r) : gf[int64_t(k - F) * FIFO_WORDS];
}
__device__ __forceinline__ int64_t wf_tie(const WideView &v, const int64_t *gf, int k, int r) {
  const int F = v.L->F;
  return k < F ? v.f_tie(k, r) : gf[int64_t(k - F) * FIFO_WORDS + 1];
}
__device__ __forceinline__ void wf_payload(const WideView &v, const int64_t *gf, int k, int r,
                                           int32_t &kind, int32_t &aux, int32_t (&data)[LANES]) {
  const int F = v.L->F;
  const int32_t *d;
  if (k >= F) {
    const int64_t *e = gf + int64_t(k - F) * FIFO_WORDS;
    kind = int32_t(e[2]);
    aux = int32_t(e[3]);
    d = reinterpret_cast<const int32_t *>(e + 4);
  } else if (v.L->own) {
    kind = v.f_kind(k, r);
    aux = v.f_aux(k, r);
    d = v.f_data(r, k);
  } else {
    const int src = v.f_src(k, r);
    kind = v.kind(src, r);
    aux = v.f_aux(k, r);
    d = v.data(r, src);
  }
#pragma unroll
  for (int l = 0; l < LANES; ++l) data[l] = d[l];
}
// Append entry k (list entry src's event, deferred to `time`).
__device__ __forceinline__ void wf_push(const WideView &v, int64_t *gf, int k, int r, int64_t time,
                                        int64_t tie, int32_t kind, int32_t aux,
                                        const int32_t (&data)[LANES], int src) {
  const int F = v.L->F;
  int32_t *d;
  if (k >= F) {
    int64_t *e = gf + int64_t(k - F) * FIFO_WORDS;
    e[0] = time;
    e[1] = tie;
    e[2] = kind;
    e[3] = aux;
    d = reinterpret_cast<int32_t *>(e + 4);
  } else {
    v.f_time(k, r) = time;
    v.f_tie(k, r) = tie;
    v.f_aux(k, r) = aux;
    if (!v.L->own) {
      v.f_src(k, r) = int8_t(src);
      return;
    }
    v.f_kind(k, r) = kind;
    d = v.f_data(r, k);
  }
#pragma unroll
  for (int l = 0; l < LANES; ++l) d[l] = data[l];
}

// Stage list entry i of row r (lane-independent: any lane may call it):
// kind, aux and data of the entry's queue slot, copied asynchronously.
template <class Smem>
__device__ __forceinline__ void stage_payload(Smem &w, const int32_t *kind,
                                              const int32_t *aux, const int32_t *data,
                                              int64_t row, int64_t Q, int r, int i) {
  const int64_t at = row * Q + w.st_slot[r][w.list[i][r]];
  __pipeline_memcpy_async(&w.p_kind[i][r], kind + at, 4);
  __pipeline_memcpy_async(&w.p_aux[i][r], aux + at, 4);
  __pipeline_memcpy_async(&w.p_data[r][i * LANES], data + at * LANES, 16);
  __pipeline_memcpy_async(&w.p_data[r][i * LANES + 4], data + at * LANES + 4, 16);
}

#define P(type, name) (reinterpret_cast<type *>(a.name))

// A wide instance names its one block an SM at least: without it ptxas
// holds the kernel to 168 registers and spills.
template <int MODEL, bool WIDE>
__global__ void __launch_bounds__(WARP, WIDE ? 1 : 0) pump_megakernel(const PumpArgs a) {
  __shared__ std::conditional_t<WIDE, WideSmem, WarpSmem<max_sockets<MODEL>()>> w;
  const auto v = wide_view<WIDE>(w);  // a wide launch's dynamic arrays
  const int lane = int(threadIdx.x);
  const int64_t row0 = int64_t(blockIdx.x) * ROWS_PER_WARP;  // the warp's first row
  const int64_t h = row0 + lane;  // this lane's row (lanes below ROWS_PER_WARP)
  const int S = int(a.S), O = int(a.O);
  const int64_t Q = a.Q;
  const int K = int(a.pump_k);
  const int64_t mss = a.mss;

  int64_t *q_time = P(int64_t, q_time);
  int64_t *q_tie = P(int64_t, q_tie);
  const bool mine = lane < ROWS_PER_WARP && h < a.H;
  // the row's window end: its replica's
  const int64_t we = mine ? P(int64_t, window_end)[h / a.rows_per_replica] : 0;
  if (lane < ROWS_PER_WARP) w.lim[lane] = imin(we, TIME_MAX);  // a listed entry's time is below both
  int32_t qcount = mine ? P(int32_t, q_count)[h] : 0;
  int64_t qhead = mine ? P(int64_t, q_head)[h] : TIME_MAX;
  // a row takes an event only if its first microstep finds one in the
  // queue (the defer FIFO starts empty); other rows are left untouched
  const bool live = mine && qcount > 0 && qhead < we;
  const unsigned live_rows = __ballot_sync(FULL, live);
  if (live_rows == 0) return;

  if constexpr (!WIDE) {
  // ---- the rows' socket-matching fields, one coalesced pass each ----
  {
    const int64_t first = row0 * S, end = imin(a.H * S, first + ROWS_PER_WARP * S);
    for (int64_t g = first + lane; g < end; g += WARP) {
      w.sk_st[g - first] = P(int32_t, st)[g];
      w.sk_lport[g - first] = P(int32_t, lport)[g];
      w.sk_rport[g - first] = P(int32_t, rport)[g];
      w.sk_rhost[g - first] = P(int32_t, rhost)[g];
    }
  }

  // ---- A. stream each live row's `time` row once ----
  {
    const int per_row = int((Q + PIECE - 1) / PIECE);
    const int n_pieces = __popc(live_rows) * per_row;
    auto fetch = [&](int p) {  // piece p: live row p / per_row, its chunk p % per_row
      if (p < n_pieces) {
        const int r = nth_bit(live_rows, p / per_row);
        const int64_t base = int64_t(p % per_row) * PIECE;
        const int n = int(imin(PIECE, Q - base));
        const int64_t *src = q_time + (row0 + r) * Q + base;
        int64_t *dst = w.piece[p % PIECES_IN_FLIGHT];
        for (int j = lane; j < n; j += WARP) __pipeline_memcpy_async(dst + j, src + j, 8);
      }
      __pipeline_commit();
    };
    for (int p = 0; p < PIECES_IN_FLIGHT - 1; ++p) fetch(p);
    int n_below = 0, n_free = 0;
    int64_t rest = TIME_MAX;  // this lane's part of the row's least time at or past lim
    for (int p = 0; p < n_pieces; ++p) {
      fetch(p + PIECES_IN_FLIGHT - 1);
      __pipeline_wait_prior(PIECES_IN_FLIGHT - 1);
      __syncwarp();  // piece p has landed, every lane's part of it
      const int r = nth_bit(live_rows, p / per_row);
      const int64_t base = int64_t(p % per_row) * PIECE;
      const int n = int(imin(PIECE, Q - base));
      const int64_t *t = w.piece[p % PIECES_IN_FLIGHT];
      const int64_t lim = w.lim[r];
      // lane l holds slots j, j + 1 (one 16-byte load); in slot order,
      // lane l's come after those of the lanes below it
      for (int j0 = 0; j0 < n; j0 += 2 * WARP) {
        const int j = j0 + 2 * lane;
        const longlong2 v = *reinterpret_cast<const longlong2 *>(t + j);
        const int64_t t0 = v.x, t1 = v.y;
        const bool in0 = j < n, in1 = j + 1 < n;
        // 64 free slots add nothing once MAX_K free columns are recorded
        if (n_free >= MAX_K && !__any_sync(FULL, (in0 && t0 != TIME_MAX) || (in1 && t1 != TIME_MAX)))
          continue;
        const bool b0 = in0 && t0 < lim, b1 = in1 && t1 < lim;
        if (in0 && !b0) rest = imin(rest, t0);
        if (in1 && !b1) rest = imin(rest, t1);
        const unsigned below = lanes_below(lane);
        const unsigned m0 = __ballot_sync(FULL, b0), m1 = __ballot_sync(FULL, b1);
        const int at = n_below + __popc(m0 & below) + __popc(m1 & below);
        if (b0 && at < STAGE) {
          w.st_time[r][at] = t0;
          w.st_slot[r][at] = int(base + j);
        }
        if (b1 && at + b0 < STAGE) {
          w.st_time[r][at + b0] = t1;
          w.st_slot[r][at + b0] = int(base + j + 1);
        }
        n_below += __popc(m0) + __popc(m1);
        const bool f0 = in0 && t0 == TIME_MAX, f1 = in1 && t1 == TIME_MAX;
        const unsigned g0 = __ballot_sync(FULL, f0), g1 = __ballot_sync(FULL, f1);
        const int fat = n_free + __popc(g0 & below) + __popc(g1 & below);
        if (f0 && fat < MAX_K) w.free_col[r][fat] = int(base + j);
        if (f1 && fat + f0 < MAX_K) w.free_col[r][fat + f0] = int(base + j + 1);
        n_free += __popc(g0) + __popc(g1);
      }
      if (p % per_row == per_row - 1) {  // the row's last piece
        const int64_t m = warp_min_i64(rest);
        if (lane == 0) {
          w.n_below[r] = n_below;
          w.n_free[r] = n_free;
          w.rest[r] = m;
        }
        n_below = n_free = 0;
        rest = TIME_MAX;
      }
      __syncwarp();  // done with the piece's buffer before it is refilled
    }
  }

  // ---- A. the staged slots' ties, gathered for all rows at once ----
  {
    int64_t tie[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const bool m = ((live_rows >> r) & 1u) && lane < w.n_below[r];
      tie[r] = m ? q_tie[(row0 + r) * Q + w.st_slot[r][lane]] : 0;
    }
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r)
      if (((live_rows >> r) & 1u) && lane < w.n_below[r]) w.st_tie[r][lane] = tie[r];
  }
  __syncwarp();

  // ---- A. each live row's list: its first pump_k entries by (time, tie, slot) ----
  // The staged entries of all rows that fit the stage, ranked 32 at a time
  // (lane: one entry, its rank among its row's entries): ranks below K
  // form the row's list, rank K is the head once the list is popped.
  {
    int total = 0;
    for (int r = 0; r < ROWS_PER_WARP; ++r)
      total += ((live_rows >> r) & 1u) && w.n_below[r] <= STAGE ? w.n_below[r] : 0;
    for (int g0 = 0; g0 < total; g0 += WARP) {
      const int g = g0 + lane;
      int r = -1, e = 0;
      for (int rr = 0, off = 0; rr < ROWS_PER_WARP && r < 0; ++rr) {
        const int nr = ((live_rows >> rr) & 1u) && w.n_below[rr] <= STAGE ? w.n_below[rr] : 0;
        if (g < off + nr) {
          r = rr;
          e = g - off;
        }
        off += nr;
      }
      if (r < 0) continue;
      const int n = w.n_below[r];
      const Key ke = {w.st_time[r][e], w.st_tie[r][e], w.st_slot[r][e]};
      int rank = 0;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const Key kj = {w.st_time[r][j], w.st_tie[r][j], w.st_slot[r][j]};
        rank += key_less(kj, ke) ? 1 : 0;
      }
      if (rank < K) w.list[rank][r] = int8_t(e);
      if (rank == K) w.after[r] = ke.time;
    }
    if (live && w.n_below[lane] <= K) w.after[lane] = w.rest[lane];
  }
  // rows with more slots below the window end than the stage holds: the
  // list by K + 1 rounds of a warp minimum over the row in device memory
  for (unsigned todo = live_rows; todo; todo &= todo - 1) {
    const int r = __ffs(todo) - 1;
    if (w.n_below[r] > STAGE) {
      const int64_t *tr = q_time + (row0 + r) * Q;
      const int64_t *tier = q_tie + (row0 + r) * Q;
      const int64_t lim = w.lim[r];
      Key prev = {-1, 0, 0};
      for (int i = 0; i <= K; ++i) {
        Key best = {TIME_MAX, I64_MAX, 0x7FFFFFFF};
        for (int64_t s = lane; s < Q; s += WARP) {
          const int64_t ts = tr[s];
          if (ts >= lim) continue;
          const Key ks = {ts, tier[s], int(s)};
          if (key_less(prev, ks) && key_less(ks, best)) best = ks;
        }
        best = warp_min_key(best);
        if (lane == 0) {
          if (i < K) {
            w.st_time[r][i] = best.time;
            w.st_tie[r][i] = best.tie;
            w.st_slot[r][i] = best.slot;
            w.list[i][r] = int8_t(i);
          } else {
            w.after[r] = best.time;  // n > STAGE > K: the (K+1)-th entry exists
          }
        }
        prev = best;
      }
    }
  }
  __syncwarp();

  // ---- A. the head's payload (list entry 0), for every live row ----
  if (live) stage_payload(w, P(int32_t, q_kind), P(int32_t, q_aux), P(int32_t, q_data), h, Q, lane, 0);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
  } else {
    // ---- A (wide). the rows' socket-matching fields towards L2 (the
    // first microstep's match reads them), the layout, then the first
    // pass of every live row ----
    {
      const int64_t first = row0 * S, end = imin(a.H * S, first + ROWS_PER_WARP * S);
      for (int64_t g = (first & ~int64_t(WARP - 1)) + lane * WARP; g < end; g += WARP * WARP) {
        prefetch_l2(P(int32_t, st) + g);
        prefetch_l2(P(int32_t, lport) + g);
        prefetch_l2(P(int32_t, rport) + g);
        prefetch_l2(P(int32_t, rhost) + g);
      }
    }
    if (lane == 0) w.lay = wide_layout(a.pump_k, a.S);
    __syncwarp();
    if (lane < ROWS_PER_WARP) w.want[lane] = w.lay.C;
    __syncwarp();
    wide_read(w, v, q_time, q_tie, row0, Q, live_rows, lane);
    if (live && w.len[lane] > 0)
      wide_stage_payload(v, P(int32_t, q_kind), P(int32_t, q_aux), P(int32_t, q_data), h, Q, lane, 0);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
  }

  // ---- B. the microsteps, one lane per row ----
  // flow-table row base
  const int64_t hs = h * S;
  int32_t *ts_st = P(int32_t, st) + hs;
  int64_t *ts_una = P(int64_t, snd_una) + hs;
  int64_t *ts_nxt = P(int64_t, snd_nxt) + hs;
  int64_t *ts_max = P(int64_t, snd_max) + hs;
  int64_t *ts_end = P(int64_t, snd_end) + hs;
  uint8_t *ts_finp = P(uint8_t, fin_pending) + hs;
  uint8_t *ts_fins = P(uint8_t, fin_sent) + hs;
  int64_t *ts_pwnd = P(int64_t, peer_wnd) + hs;
  int64_t *ts_rcv = P(int64_t, rcv_nxt) + hs;
  int64_t *ts_rfin = P(int64_t, rcv_fin) + hs;
  int64_t *ts_dlv = P(int64_t, delivered) + hs;
  int64_t *ts_ooo = P(int64_t, ooo) + hs * NR * 2;
  int64_t *ts_sack = P(int64_t, sacked) + hs * NR * 2;
  int64_t *ts_cwnd = P(int64_t, cwnd) + hs;
  int64_t *ts_ssth = P(int64_t, ssthresh) + hs;
  int32_t *ts_dup = P(int32_t, dupacks) + hs;
  uint8_t *ts_inrec = P(uint8_t, in_rec) + hs;
  int64_t *ts_srtt = P(int64_t, srtt) + hs;
  int64_t *ts_rttvar = P(int64_t, rttvar) + hs;
  int64_t *ts_rto = P(int64_t, rto) + hs;
  uint8_t *ts_rttp = P(uint8_t, rtt_pending) + hs;
  int64_t *ts_rtts = P(int64_t, rtt_seq) + hs;
  int64_t *ts_rttt = P(int64_t, rtt_ts) + hs;
  int64_t *ts_exp = P(int64_t, rto_expire) + hs;
  int32_t *ts_boff = P(int32_t, backoff) + hs;
  int64_t *ts_tev = P(int64_t, tev_time) + hs;
  int64_t *ts_rtx = P(int64_t, retransmits) + hs;
  int64_t *ts_sin = P(int64_t, segs_in) + hs;
  int64_t *ts_sout = P(int64_t, segs_out) + hs;
  // this row's socket-matching fields: in shared memory (narrow), in
  // device memory (wide)
  const int sk = lane * S;
  const int32_t *ts_lport = P(int32_t, lport) + hs;
  const int32_t *ts_rport = P(int32_t, rport) + hs;
  const int32_t *ts_rhost = P(int32_t, rhost) + hs;
#define SK(field, s) (WIDE ? ts_##field[s] : w.sk_##field[sk + (s)])
  // a wide instance's defer-FIFO entries past F (this row's device
  // scratch) and the warp's socket-match bits
  int64_t *fifo = nullptr;
  uint32_t *match_bits = nullptr;
  if constexpr (WIDE) {
    const int F = w.lay.F;
    if (live && K > F) fifo = P(int64_t, fifo) + h * (K - F) * FIFO_WORDS;
    match_bits = w.lay.MW ? v.match() : P(uint32_t, match) + int64_t(blockIdx.x) * match_words(S);
  }

  // outbox row
  uint8_t *obv = P(uint8_t, ob_valid) + h * O;
  int32_t *obd = P(int32_t, ob_dst) + h * O;
  int64_t *obt = P(int64_t, ob_time) + h * O;
  int64_t *obtie = P(int64_t, ob_tie) + h * O;
  int32_t *obdata = P(int32_t, ob_data) + h * O * LANES;
  int32_t *obaux = P(int32_t, ob_aux) + h * O;

  // per-row context
  const int32_t host_id = live ? P(int32_t, host_id)[h] : 0;
  const uint32_t key0 = live ? uint32_t(P(int64_t, rng_key)[2 * h]) : 0;
  const uint32_t key1 = live ? uint32_t(P(int64_t, rng_key)[2 * h + 1]) : 0;
  const int32_t *host_node = P(int32_t, host_node);
  const int64_t src_node = live ? host_node[host_id] : 0;
  const int64_t *lat_ns = P(int64_t, lat_ns);
  const float *relt = P(float, rel);
  const int64_t *codel_tab = P(int64_t, codel_table);
  const bool is_client = host_id < a.num_clients;
  // the second role: tgen's servers, onion's relays
  const int64_t role2_end = a.num_clients + (MODEL == MODEL_ONION ? a.num_relays : a.num_servers);
  const bool is_role2 = host_id >= a.num_clients && host_id < role2_end;
  // onion's veto reads the row's stream counters (the pump never changes them)
  int64_t streams_started = 0, streams_done = 0;
  if (MODEL == MODEL_ONION && live) {
    streams_started = P(int64_t, streams_started)[h];
    streams_done = P(int64_t, streams_done)[h];
  }

  // per-row mutable scalars, written back at the end
#define LOAD(type, name) (live ? P(type, name)[h] : type(0))
  int64_t seq = LOAD(int64_t, seq);
  int64_t rng_counter = LOAD(int64_t, rng_counter);
  int64_t events = LOAD(int64_t, events_handled);
  int64_t pk_sent = LOAD(int64_t, packets_sent);
  int64_t pk_drop = LOAD(int64_t, packets_dropped);
  int64_t pk_unr = LOAD(int64_t, packets_unroutable);
  int32_t obfill = LOAD(int32_t, ob_fill);
  int32_t obover = LOAD(int32_t, ob_overflow);
  int64_t tx_refill = LOAD(int64_t, tx_refill);
  int64_t tx_tokens = LOAD(int64_t, tx_tokens);
  int64_t tx_last = LOAD(int64_t, tx_last);
  int64_t rx_refill = LOAD(int64_t, rx_refill);
  int64_t rx_tokens = LOAD(int64_t, rx_tokens);
  int64_t rx_last = LOAD(int64_t, rx_last);
  int64_t cd_first = LOAD(int64_t, codel_first_above);
  int64_t cd_next = LOAD(int64_t, codel_drop_next);
  int32_t cd_count = LOAD(int32_t, codel_count);
  bool cd_dropping = LOAD(uint8_t, codel_dropping) != 0;
  int64_t rx_backlog = LOAD(int64_t, rx_backlog);
  int64_t cd_dropped = LOAD(int64_t, codel_dropped);
  int64_t bytes_sent = LOAD(int64_t, bytes_sent);
  int64_t bytes_recv = LOAD(int64_t, bytes_recv);
  int64_t bytes_down = LOAD(int64_t, bytes_down);
  int64_t trk_ctrl = 0, trk_data = 0, trk_rtx = 0;
  if (a.tracker) {
    trk_ctrl = LOAD(int64_t, trk_bytes_ctrl);
    trk_data = LOAD(int64_t, trk_bytes_data);
    trk_rtx = LOAD(int64_t, trk_retrans);
  }
#undef LOAD
  int64_t min_used_local = TIME_MAX;
  bool rejected = false;
  // the list's length (a wide instance's: its current pass's)
  int n_listed = 0;
  if constexpr (WIDE)
    n_listed = live ? w.len[lane] : 0;
  else
    n_listed = live ? int(imin(w.n_below[lane], K)) : 0;
  int qi = 0;  // queue entries popped: the candidate is list entry qi
  int f_head = 0, f_cnt = 0;  // this row's defer FIFO (w.f_*)
  bool active = live;

  for (int step = 0; step < K; ++step) {
    const unsigned going = __ballot_sync(FULL, active);
    if (going == 0) break;
    if constexpr (!WIDE) {
    if (step == 1) {
      // the rest of the lists, for the rows that took their head
      const int pairs = ROWS_PER_WARP * (MAX_K - 1);
      for (int p = lane; p < pairs; p += WARP) {
        const int r = p / (MAX_K - 1), i = 1 + p % (MAX_K - 1);
        if (((going >> r) & 1u) && i < int(imin(w.n_below[r], K)))
          stage_payload(w, P(int32_t, q_kind), P(int32_t, q_aux), P(int32_t, q_data), row0 + r, Q, r, i);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncwarp();
    }
    } else {
      const int C = w.lay.C;
      if (step == 1 && C > 1) {
        // the rest of the first pass's lists, for the rows that took their head
        const int pairs = ROWS_PER_WARP * (C - 1);
        for (int p = lane; p < pairs; p += WARP) {
          const int r = p / (C - 1), i = 1 + p % (C - 1);
          if (((going >> r) & 1u) && i < w.len[r])
            wide_stage_payload(v, P(int32_t, q_kind), P(int32_t, q_aux), P(int32_t, q_data), row0 + r, Q, r, i);
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncwarp();
      }
      // a row that has popped its pass and whose head is below the window
      // end takes its next pass (pump_k past C), with its payloads
      const unsigned refill = __ballot_sync(FULL, active && qi == n_listed && qhead < we);
      if (refill) {
        __threadfence_block();
        __syncwarp();  // the rows' pops, written to device memory, are seen by the warp
        if ((refill >> lane) & 1u) w.want[lane] = int(imin(C, K - step));
        __syncwarp();
        wide_read(w, v, q_time, q_tie, row0, Q, refill, lane);
        for (int p = lane; p < ROWS_PER_WARP * C; p += WARP) {
          const int r = p / C, i = p % C;
          if (((refill >> r) & 1u) && i < w.len[r])
            wide_stage_payload(v, P(int32_t, q_kind), P(int32_t, q_aux), P(int32_t, q_data), row0 + r, Q, r, i);
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncwarp();
        if ((refill >> lane) & 1u) {
          n_listed = w.len[lane];
          qi = 0;
        }
      }
      // the going rows' events (the body below picks the same one), then
      // the warp's socket-match bits for those that are packets
      bool on = false;
      if (active) {
        const bool fh_has = a.use_netstack && f_head < f_cnt;
        const bool q_listed = qi < n_listed;
        const int64_t q_tie_v = q_listed ? v.tie(lane, v.list(qi, lane)) : I64_MAX;
        const int64_t fh_t = fh_has ? wf_time(v, fifo, f_head, lane) : TIME_MAX;
        const bool use_f = fh_has && (qcount <= 0 || fh_t < qhead ||
                                      (fh_t == qhead && wf_tie(v, fifo, f_head, lane) < q_tie_v));
        const int64_t ev_time = use_f ? fh_t : qhead;
        if ((use_f || (qcount > 0 && q_listed)) && ev_time < we) {
          int32_t kind, aux, data[LANES];
          if (use_f) {
            wf_payload(v, fifo, f_head, lane, kind, aux, data);
          } else {
            kind = v.kind(qi, lane);
            data[0] = v.data(lane, qi)[0];
          }
          const int64_t tie = use_f ? wf_tie(v, fifo, f_head, lane) : q_tie_v;
          on = kind == KIND_PACKET;
          w.m_dport[lane] = data[0] & 0xFFFF;
          w.m_sport[lane] = (data[0] >> 16) & 0xFFFF;
          w.m_src[lane] = int32_t((tie >> 32) & ((1 << 30) - 1));
        }
      }
      if (lane < ROWS_PER_WARP) w.m_on[lane] = on;
      const unsigned on_rows = __ballot_sync(FULL, on);
      __syncwarp();  // the tuples are written, and the last microstep's reads of the bits done
      if (on_rows)
        wide_match(w, match_bits, P(int32_t, st), P(int32_t, lport), P(int32_t, rport),
                   P(int32_t, rhost), row0, S, on_rows, lane);
      __syncwarp();
    }
    if (!active) continue;

    // ---- select the true next event: queue head vs defer-FIFO head ----
    const bool q_valid = qcount > 0;
    const int64_t q_time_v = qhead;
    const bool fh_has = a.use_netstack && f_head < f_cnt;
    if (!(q_valid && q_time_v < we) && !fh_has) {  // no event: the row ends
      active = false;
      continue;
    }
    // the queue's candidate is the row's next list entry; past the list
    // the head is at or past the window end and its tie is never compared
    const bool q_listed = qi < n_listed;
    int q_slot = 0;
    int64_t q_tie_v = I64_MAX, fh_t = TIME_MAX, fh_tie = I64_MAX;
    if constexpr (WIDE) {
      if (q_listed) {
        const int q_e = v.list(qi, lane);
        q_slot = v.slot(lane, q_e);
        q_tie_v = v.tie(lane, q_e);
      }
      if (fh_has) {
        fh_t = wf_time(v, fifo, f_head, lane);
        fh_tie = wf_tie(v, fifo, f_head, lane);
      }
    } else {
      const int q_e = q_listed ? w.list[qi][lane] : 0;
      q_slot = q_listed ? w.st_slot[lane][q_e] : 0;
      q_tie_v = q_listed ? w.st_tie[lane][q_e] : I64_MAX;
      fh_t = fh_has ? w.f_time[f_head][lane] : TIME_MAX;
      fh_tie = fh_has ? w.f_tie[f_head][lane] : I64_MAX;
    }
    const bool use_f = fh_has && (!q_valid || fh_t < q_time_v ||
                                  (fh_t == q_time_v && fh_tie < q_tie_v));
    const int64_t ev_time = use_f ? fh_t : q_time_v;
    const bool ev_valid = (use_f || q_valid) && ev_time < we;
    if (!ev_valid) {  // nothing taken: the row ends (alive = false)
      active = false;
      continue;
    }
    // the payload: the list entry's, or for a FIFO entry that of the
    // entry it deferred (a wide entry past the first pass: its own)
    const int64_t ev_tie = use_f ? fh_tie : q_tie_v;
    int32_t ev_kind, ev_aux;
    int32_t ev_data[LANES];
    int src = qi;
    if constexpr (WIDE) {
      if (use_f) {
        wf_payload(v, fifo, f_head, lane, ev_kind, ev_aux, ev_data);
      } else {
        ev_kind = v.kind(qi, lane);
        ev_aux = v.aux(qi, lane);
        for (int l = 0; l < LANES; ++l) ev_data[l] = v.data(lane, qi)[l];
      }
    } else {
      src = use_f ? w.f_src[f_head][lane] : qi;
      ev_kind = w.p_kind[src][lane];
      ev_aux = use_f ? w.f_aux[f_head][lane] : w.p_aux[src][lane];
      for (int l = 0; l < LANES; ++l) ev_data[l] = w.p_data[lane][src * LANES + l];
    }
    const int32_t ev_src = int32_t((ev_tie >> 32) & ((1 << 30) - 1));
    const int64_t now = ev_time;

    const bool is_pkt = ev_kind == KIND_PACKET;
    const int64_t size_in = int64_t(ev_aux) & AUX_SIZE_MASK;
    const bool shaped = (ev_aux & AUX_SHAPED_BIT) != 0;
    const bool loopback = ev_src == host_id;
    const bool in_bootstrap = ev_time < a.bootstrap_end_ns;

    // ---- ingress relay / CoDel (tentative) ----
    bool need = false, codel_drop = false, defer = false, p1_take = false, keep_in = false;
    bool arrived = is_pkt;
    int64_t ready = ev_time, rx_tok2 = rx_tokens, rx_last2 = rx_last;
    int64_t n_first = cd_first, n_next = cd_next;
    int32_t n_count = cd_count;
    bool n_dropping = cd_dropping;
    if (a.use_netstack) {
      need = is_pkt && !shaped && !loopback && !in_bootstrap && rx_refill > 0;
      tb_depart(rx_tokens, rx_last, rx_refill, ev_time, size_in, need, ready, rx_tok2,
                rx_last2);
      // codel_dequeue(net, ready, sojourn, need)
      const int64_t sojourn = ready - ev_time;
      const bool below = sojourn < CODEL_TARGET_NS || rx_backlog < MTU_BYTES;
      const bool unset = cd_first < 0;
      int64_t new_first = below ? -1 : (unset ? ready + CODEL_INTERVAL_NS : cd_first);
      const bool ok_to_drop = !below && !unset && ready >= cd_first;
      const bool leave = cd_dropping && !ok_to_drop;
      const bool drop_in_ep = cd_dropping && ok_to_drop && ready >= cd_next;
      const int32_t count_in = cd_count + (drop_in_ep ? 1 : 0);
      const int64_t next_in =
          drop_in_ep ? cd_next + codel_tab[clampi(count_in, 1, CODEL_TABLE_LEN)] : cd_next;
      const bool enter = !cd_dropping && ok_to_drop;
      const bool recent = (ready - cd_next) < CODEL_INTERVAL_NS;
      const int32_t count_enter = (recent && cd_count > 2) ? cd_count - 2 : 1;
      const int64_t next_enter = ready + codel_tab[clampi(count_enter, 1, CODEL_TABLE_LEN)];
      codel_drop = need && (drop_in_ep || enter);
      if (need) {
        n_dropping = (cd_dropping && !leave) || enter;
        n_count = enter ? count_enter : count_in;
        n_next = enter ? next_enter : next_in;
        n_first = new_first;
      }
      keep_in = need && !codel_drop;
      defer = keep_in && ready > ev_time;
      p1_take = is_pkt && !shaped && (defer || codel_drop);
      arrived = is_pkt && !(defer || codel_drop);
    }

    // ---- TCP classification: the matching slot(s) ----
    const int32_t sport = (ev_data[0] >> 16) & 0xFFFF;
    const int32_t dport = ev_data[0] & 0xFFFF;
    // the matching slots (established, not CLOSED or LISTEN, on the
    // packet's 4-tuple), for an arrived packet: a bit each in a mask
    // (narrow), or this row's bits of the warp's match bits (wide: bits
    // sk .. sk + S - 1, found at the top of the microstep)
    unsigned oh = 0;
    bool rx_exact = false;
    if constexpr (WIDE) {
      for (int wd = sk / WARP; arrived && wd <= (sk + S - 1) / WARP; ++wd)
        rx_exact = rx_exact || bits_in(match_bits[wd], wd, sk, S) != 0;
    } else {
      for (int s = 0; s < S; ++s) {
        const int32_t st_s = w.sk_st[sk + s];
        const bool ex = st_s != ST_CLOSED && st_s != ST_LISTEN && w.sk_lport[sk + s] == dport &&
                        w.sk_rhost[sk + s] == ev_src && w.sk_rport[sk + s] == sport;
        if (ex && arrived) oh |= 1u << s;
      }
      rx_exact = oh != 0;
    }
#define FOR_EACH_MATCH(s, ...)                                           \
  if constexpr (WIDE) {                                                  \
    for (int wd = sk / WARP; arrived && wd <= (sk + S - 1) / WARP; ++wd) \
      for (unsigned m_ = bits_in(match_bits[wd], wd, sk, S); m_; m_ &= m_ - 1) { \
        const int s = wd * WARP + __ffs(m_) - 1 - sk;                    \
        __VA_ARGS__                                                      \
      }                                                                  \
  } else {                                                               \
    for (unsigned m_ = oh; m_; m_ &= m_ - 1) {                           \
      const int s = __ffs(m_) - 1;                                       \
      __VA_ARGS__                                                        \
    }                                                                    \
  }
    // the one-hot reads (sums over matching slots; a row has at most one)
    int64_t v_st = 0, v_lport = 0, v_rport = 0, v_rhost = 0, v_una = 0, v_nxt = 0;
    int64_t v_max = 0, v_end = 0, v_rcv = 0, v_rfin = 0, v_cwnd = 0, v_ssth = 0;
    int64_t v_dup = 0, v_srtt = 0, v_rttvar = 0, v_rto = 0, v_rtts = 0, v_rttt = 0;
    int64_t v_exp = 0, v_tev = 0, v_dlv = 0, v_pwnd = 0;
    bool v_finp = false, v_fins = false, v_inrec = false, v_rttp = false;
    int64_t v_ooo[NR][2], v_sack[NR][2];
#pragma unroll
    for (int r = 0; r < NR; ++r) v_ooo[r][0] = v_ooo[r][1] = v_sack[r][0] = v_sack[r][1] = 0;
    FOR_EACH_MATCH(s,
      v_st += SK(st, s);
      v_lport += SK(lport, s);
      v_rport += SK(rport, s);
      v_rhost += SK(rhost, s);
      v_una += ts_una[s];
      v_nxt += ts_nxt[s];
      v_max += ts_max[s];
      v_end += ts_end[s];
      v_finp = v_finp || ts_finp[s];
      v_fins = v_fins || ts_fins[s];
      v_rcv += ts_rcv[s];
      v_rfin += ts_rfin[s];
      v_cwnd += ts_cwnd[s];
      v_ssth += ts_ssth[s];
      v_dup += ts_dup[s];
      v_inrec = v_inrec || ts_inrec[s];
      v_srtt += ts_srtt[s];
      v_rttvar += ts_rttvar[s];
      v_rto += ts_rto[s];
      v_rttp = v_rttp || ts_rttp[s];
      v_rtts += ts_rtts[s];
      v_rttt += ts_rttt[s];
      v_exp += ts_exp[s];
      v_tev += ts_tev[s];
      v_dlv += ts_dlv[s];
      v_pwnd += ts_pwnd[s];
      _Pragma("unroll")
      for (int r = 0; r < NR; ++r)
        for (int c = 0; c < 2; ++c) {
          v_ooo[r][c] += ts_ooo[(s * NR + r) * 2 + c];
          v_sack[r][c] += ts_sack[(s * NR + r) * 2 + c];
        }
    )
    // int32 fields wrap back to int32, as the reference's .astype(int32)
    v_st = int32_t(v_st);
    v_lport = int32_t(v_lport);
    v_rport = int32_t(v_rport);
    v_rhost = int32_t(v_rhost);
    v_dup = int32_t(v_dup);

    const int32_t flags = ev_data[3] & 0xFF;
    const int32_t plen = (ev_data[3] >> 8) & 0xFFFFFF;
    const bool f_ackf = (flags & FLAG_ACK) != 0;
    const bool clean_flags = f_ackf && (flags & (FLAG_SYN | FLAG_FIN | FLAG_RST)) == 0;
    const int64_t wnd = ev_data[4];
    const int64_t abs_seq = unwrap32(v_rcv, ev_data[1]);
    const int64_t abs_ack = unwrap32(v_una, ev_data[2]);
    const bool sack_present = ev_data[6] != ev_data[7];
    bool sacked_empty = true;
#pragma unroll
    for (int r = 0; r < NR; ++r) sacked_empty = sacked_empty && v_sack[r][0] < 0;
    const bool quiet = rx_exact && v_st == ST_ESTABLISHED && clean_flags && v_rfin < 0 &&
                       !v_fins && v_exp >= v_tev;

    // P2: data at a receiver
    const int64_t seg_s = abs_seq, seg_e = abs_seq + plen;
    bool p2 = quiet && plen > 0 && seg_s <= v_rcv + a.rcv_wnd && abs_ack <= v_una &&
              v_end <= v_nxt && !v_inrec && v_dup == 0 && !sack_present && sacked_empty &&
              !v_finp;
    const bool acceptable = p2 && seg_e > v_rcv;
    const bool in_order = acceptable && seg_s <= v_rcv;
    const bool ooo_seg = acceptable && !in_order;
    int64_t rcv1 = in_order ? seg_e : v_rcv;
    int64_t ooo1[NR][2];
#pragma unroll
    for (int r = 0; r < NR; ++r) ooo1[r][0] = v_ooo[r][0], ooo1[r][1] = v_ooo[r][1];
    ooo_absorb(rcv1, ooo1, in_order);
    ooo_insert(ooo1, ooo_seg, seg_s, seg_e);
    const int64_t dlv_delta = p2 ? rcv1 - v_rcv : 0;

    // P3: pure cumulative ACK advancing snd_una, outside recovery
    bool p3 = quiet && plen == 0 && !v_inrec && abs_ack > v_una && abs_ack <= v_max;

    // the model's veto (pump_spec.block). tgen: a request complete ->
    // respond must reach the handler. onion: relays never pump; a client
    // event whose delivered crossing completes a response (the next
    // stream's trigger) must reach the handler.
    bool blocked;
    if (MODEL == MODEL_ONION)
      blocked = is_role2 || (is_client && streams_done < streams_started &&
                             (v_dlv + dlv_delta) >= streams_started * a.resp_span);
    else
      blocked = is_role2 && v_st == ST_ESTABLISHED && (v_dlv + dlv_delta) >= a.req_bytes &&
                v_end == 1;
    p2 = p2 && !blocked;
    p3 = p3 && !blocked;

    // ---- P3 state update ----
    const bool m_rtt = p3 && v_rttp && abs_ack >= v_rtts;
    const bool ss = p3 && v_cwnd < v_ssth;
    const bool ca = p3 && !ss;
    const int64_t acked = p3 ? abs_ack - v_una : 0;
    int64_t cwnd1 = ss ? v_cwnd + imin(acked, mss) : v_cwnd;
    if (ca) cwnd1 = cwnd1 + imax(fdiv_rt(mss * mss, imax(cwnd1, 1)), 1);
    const int64_t una1 = p3 ? abs_ack : v_una;
    const int64_t nxt1 = p3 ? imax(v_nxt, abs_ack) : v_nxt;
    const bool outstanding = una1 < v_max;
    const int64_t expire1 = p3 ? (outstanding ? now + v_rto : TIME_MAX) : v_exp;
    const int64_t rtt = now - v_rttt;
    const bool first = v_srtt < 0;
    const int64_t rttvar1 =
        first ? fdiv(rtt, 2) : fdiv(3 * v_rttvar + (v_srtt - rtt < 0 ? rtt - v_srtt : v_srtt - rtt), 4);
    const int64_t srtt1 = first ? rtt : fdiv(7 * v_srtt + rtt, 8);
    const int64_t rto1 =
        clampi(srtt1 + imax(a.granularity_ns, 4 * rttvar1), a.rto_min_ns, a.rto_max_ns);
    const int64_t n_srtt = m_rtt ? srtt1 : v_srtt;
    const int64_t n_rttvar = m_rtt ? rttvar1 : v_rttvar;
    const int64_t n_rto = m_rtt ? rto1 : v_rto;
    const bool n_rttp = m_rtt ? false : v_rttp;

    int64_t sack2[NR][2];
#pragma unroll
    for (int r = 0; r < NR; ++r) sack2[r][0] = v_sack[r][0], sack2[r][1] = v_sack[r][1];
    if (a.use_sack) {
      const bool has_sack = p3 && sack_present;
      ooo_insert(sack2, has_sack, unwrap32(una1, ev_data[6]), unwrap32(una1, ev_data[7]));
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (p3 && sack2[r][0] >= 0 && sack2[r][1] <= una1) sack2[r][0] = sack2[r][1] = -1;
    }

    // ---- P3 send engine ----
    const int64_t peer_wnd1 = (p2 || p3) ? wnd : v_pwnd;
    const int64_t wnd_lim = una1 + imin(cwnd1, peer_wnd1);
    const int64_t fin_lim = v_end + (v_finp ? 1 : 0);
    int64_t cursor = nxt1;
    const bool can_send = p3;
    bool rp = n_rttp;
    int64_t rs = v_rtts, rt = v_rttt;
    bool sent_any = false, fin_goes = false;
    int64_t rtx_count = 0;
    bool lane_valid[NSEG], lane_fin[NSEG];
    int64_t lane_seq[NSEG];
    int32_t lane_len[NSEG];
#pragma unroll
    for (int i = 0; i < NSEG; ++i) {
      lane_valid[i] = lane_fin[i] = false;
      lane_seq[i] = lane_len[i] = 0;
      const int64_t room = imin(imin(v_end, wnd_lim), cursor + mss);
      const int64_t dlen = imax(room - cursor, 0);
      const bool send_data = can_send && dlen > 0;
      const bool send_fin = can_send && !send_data && v_finp && cursor == v_end &&
                            cursor + 1 <= wnd_lim && !fin_goes;
      lane_valid[i] = send_data || send_fin;
      lane_seq[i] = cursor;
      lane_len[i] = send_data ? int32_t(dlen) : 0;
      lane_fin[i] = send_fin;
      if (send_data && cursor < v_max) ++rtx_count;
      const bool start_rtt = send_data && cursor >= v_max && !rp;
      if (start_rtt) {
        rp = true;
        rs = cursor + dlen;
        rt = now;
      }
      cursor = cursor + (send_data ? dlen : 0) + (send_fin ? 1 : 0);
      fin_goes = fin_goes || send_fin;
      sent_any = sent_any || send_data || send_fin;
    }
    const int64_t new_nxt = can_send ? imax(nxt1, cursor) : nxt1;
    const int64_t new_max = imax(v_max, new_nxt);
    const bool arm = p3 && una1 < new_max && expire1 >= TIME_MAX && sent_any;
    const int64_t new_expire = arm ? now + n_rto : expire1;
    const bool more = can_send && imin(fin_lim, wnd_lim) > cursor;
    const bool need_tev = (p2 || p3) && new_expire < v_tev;
    p3 = p3 && !more && !need_tev;
    p2 = p2 && !need_tev;

    const bool take_tcp = p2 || p3;
    const bool take = p1_take || take_tcp;
    if (!take) {  // the full handler takes this event; the row ends
      rejected = true;
      active = false;
      continue;
    }

    // ---- consume the event from its source ----
    if (use_f) {
      f_head += 1;
    } else {
      q_time[h * Q + q_slot] = TIME_MAX;
      q_tie[h * Q + q_slot] = I64_MAX;
      qcount -= 1;
      qi += 1;
      if constexpr (WIDE)
        qhead = qi < n_listed ? v.time(lane, v.list(qi, lane)) : w.after[lane];
      else
        qhead = qi < n_listed ? w.st_time[lane][w.list[qi][lane]] : w.after[lane];
    }

    // ---- commit netstack state ----
    if (a.use_netstack) {
      const bool commit_n = need;  // take is true here
      if (commit_n && keep_in) {
        rx_tokens = rx_tok2;
        rx_last = rx_last2;
      }
      if (commit_n) {
        cd_first = n_first;
        cd_next = n_next;
        cd_count = n_count;
        cd_dropping = n_dropping;
        if (codel_drop) cd_dropped += 1;
      }
      rx_backlog += (defer ? size_in : 0) - ((take_tcp && shaped) ? size_in : 0);
      if (take_tcp) bytes_recv += size_in;
      if (defer) {  // deferred re-enqueue -> FIFO (ready is monotone per row)
        if constexpr (WIDE) {
          wf_push(v, fifo, f_cnt, lane, ready, ev_tie, ev_kind, int32_t(size_in) | AUX_SHAPED_BIT,
                  ev_data, src);
        } else {
          w.f_time[f_cnt][lane] = ready;
          w.f_tie[f_cnt][lane] = ev_tie;
          w.f_src[f_cnt][lane] = int8_t(src);  // kind and data: list entry src's
          w.f_aux[f_cnt][lane] = int32_t(size_in) | AUX_SHAPED_BIT;
        }
        f_cnt += 1;
      }
    }

    // ---- commit TCP state on the matching slot(s) ----
    int64_t lane_sum = 0;
#pragma unroll
    for (int i = 0; i < NSEG; ++i) lane_sum += lane_valid[i] ? 1 : 0;
    const bool fin3 = p3 && fin_goes;
    FOR_EACH_MATCH(s,
      if (fin3) {
        ts_st[s] = ST_FINWAIT1;
        if constexpr (!WIDE) w.sk_st[sk + s] = ST_FINWAIT1;
        ts_fins[s] = 1;
      }
      if (p3) {
        ts_una[s] = una1;
        ts_nxt[s] = new_nxt;
        ts_max[s] = new_max;
        ts_cwnd[s] = cwnd1;
        ts_dup[s] = 0;
        ts_boff[s] = 0;
        ts_exp[s] = new_expire;
        ts_srtt[s] = n_srtt;
        ts_rttvar[s] = n_rttvar;
        ts_rto[s] = n_rto;
        ts_rttp[s] = rp ? 1 : 0;
        ts_rtts[s] = rs;
        ts_rttt[s] = rt;
        ts_rtx[s] += rtx_count;
        ts_sout[s] += lane_sum;
        _Pragma("unroll")
        for (int r = 0; r < NR; ++r)
          for (int c = 0; c < 2; ++c) ts_sack[(s * NR + r) * 2 + c] = sack2[r][c];
      }
      if (p2) {
        ts_rcv[s] = rcv1;
        _Pragma("unroll")
        for (int r = 0; r < NR; ++r)
          for (int c = 0; c < 2; ++c) ts_ooo[(s * NR + r) * 2 + c] = ooo1[r][c];
        ts_dlv[s] += dlv_delta;
      }
      if (take_tcp) {
        ts_pwnd[s] = peer_wnd1;
        ts_sin[s] += 1;
      }
    )
    // the model's passive bookkeeping (pump_spec.apply), the same for
    // both: the client download byte counter
    if (is_client && take_tcp) bytes_down += dlv_delta;

    if (take_tcp) {
      // ---- emissions: P3 data/FIN lanes; the P2 ACK rides lane 0 ----
      const int64_t dst = clampi(v_rhost, 0, a.num_global_hosts - 1);
      const int64_t dst_node = host_node[dst];
      const int64_t lat = lat_ns[src_node * a.N + dst_node];
      const float rel = relt[src_node * a.N + dst_node];
      const bool loopb = dst == host_id;
      const bool in_btx = now < a.bootstrap_end_ns;
      int64_t sack_s = 0, sack_e = 0;
      if (a.use_sack) {  // lowest buffered out-of-order range
        int64_t min_start = int64_t(1) << 62;
        bool has_blk = false;
#pragma unroll
        for (int r = 0; r < NR; ++r)
          if (ooo1[r][0] >= 0) {
            has_blk = true;
            min_start = imin(min_start, ooo1[r][0]);
          }
        int64_t blk_e = -1;
#pragma unroll
        for (int r = 0; r < NR; ++r)
          if (ooo1[r][0] >= 0 && ooo1[r][0] == min_start) blk_e = imax(blk_e, ooo1[r][1]);
        if (has_blk) {
          sack_s = min_start;
          sack_e = blk_e;
        }
      }
      bool lv[NSEG], kept[NSEG], unr[NSEG];
      int64_t lsz[NSEG];
      int32_t ldata[NSEG][LANES];
#pragma unroll
      for (int l = 0; l < NSEG; ++l) {
        lv[l] = kept[l] = unr[l] = false;
        lsz[l] = 0;
        const bool use_ack = p2 && l == 0;
        lv[l] = (lane_valid[l] && p3) || use_ack;
        const int32_t lflags = lane_fin[l] ? (FLAG_FIN | FLAG_ACK) : FLAG_ACK;
        const int32_t len = use_ack ? 0 : lane_len[l];
        ldata[l][0] = int32_t((uint32_t(v_lport) << 16) | (uint32_t(v_rport) & 0xFFFFu));
        ldata[l][1] = to_wire32(use_ack ? new_nxt : lane_seq[l]);
        ldata[l][2] = to_wire32(rcv1);
        ldata[l][3] = int32_t((uint32_t(lflags) & 0xFFu) | (uint32_t(len) << 8));
        ldata[l][4] = int32_t(a.rcv_wnd);
        ldata[l][5] = 0;
        ldata[l][6] = to_wire32(use_ack ? sack_s : 0);
        ldata[l][7] = to_wire32(use_ack ? sack_e : 0);
        lsz[l] = int64_t(len) + a.header_bytes;
        unr[l] = lv[l] && lat >= TIME_MAX;
        // loss draw at the handler's lane index (P2's ACK: the control
        // lane), made only for a lane that emits (no other lane reads it)
        // on a lossy path (a uniform in [0, 1) is below a reliability >= 1)
        const int64_t draw_lane = p2 ? NSEG : l;
        const uint32_t ctr = uint32_t((rng_counter + a.draws_per_event + draw_lane) & MASK32);
        const bool pass = lv[l] && (rel >= 1.0f || uniform_draw(key0, key1, ctr) < rel);
        kept[l] = lv[l] && !unr[l] && pass;
        if (lv[l] && !unr[l] && !pass) ++pk_drop;
        if (unr[l]) ++pk_unr;
      }
      int64_t deliver[NSEG];
      if (a.use_netstack) {
        // closed-form multi-lane token bucket (netstack.tb_depart_lanes)
        const int64_t safe = imax(tx_refill, 1);
        const int64_t cap = tx_refill + MTU_BYTES;
        const int64_t intervals = fdiv(imax(now - tx_last, 0), REFILL_INTERVAL_NS);
        const int64_t cur = imin(cap, tx_tokens + intervals * safe);
        const int64_t cur_last = tx_last + intervals * REFILL_INTERVAL_NS;
        int64_t pref = 0, k_prev = 0, k_last = 0, p_last = 0;
        bool any_charged = false;
#pragma unroll
        for (int l = 0; l < NSEG; ++l) {
          deliver[l] = 0;
          const bool limited =
              lv[l] && !unr[l] && !loopb && !in_btx && tx_refill > 0;
          pref += limited ? lsz[l] : 0;
          const int64_t deficit = imax(pref - cur, 0);
          const int64_t k = fdiv_rt(deficit + (safe - 1), safe);
          const int64_t seq_deficit = pref - cur - k_prev * safe;
          const int64_t dep =
              (limited && seq_deficit > 0) ? cur_last + k * REFILL_INTERVAL_NS : now;
          deliver[l] = imax(dep + lat, we);
          if (limited) {
            any_charged = true;
            k_last = imax(k_last, k);
            p_last = imax(p_last, pref);
          }
          k_prev = k;
        }
        if (any_charged) {
          tx_tokens = cur + k_last * safe - p_last;
          tx_last = k_last > 0 ? cur_last + k_last * REFILL_INTERVAL_NS : cur_last;
        }
#pragma unroll
        for (int l = 0; l < NSEG; ++l)
          if (kept[l]) bytes_sent += lsz[l];
      } else {
#pragma unroll
        for (int l = 0; l < NSEG; ++l) deliver[l] = imax(now + lat, we);
      }
      // outbox append in lane order
#pragma unroll
      for (int l = 0; l < NSEG; ++l) {
        if (!kept[l]) continue;
        if (obfill < O) {
          const int at = obfill;
          obv[at] = 1;
          obd[at] = int32_t(dst);
          obt[at] = deliver[l];
          obtie[at] = (int64_t(host_id & ((1 << 30) - 1)) << 32) | (seq & MASK32);
          for (int j = 0; j < LANES; ++j) obdata[at * LANES + j] = ldata[l][j];
          obaux[at] = int32_t(lsz[l]) & int32_t(AUX_SIZE_MASK);
          obfill += 1;
        } else {
          obover += 1;
        }
        seq = (seq + 1) & MASK32;
        ++pk_sent;
        if (a.tracker) {
          if (lsz[l] <= a.header_bytes) trk_ctrl += lsz[l];
          else trk_data += lsz[l];
        }
        if (a.dyn_runahead && dst != host_id && lat < TIME_MAX)
          min_used_local = imin(min_used_local, lat);
      }
      if (a.tracker && p3) trk_rtx += rtx_count;
      events += 1;
      rng_counter = (rng_counter + a.draws_per_event + a.packet_emits) & MASK32;
    }
  }
  if (!live) return;

  // ---- C. leftover defers land in the row's free columns, in column
  // order (push_self_lanes: the l-th valid entry goes to the l-th free
  // slot); the free columns after the pops are those found in A and the
  // popped slots ----
  if constexpr (WIDE) {
  if (f_head < f_cnt) {
    // the free columns recorded in the row's last read (its first C, if
    // it has that many) merged with the slots its pass popped; past the
    // last recorded one, the row's `time` row is scanned from there
    const int room = int(Q - qcount);
    const int C = w.lay.C;
    const int nf = imin(w.n_free[lane], C);
    const int last = w.n_free[lane] >= C ? v.free_col(lane, C - 1) : int(Q);
    int rank = 0, prev = -1, fi = 0;
    int32_t over = 0;
    int64_t head_new = TIME_MAX;
    for (int k = f_head; k < f_cnt; ++k) {
      const int64_t tk = wf_time(v, fifo, k, lane);
      if (tk >= TIME_MAX || rank >= room) {  // the free-slot marker is never pushed
        ++over;
        continue;
      }
      while (fi < nf && v.free_col(lane, fi) <= prev) ++fi;
      int col = fi < nf ? v.free_col(lane, fi) : int(Q);  // the next free column after `prev`
      for (int i = 0; i < qi; ++i) {
        const int c = v.slot(lane, v.list(i, lane));
        if (c > prev && c < col) col = c;
      }
      if (col > last) {
        int c = (prev > last ? prev : last) + 1;
        while (c < Q && q_time[h * Q + c] != TIME_MAX) ++c;
        col = c;
      }
      if (col >= int(Q)) {  // none: the count disagrees with the slots
        ++over;
        continue;
      }
      ++rank;
      prev = col;
      int32_t kind, aux, data[LANES];
      wf_payload(v, fifo, k, lane, kind, aux, data);
      const int64_t at = h * Q + col;
      q_time[at] = tk;
      q_tie[at] = wf_tie(v, fifo, k, lane);
      P(int32_t, q_kind)[at] = kind;
      for (int l = 0; l < LANES; ++l) P(int32_t, q_data)[at * LANES + l] = data[l];
      P(int32_t, q_aux)[at] = aux;
      head_new = imin(head_new, tk);
    }
    qcount += rank;
    if (over) P(int32_t, q_overflow)[h] += over;
    qhead = imin(qhead, head_new);
  }
  } else {
  if (f_head < f_cnt) {
    const int room = int(Q - qcount);
    const int nf = imin(w.n_free[lane], MAX_K);
    int rank = 0, prev = -1;
    int32_t over = 0;
    int64_t head_new = TIME_MAX;
    for (int k = f_head; k < f_cnt; ++k) {
      const int64_t tk = w.f_time[k][lane];
      if (tk >= TIME_MAX || rank >= room) {  // the free-slot marker is never pushed
        ++over;
        continue;
      }
      int col = int(Q);  // the next free column after `prev`
      for (int i = 0; i < nf; ++i) {
        const int c = w.free_col[lane][i];
        if (c > prev && c < col) col = c;
      }
      for (int i = 0; i < qi; ++i) {
        const int c = w.st_slot[lane][w.list[i][lane]];
        if (c > prev && c < col) col = c;
      }
      if (col == int(Q)) {  // none: the count disagrees with the slots
        ++over;
        continue;
      }
      ++rank;
      prev = col;
      const int src = w.f_src[k][lane];
      const int64_t at = h * Q + col;
      q_time[at] = tk;
      q_tie[at] = w.f_tie[k][lane];
      P(int32_t, q_kind)[at] = w.p_kind[src][lane];
      for (int l = 0; l < LANES; ++l) P(int32_t, q_data)[at * LANES + l] = w.p_data[lane][src * LANES + l];
      P(int32_t, q_aux)[at] = w.f_aux[k][lane];
      head_new = imin(head_new, tk);
    }
    qcount += rank;
    if (over) P(int32_t, q_overflow)[h] += over;
    qhead = imin(qhead, head_new);
  }
  }

  P(int32_t, q_count)[h] = qcount;
  P(int64_t, q_head)[h] = qhead;
  P(int64_t, seq)[h] = seq;
  P(int64_t, rng_counter)[h] = rng_counter;
  P(int64_t, events_handled)[h] = events;
  P(int64_t, packets_sent)[h] = pk_sent;
  P(int64_t, packets_dropped)[h] = pk_drop;
  P(int64_t, packets_unroutable)[h] = pk_unr;
  P(int32_t, ob_fill)[h] = obfill;
  P(int32_t, ob_overflow)[h] = obover;
  P(int64_t, tx_tokens)[h] = tx_tokens;
  P(int64_t, tx_last)[h] = tx_last;
  P(int64_t, rx_tokens)[h] = rx_tokens;
  P(int64_t, rx_last)[h] = rx_last;
  P(int64_t, codel_first_above)[h] = cd_first;
  P(int64_t, codel_drop_next)[h] = cd_next;
  P(int32_t, codel_count)[h] = cd_count;
  P(uint8_t, codel_dropping)[h] = cd_dropping ? 1 : 0;
  P(int64_t, rx_backlog)[h] = rx_backlog;
  P(int64_t, codel_dropped)[h] = cd_dropped;
  P(int64_t, bytes_sent)[h] = bytes_sent;
  P(int64_t, bytes_recv)[h] = bytes_recv;
  P(int64_t, bytes_down)[h] = bytes_down;
  if (a.tracker) {
    P(int64_t, trk_bytes_ctrl)[h] = trk_ctrl;
    P(int64_t, trk_bytes_data)[h] = trk_data;
    P(int64_t, trk_retrans)[h] = trk_rtx;
  }
  const int64_t replica = h / a.rows_per_replica;
  if (min_used_local < TIME_MAX)
    atomicMin(reinterpret_cast<long long *>(a.min_used) + replica, (long long)min_used_local);
  if (rejected) P(int32_t, rejected)[replica] = 1;
}

#undef SK
#undef FOR_EACH_MATCH
#undef P

}  // namespace

extern "C" {

// Launch the instance of args->model (narrow, or wide when args->wide)
// on `stream` (PyTorch's current stream); returns cudaGetLastError(), or
// cudaErrorInvalidValue for a model, pump_k or socket count no instance
// is built for. A wide launch takes WideLayout's dynamic shared memory,
// its limit raised to that first.
int pump_megakernel_launch(const PumpArgs *args, void *stream) {
  const int64_t blocks = (args->H + ROWS_PER_WARP - 1) / ROWS_PER_WARP;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool narrow = !args->wide && args->pump_k <= MAX_K;
  if (args->wide && (args->model == MODEL_TGEN || args->model == MODEL_ONION)) {
    const int bytes = int(wide_layout(args->pump_k, args->S).bytes);
    const auto kernel = args->model == MODEL_TGEN ? pump_megakernel<MODEL_TGEN, true>
                                                  : pump_megakernel<MODEL_ONION, true>;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return int(e);
    if (args->model == MODEL_TGEN)
      pump_megakernel<MODEL_TGEN, true><<<blocks, WARP, bytes, st>>>(*args);
    else
      pump_megakernel<MODEL_ONION, true><<<blocks, WARP, bytes, st>>>(*args);
  } else if (narrow && args->model == MODEL_TGEN && args->S <= max_sockets<MODEL_TGEN>())
    pump_megakernel<MODEL_TGEN, false><<<blocks, WARP, 0, st>>>(*args);
  else if (narrow && args->model == MODEL_ONION && args->S <= max_sockets<MODEL_ONION>())
    pump_megakernel<MODEL_ONION, false><<<blocks, WARP, 0, st>>>(*args);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

// The dynamic shared memory a launch with these arguments takes, bytes
// (0 for a narrow instance, whose shared memory is all static).
int pump_megakernel_dynamic_smem(const PumpArgs *args) {
  return args->wide ? int(wide_layout(args->pump_k, args->S).bytes) : 0;
}

int pump_megakernel_args_size() { return int(sizeof(PumpArgs)); }

}  // extern "C"
