// Pump megakernel for Hopper (sm_90a): `pump_k` packet-pump microsteps
// per host row in one launch, followed by the row's carry landing.
//
// Replaces the TPU kernel shadow_tpu/engine/megakernel.py::_launch (the
// package's one pl.pallas_call), whose body is
// shadow_tpu/engine/pump.py::pump_microstep. The plain PyTorch twin of
// this file is shadow_tpu_torch/engine/pump.py::pump_stage; every
// statement below has its counterpart there, and the two are held
// leaf-equal on the card (chip_smoke.py) and on the CPU through the JAX
// reference (tests/test_torch_megakernel.py).
//
// Design. One thread owns one host row and runs the microsteps as
// scalar code: pick the true next event (queue head by (time, tie)
// argmin, first slot wins a tie, vs the defer-FIFO head), then P1
// (ingress token bucket + CoDel: defer or drop), P2 (receiver data,
// in-order or out-of-order, SACK-carrying ACK) or P3 (sender cumulative
// ACK, Reno step, RTT/RTO, SACK scoreboard, send-engine lanes with
// threefry loss draws); anything else marks the row rejected and stops
// it. A row whose event is not taken stops early: every write of a
// later microstep is masked by `alive`, so stopping is bit-exact. The
// defer FIFO lives in registers/local memory; at the end its leftovers
// land in the row's own queue slots (push_self_lanes semantics). All
// state is updated in place in global memory. The [H, Q] queue stays in
// global memory: a microstep reads a row's time/tie only when the row
// has an event to select, and rescans `time` only after it consumes a
// queue slot (the head_time cache is kept exactly).
//
// What bounds it: memory. A microstep does a few hundred integer
// operations per live host against several KB of row state, so the
// least time is the bytes the live rows must move over the card's
// memory rate (3.35 TB/s on an H100 SXM). Each live host reads its
// queue keys (Q x 16 B) plus the gathered slot, its [S] flow-table row
// (~1.6 KB with the [S, R, 2] range sets) and counters, and writes back
// what it changes; streaming the whole 26.7 KB/host carry in and out is
// the upper reckoning (~547 MB at H = 10,240). The design keeps each
// row's working set in one thread so that nothing is re-read from
// device memory between microsteps except the queue keys.
//
// Integer semantics follow jax under x64: i64 floor division (fdiv),
// wrapping u32 counters held in i64, arithmetic shifts on i32 lanes,
// int32 wire lanes built from u32 bit patterns. Floats: the loss
// uniform is bitcast(bits >> 9 | 0x3F800000) - 1.0f, compared with an
// f32 path reliability; no multiply-add is formed.

#include <cstdint>
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
constexpr int MAX_S = 8, MAX_R = 8, MAX_K = 16, MAX_SEG = 8;

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
  // tgen model state [H]
  void *bytes_down;
  // outbox [H, O] (+ [H, O, 8] data), [H]
  void *ob_valid, *ob_dst, *ob_time, *ob_tie, *ob_data, *ob_aux, *ob_fill, *ob_overflow;
  // per-host counters [H]
  void *seq, *rng_counter, *events_handled, *packets_sent, *packets_dropped;
  void *packets_unroutable;
  // tracker lanes [H] (unused when tracker == 0)
  void *trk_bytes_ctrl, *trk_bytes_data, *trk_retrans;
  // scalars: window_end (i64, read), min_used_lat (i64, atomicMin),
  // rejected flag (i32, set to 1 by any row the pump could not finish)
  void *window_end, *min_used, *rejected;
  // read-only context
  void *host_id, *rng_key, *host_node, *lat_ns, *rel, *codel_table;
  // shapes and static parameters
  int64_t H, Q, O, S, R, N, num_global_hosts, pump_k;
  int64_t bootstrap_end_ns;
  int64_t use_netstack, use_sack, tracker, dyn_runahead;
  int64_t num_clients, num_servers, req_bytes;
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
  const int64_t k = fdiv(deficit + safe - 1, safe);
  const int64_t wait_end = cur_last + k * REFILL_INTERVAL_NS;
  depart = limited ? (deficit > 0 ? wait_end : now) : now;
  tokens_out = limited ? cur + k * safe - size : tokens;
  last_out = limited ? (deficit > 0 ? wait_end : cur_last) : last;
}

// [R, 2] range-set helpers (transport/tcp.py _ooo_absorb / _ooo_insert)
__device__ void ooo_absorb(int64_t &rcv, int64_t (*ooo)[2], int R, bool m) {
  for (int it = 0; it < R; ++it) {
    int64_t reach = -1;
    bool hit[MAX_R];
    for (int r = 0; r < R; ++r) {
      hit[r] = m && ooo[r][0] >= 0 && ooo[r][0] <= rcv;
      if (hit[r]) reach = imax(reach, ooo[r][1]);
    }
    rcv = imax(rcv, reach);
    for (int r = 0; r < R; ++r)
      if (hit[r]) ooo[r][0] = ooo[r][1] = -1;
  }
}
__device__ void ooo_insert(int64_t (*ooo)[2], int R, bool m, int64_t s, int64_t e) {
  int64_t ms = int64_t(1) << 60, me = -1;
  bool overlap[MAX_R], avail[MAX_R];
  int ins = -1;
  for (int r = 0; r < R; ++r) {
    const bool empty = ooo[r][0] < 0;
    overlap[r] = m && !empty && s <= ooo[r][1] && e >= ooo[r][0];
    if (overlap[r]) {
      ms = imin(ms, ooo[r][0]);
      me = imax(me, ooo[r][1]);
    }
    avail[r] = overlap[r] || (empty && m);
    if (avail[r] && ins < 0) ins = r;
  }
  ms = imin(s, ms);
  me = imax(e, me);
  for (int r = 0; r < R; ++r)
    if (overlap[r]) ooo[r][0] = ooo[r][1] = -1;
  if (m && ins >= 0) {
    ooo[ins][0] = ms;
    ooo[ins][1] = me;
  }
}

struct Fifo {
  int64_t time[MAX_K], tie[MAX_K];
  int32_t kind[MAX_K], aux[MAX_K], data[MAX_K][LANES];
  int head, cnt;
};

#define P(type, name) (reinterpret_cast<type *>(a.name))

__global__ void pump_megakernel(const PumpArgs a) {
  const int64_t h = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const int S = int(a.S), R = int(a.R), Q = int(a.Q), O = int(a.O);
  const int nseg = int(a.segs_per_flush);
  const int64_t we = *reinterpret_cast<const int64_t *>(a.window_end);
  const int64_t mss = a.mss;

  // queue row
  int64_t *qt = P(int64_t, q_time) + h * Q;
  int64_t *qtie = P(int64_t, q_tie) + h * Q;
  int32_t *qkind = P(int32_t, q_kind) + h * Q;
  int32_t *qdata = P(int32_t, q_data) + h * Q * LANES;
  int32_t *qaux = P(int32_t, q_aux) + h * Q;
  int32_t &qcount = P(int32_t, q_count)[h];
  int64_t &qhead = P(int64_t, q_head)[h];

  // flow-table row base
  const int64_t hs = h * S;
  int32_t *ts_st = P(int32_t, st) + hs;
  int32_t *ts_lport = P(int32_t, lport) + hs;
  int32_t *ts_rport = P(int32_t, rport) + hs;
  int32_t *ts_rhost = P(int32_t, rhost) + hs;
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
  int64_t *ts_ooo = P(int64_t, ooo) + hs * R * 2;
  int64_t *ts_sack = P(int64_t, sacked) + hs * R * 2;
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

  // outbox row
  uint8_t *obv = P(uint8_t, ob_valid) + h * O;
  int32_t *obd = P(int32_t, ob_dst) + h * O;
  int64_t *obt = P(int64_t, ob_time) + h * O;
  int64_t *obtie = P(int64_t, ob_tie) + h * O;
  int32_t *obdata = P(int32_t, ob_data) + h * O * LANES;
  int32_t *obaux = P(int32_t, ob_aux) + h * O;

  // per-row context
  const int32_t host_id = P(int32_t, host_id)[h];
  const uint32_t key0 = uint32_t(P(int64_t, rng_key)[2 * h]);
  const uint32_t key1 = uint32_t(P(int64_t, rng_key)[2 * h + 1]);
  const int32_t *host_node = P(int32_t, host_node);
  const int64_t src_node = host_node[host_id];
  const int64_t *lat_ns = P(int64_t, lat_ns);
  const float *relt = P(float, rel);
  const int64_t *codel_tab = P(int64_t, codel_table);
  const bool is_client = host_id < a.num_clients;
  const bool is_server = host_id >= a.num_clients && host_id < a.num_clients + a.num_servers;

  // per-row mutable scalars, written back at the end
  int64_t seq = P(int64_t, seq)[h];
  int64_t rng_counter = P(int64_t, rng_counter)[h];
  int64_t events = P(int64_t, events_handled)[h];
  int64_t pk_sent = P(int64_t, packets_sent)[h];
  int64_t pk_drop = P(int64_t, packets_dropped)[h];
  int64_t pk_unr = P(int64_t, packets_unroutable)[h];
  int32_t obfill = P(int32_t, ob_fill)[h];
  int32_t obover = P(int32_t, ob_overflow)[h];
  int64_t tx_refill = P(int64_t, tx_refill)[h];
  int64_t tx_tokens = P(int64_t, tx_tokens)[h];
  int64_t tx_last = P(int64_t, tx_last)[h];
  int64_t rx_refill = P(int64_t, rx_refill)[h];
  int64_t rx_tokens = P(int64_t, rx_tokens)[h];
  int64_t rx_last = P(int64_t, rx_last)[h];
  int64_t cd_first = P(int64_t, codel_first_above)[h];
  int64_t cd_next = P(int64_t, codel_drop_next)[h];
  int32_t cd_count = P(int32_t, codel_count)[h];
  bool cd_dropping = P(uint8_t, codel_dropping)[h] != 0;
  int64_t rx_backlog = P(int64_t, rx_backlog)[h];
  int64_t cd_dropped = P(int64_t, codel_dropped)[h];
  int64_t bytes_sent = P(int64_t, bytes_sent)[h];
  int64_t bytes_recv = P(int64_t, bytes_recv)[h];
  int64_t bytes_down = P(int64_t, bytes_down)[h];
  int64_t trk_ctrl = 0, trk_data = 0, trk_rtx = 0;
  if (a.tracker) {
    trk_ctrl = P(int64_t, trk_bytes_ctrl)[h];
    trk_data = P(int64_t, trk_bytes_data)[h];
    trk_rtx = P(int64_t, trk_retrans)[h];
  }
  int64_t min_used_local = TIME_MAX;
  bool rejected = false;

  Fifo f;
  f.head = 0;
  f.cnt = 0;

  for (int step = 0; step < int(a.pump_k); ++step) {
    // ---- select the true next event: queue head vs defer-FIFO head ----
    const bool q_valid = qcount > 0;
    const int64_t q_time_v = qhead;
    const bool fh_has = a.use_netstack && f.head < f.cnt;
    if (!(q_valid && q_time_v < we) && !fh_has) break;  // no event: row ends
    int q_slot = 0;
    int64_t q_tie_v = I64_MAX;
    {
      int64_t best = I64_MAX;
      for (int j = 0; j < Q; ++j) {
        const int64_t v = (qt[j] == q_time_v) ? qtie[j] : I64_MAX;
        if (v < best) {
          best = v;
          q_slot = j;
        }
      }
      q_tie_v = qtie[q_slot];
    }
    const int64_t fh_t = fh_has ? f.time[f.head] : TIME_MAX;
    const int64_t fh_tie = fh_has ? f.tie[f.head] : I64_MAX;
    const bool use_f = fh_has && (!q_valid || fh_t < q_time_v ||
                                  (fh_t == q_time_v && fh_tie < q_tie_v));
    const int64_t ev_time = use_f ? fh_t : q_time_v;
    const bool ev_valid = (use_f || q_valid) && ev_time < we;
    if (!ev_valid) break;  // nothing taken: the row ends (alive = false)
    const int64_t ev_tie = use_f ? fh_tie : q_tie_v;
    const int32_t ev_kind = use_f ? f.kind[f.head] : qkind[q_slot];
    const int32_t ev_aux = use_f ? f.aux[f.head] : qaux[q_slot];
    int32_t ev_data[LANES];
    for (int l = 0; l < LANES; ++l)
      ev_data[l] = use_f ? f.data[f.head][l] : qdata[q_slot * LANES + l];
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
    bool oh[MAX_S];
    bool rx_exact = false;
    for (int s = 0; s < S; ++s) {
      const bool ex = ts_st[s] != ST_CLOSED && ts_st[s] != ST_LISTEN &&
                      ts_lport[s] == dport && ts_rhost[s] == ev_src && ts_rport[s] == sport;
      oh[s] = ex && arrived;
      rx_exact = rx_exact || oh[s];
    }
    // the one-hot reads (sums over matching slots; a row has at most one)
    int64_t v_st = 0, v_lport = 0, v_rport = 0, v_rhost = 0, v_una = 0, v_nxt = 0;
    int64_t v_max = 0, v_end = 0, v_rcv = 0, v_rfin = 0, v_cwnd = 0, v_ssth = 0;
    int64_t v_dup = 0, v_srtt = 0, v_rttvar = 0, v_rto = 0, v_rtts = 0, v_rttt = 0;
    int64_t v_exp = 0, v_tev = 0, v_dlv = 0, v_pwnd = 0;
    bool v_finp = false, v_fins = false, v_inrec = false, v_rttp = false;
    int64_t v_ooo[MAX_R][2], v_sack[MAX_R][2];
    for (int r = 0; r < R; ++r) v_ooo[r][0] = v_ooo[r][1] = v_sack[r][0] = v_sack[r][1] = 0;
    for (int s = 0; s < S; ++s) {
      if (!oh[s]) continue;
      v_st += ts_st[s];
      v_lport += ts_lport[s];
      v_rport += ts_rport[s];
      v_rhost += ts_rhost[s];
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
      for (int r = 0; r < R; ++r)
        for (int c = 0; c < 2; ++c) {
          v_ooo[r][c] += ts_ooo[(s * R + r) * 2 + c];
          v_sack[r][c] += ts_sack[(s * R + r) * 2 + c];
        }
    }
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
    for (int r = 0; r < R; ++r) sacked_empty = sacked_empty && v_sack[r][0] < 0;
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
    int64_t ooo1[MAX_R][2];
    for (int r = 0; r < R; ++r) ooo1[r][0] = v_ooo[r][0], ooo1[r][1] = v_ooo[r][1];
    ooo_absorb(rcv1, ooo1, R, in_order);
    ooo_insert(ooo1, R, ooo_seg, seg_s, seg_e);
    const int64_t dlv_delta = p2 ? rcv1 - v_rcv : 0;

    // P3: pure cumulative ACK advancing snd_una, outside recovery
    bool p3 = quiet && plen == 0 && !v_inrec && abs_ack > v_una && abs_ack <= v_max;

    // tgen's veto: request complete -> respond must reach the handler
    const bool blocked = is_server && v_st == ST_ESTABLISHED &&
                         (v_dlv + dlv_delta) >= a.req_bytes && v_end == 1;
    p2 = p2 && !blocked;
    p3 = p3 && !blocked;

    // ---- P3 state update ----
    const bool m_rtt = p3 && v_rttp && abs_ack >= v_rtts;
    const bool ss = p3 && v_cwnd < v_ssth;
    const bool ca = p3 && !ss;
    const int64_t acked = p3 ? abs_ack - v_una : 0;
    int64_t cwnd1 = ss ? v_cwnd + imin(acked, mss) : v_cwnd;
    if (ca) cwnd1 = cwnd1 + imax(fdiv(mss * mss, imax(cwnd1, 1)), 1);
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

    int64_t sack2[MAX_R][2];
    for (int r = 0; r < R; ++r) sack2[r][0] = v_sack[r][0], sack2[r][1] = v_sack[r][1];
    if (a.use_sack) {
      const bool has_sack = p3 && sack_present;
      ooo_insert(sack2, R, has_sack, unwrap32(una1, ev_data[6]), unwrap32(una1, ev_data[7]));
      for (int r = 0; r < R; ++r)
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
    bool lane_valid[MAX_SEG], lane_fin[MAX_SEG];
    int64_t lane_seq[MAX_SEG];
    int32_t lane_len[MAX_SEG];
    for (int i = 0; i < nseg; ++i) {
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
      break;
    }

    // ---- consume the event from its source ----
    if (use_f) {
      f.head += 1;
    } else {
      qt[q_slot] = TIME_MAX;
      qtie[q_slot] = I64_MAX;
      qcount -= 1;
      int64_t m = TIME_MAX;
      for (int j = 0; j < Q; ++j) m = imin(m, qt[j]);
      qhead = m;
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
        const int k = f.cnt;
        f.time[k] = ready;
        f.tie[k] = ev_tie;
        f.kind[k] = ev_kind;
        for (int l = 0; l < LANES; ++l) f.data[k][l] = ev_data[l];
        f.aux[k] = int32_t(size_in) | AUX_SHAPED_BIT;
        f.cnt += 1;
      }
    }

    // ---- commit TCP state on the matching slot(s) ----
    int64_t lane_sum = 0;
    for (int i = 0; i < nseg; ++i) lane_sum += lane_valid[i] ? 1 : 0;
    const bool fin3 = p3 && fin_goes;
    for (int s = 0; s < S; ++s) {
      if (!oh[s]) continue;
      if (fin3) {
        ts_st[s] = ST_FINWAIT1;
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
        for (int r = 0; r < R; ++r)
          for (int c = 0; c < 2; ++c) ts_sack[(s * R + r) * 2 + c] = sack2[r][c];
      }
      if (p2) {
        ts_rcv[s] = rcv1;
        for (int r = 0; r < R; ++r)
          for (int c = 0; c < 2; ++c) ts_ooo[(s * R + r) * 2 + c] = ooo1[r][c];
        ts_dlv[s] += dlv_delta;
      }
      if (take_tcp) {
        ts_pwnd[s] = peer_wnd1;
        ts_sin[s] += 1;
      }
    }
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
        for (int r = 0; r < R; ++r)
          if (ooo1[r][0] >= 0) {
            has_blk = true;
            min_start = imin(min_start, ooo1[r][0]);
          }
        int64_t blk_e = -1;
        for (int r = 0; r < R; ++r)
          if (ooo1[r][0] >= 0 && ooo1[r][0] == min_start) blk_e = imax(blk_e, ooo1[r][1]);
        if (has_blk) {
          sack_s = min_start;
          sack_e = blk_e;
        }
      }
      bool lv[MAX_SEG], kept[MAX_SEG], unr[MAX_SEG];
      int64_t lsz[MAX_SEG];
      int32_t ldata[MAX_SEG][LANES];
      for (int l = 0; l < nseg; ++l) {
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
        // loss draw at the handler's lane index (P2's ACK: the control lane)
        const int64_t draw_lane = p2 ? nseg : l;
        const uint32_t ctr = uint32_t((rng_counter + a.draws_per_event + draw_lane) & MASK32);
        const float u = uniform_draw(key0, key1, ctr);
        const bool pass = u < rel;
        kept[l] = lv[l] && !unr[l] && pass;
        if (lv[l] && !unr[l] && !pass) ++pk_drop;
        if (unr[l]) ++pk_unr;
      }
      int64_t deliver[MAX_SEG];
      if (a.use_netstack) {
        // closed-form multi-lane token bucket (netstack.tb_depart_lanes)
        const int64_t safe = imax(tx_refill, 1);
        const int64_t cap = tx_refill + MTU_BYTES;
        const int64_t intervals = fdiv(imax(now - tx_last, 0), REFILL_INTERVAL_NS);
        const int64_t cur = imin(cap, tx_tokens + intervals * safe);
        const int64_t cur_last = tx_last + intervals * REFILL_INTERVAL_NS;
        int64_t pref = 0, k_prev = 0, k_last = 0, p_last = 0;
        bool any_charged = false;
        for (int l = 0; l < nseg; ++l) {
          const bool limited =
              lv[l] && !unr[l] && !loopb && !in_btx && tx_refill > 0;
          pref += limited ? lsz[l] : 0;
          const int64_t deficit = imax(pref - cur, 0);
          const int64_t k = fdiv(deficit + (safe - 1), safe);
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
        for (int l = 0; l < nseg; ++l)
          if (kept[l]) bytes_sent += lsz[l];
      } else {
        for (int l = 0; l < nseg; ++l) deliver[l] = imax(now + lat, we);
      }
      // outbox append in lane order
      for (int l = 0; l < nseg; ++l) {
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

  // ---- carry landing: leftover FIFO defers into free queue slots ----
  if (f.head < f.cnt) {
    const int room = Q - qcount;
    int written = 0, rank = 0, col = 0;
    int64_t head_new = TIME_MAX;
    int32_t over = 0;
    for (int k = f.head; k < f.cnt; ++k) {
      if (f.time[k] >= TIME_MAX) {  // the free-slot marker is never pushed
        ++over;
        continue;
      }
      if (rank++ >= room) {
        ++over;
        continue;
      }
      while (qt[col] != TIME_MAX) ++col;
      qt[col] = f.time[k];
      qtie[col] = f.tie[k];
      qkind[col] = f.kind[k];
      for (int l = 0; l < LANES; ++l) qdata[col * LANES + l] = f.data[k][l];
      qaux[col] = f.aux[k];
      head_new = imin(head_new, f.time[k]);
      ++written;
      ++col;
    }
    qcount += written;
    P(int32_t, q_overflow)[h] += over;
    qhead = imin(qhead, head_new);
  }

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
  if (min_used_local < TIME_MAX)
    atomicMin(reinterpret_cast<long long *>(a.min_used), (long long)min_used_local);
  if (rejected) *P(int32_t, rejected) = 1;
}

#undef P

}  // namespace

extern "C" {

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError().
int pump_megakernel_launch(const PumpArgs *args, void *stream) {
  const int threads = 128;
  const int blocks = int((args->H + threads - 1) / threads);
  pump_megakernel<<<blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(*args);
  return int(cudaGetLastError());
}

int pump_megakernel_args_size() { return int(sizeof(PumpArgs)); }

}  // extern "C"
