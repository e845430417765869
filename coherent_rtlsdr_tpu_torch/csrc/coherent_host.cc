// coherent_host — native host-edge runtime for coherent_rtlsdr_tpu.
//
// The reference implements its runtime in C++ (capture ring `cbuffer`
// common.h:41-149, packetizer `cpacketize` cpacketizer.cc, ZMQ publisher);
// this library provides the TPU framework's equivalents as a small C ABI
// consumed from Python via ctypes (no pybind11 in this image):
//
//   * block ring buffer: single-producer single-consumer ring of fixed-size
//     sample blocks with seqnums + nanosecond timestamps. Unlike the
//     reference's pointer-stealing ring (the documented stale-buffer race,
//     README.md:42), blocks are copied into owned slots — at 21ch x 4 MB/s
//     the copy is ~90 MB/s, irrelevant next to PCIe, and the race class is
//     gone.
//   * frame packetizer: assembles the exact wire frame (hdr0 + seqnums +
//     int8 IQ payload, cpacketizer.h:32-37) into an owned buffer and
//     publishes it on ZMQ PUB sockets (data + phase-debug), libzmq loaded
//     with dlopen (stable C ABI, no headers needed).
//   * float->int8 requantizer: the cdsp::convto8bit hot loop (cdsp.cc:51-54)
//     as portable C++ that the compiler auto-vectorizes.
//
// Build: native/Makefile -> coherent_rtlsdr_tpu/_native/libcoherent_host.so

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <dlfcn.h>

// ---------------------------------------------------------------- libzmq --

namespace zmqdl {

// Stable libzmq C ABI constants (zmq.h).
constexpr int PUB = 1;
constexpr int SUB = 2;
constexpr int SNDMORE = 2;      // unused; frames are single-part like the ref
constexpr int SUBSCRIBE = 6;    // ZMQ_SUBSCRIBE
constexpr int RCVTIMEO = 27;    // ZMQ_RCVTIMEO

using ctx_new_t = void *(*)();
using ctx_term_t = int (*)(void *);
using socket_t = void *(*)(void *, int);
using close_t = int (*)(void *);
using bind_t = int (*)(void *, const char *);
using connect_t = int (*)(void *, const char *);
using send_t = int (*)(void *, const void *, size_t, int);
using recv_t = int (*)(void *, void *, size_t, int);
using setsockopt_t = int (*)(void *, int, const void *, size_t);

struct Api {
  void *handle = nullptr;
  ctx_new_t ctx_new = nullptr;
  ctx_term_t ctx_term = nullptr;
  socket_t socket = nullptr;
  close_t close = nullptr;
  bind_t bind = nullptr;
  connect_t connect = nullptr;
  send_t send = nullptr;
  recv_t recv = nullptr;
  setsockopt_t setsockopt = nullptr;
  bool ok = false;
};

static Api &api() {
  static Api a;
  static std::once_flag once;
  std::call_once(once, [] {
    const char *names[] = {"libzmq.so.5", "libzmq.so"};
    for (const char *n : names) {
      a.handle = dlopen(n, RTLD_NOW | RTLD_GLOBAL);
      if (a.handle) break;
    }
    if (!a.handle) return;
    a.ctx_new = reinterpret_cast<ctx_new_t>(dlsym(a.handle, "zmq_ctx_new"));
    a.ctx_term = reinterpret_cast<ctx_term_t>(dlsym(a.handle, "zmq_ctx_term"));
    a.socket = reinterpret_cast<socket_t>(dlsym(a.handle, "zmq_socket"));
    a.close = reinterpret_cast<close_t>(dlsym(a.handle, "zmq_close"));
    a.bind = reinterpret_cast<bind_t>(dlsym(a.handle, "zmq_bind"));
    a.connect = reinterpret_cast<connect_t>(dlsym(a.handle, "zmq_connect"));
    a.send = reinterpret_cast<send_t>(dlsym(a.handle, "zmq_send"));
    a.recv = reinterpret_cast<recv_t>(dlsym(a.handle, "zmq_recv"));
    a.setsockopt =
        reinterpret_cast<setsockopt_t>(dlsym(a.handle, "zmq_setsockopt"));
    a.ok = a.ctx_new && a.socket && a.bind && a.connect && a.send && a.recv &&
           a.close;
  });
  return a;
}

}  // namespace zmqdl

// ------------------------------------------------------------- ring buffer --

namespace {

struct BlockRing {
  uint32_t nslots;       // power of two
  uint32_t block_bytes;  // bytes per block (all channels concatenated)
  uint32_t n_seq;        // seqnums per slot (1 = frame-level; N+1 = per-chan)
  std::vector<uint8_t> data;
  std::vector<uint64_t> seqnum;  // [nslots * n_seq]
  std::vector<int64_t> ts_ns;
  std::atomic<uint64_t> wp{0};
  std::atomic<uint64_t> rp{0};
  std::atomic<uint64_t> dropped{0};
  std::mutex mtx;
  std::condition_variable cv;
};

int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct Publisher {
  void *ctx = nullptr;
  void *data_sock = nullptr;
  void *debug_sock = nullptr;
  uint32_t globalseqn = 0;
  bool header = true;
  std::vector<uint8_t> frame;  // assembly buffer
};

#pragma pack(push, 1)
struct Hdr0 {  // include/cpacketizer.h:32-37
  uint32_t globalseqn;
  uint32_t N;
  uint32_t L;
  uint32_t unused;
};
#pragma pack(pop)

}  // namespace

extern "C" {

// ---- ring --------------------------------------------------------------

// Create with per-channel seqnum tracks: each slot carries `n_seq` seqnums
// (the reference publishes one `readcnt` per device, src/crtlsdr.cc:181-188 /
// cpacketizer.cc:142 — per-channel drop visibility requires per-channel
// counters, not one frame counter).
void *chost_ring_create_seq(uint32_t nslots_pow2, uint32_t block_bytes,
                            uint32_t n_seq) {
  if (nslots_pow2 == 0 || (nslots_pow2 & (nslots_pow2 - 1))) return nullptr;
  if (n_seq == 0) return nullptr;
  auto *r = new BlockRing();
  r->nslots = nslots_pow2;
  r->block_bytes = block_bytes;
  r->n_seq = n_seq;
  r->data.resize(size_t(nslots_pow2) * block_bytes);
  r->seqnum.resize(size_t(nslots_pow2) * n_seq);
  r->ts_ns.resize(nslots_pow2);
  return r;
}

void *chost_ring_create(uint32_t nslots_pow2, uint32_t block_bytes) {
  return chost_ring_create_seq(nslots_pow2, block_bytes, 1);
}

uint32_t chost_ring_nseq(void *rv) {
  return static_cast<BlockRing *>(rv)->n_seq;
}

void chost_ring_destroy(void *rv) { delete static_cast<BlockRing *>(rv); }

// Producer: copy a block in. Returns slot index, or -1 when the ring is
// full (the block is counted as dropped — seqnum-gap detection downstream
// mirrors the reference's documented drop behavior, README.md:42).
// Push with one seqnum per track (`seqs` has n_seq entries); n_used tracks
// carry real values, the rest repeat the last given (padding channels).
int64_t chost_ring_push_n(void *rv, const uint8_t *block,
                          const uint64_t *seqs, uint32_t n_used) {
  auto *r = static_cast<BlockRing *>(rv);
  uint64_t wp = r->wp.load(std::memory_order_relaxed);
  uint64_t rp = r->rp.load(std::memory_order_acquire);
  if (wp - rp >= r->nslots) {
    r->dropped.fetch_add(1, std::memory_order_relaxed);
    return -1;
  }
  uint32_t slot = wp & (r->nslots - 1);
  std::memcpy(&r->data[size_t(slot) * r->block_bytes], block, r->block_bytes);
  uint64_t *dst = &r->seqnum[size_t(slot) * r->n_seq];
  if (n_used > r->n_seq) n_used = r->n_seq;
  for (uint32_t i = 0; i < r->n_seq; ++i)
    dst[i] = seqs[i < n_used ? i : (n_used ? n_used - 1 : 0)];
  r->ts_ns[slot] = now_ns();
  r->wp.store(wp + 1, std::memory_order_release);
  {
    std::lock_guard<std::mutex> g(r->mtx);
    r->cv.notify_one();
  }
  return static_cast<int64_t>(slot);
}

int64_t chost_ring_push(void *rv, const uint8_t *block, uint64_t seqnum) {
  return chost_ring_push_n(rv, block, &seqnum, 1);
}

// Consumer: copy the oldest block out (blocking with timeout_ms; 0 = poll).
// `seqs` (if non-null) receives min(n_out, n_seq) per-track seqnums.
// Returns 1 on success, 0 on timeout.
int chost_ring_pop_n(void *rv, uint8_t *out, uint64_t *seqs, uint32_t n_out,
                     int64_t *ts_ns, int timeout_ms) {
  auto *r = static_cast<BlockRing *>(rv);
  uint64_t rp = r->rp.load(std::memory_order_relaxed);
  if (r->wp.load(std::memory_order_acquire) == rp) {
    if (timeout_ms <= 0) return 0;
    std::unique_lock<std::mutex> lk(r->mtx);
    if (!r->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
          return r->wp.load(std::memory_order_acquire) != rp;
        }))
      return 0;
  }
  uint32_t slot = rp & (r->nslots - 1);
  std::memcpy(out, &r->data[size_t(slot) * r->block_bytes], r->block_bytes);
  if (seqs) {
    uint32_t n = n_out < r->n_seq ? n_out : r->n_seq;
    std::memcpy(seqs, &r->seqnum[size_t(slot) * r->n_seq], 8 * size_t(n));
  }
  if (ts_ns) *ts_ns = r->ts_ns[slot];
  r->rp.store(rp + 1, std::memory_order_release);
  return 1;
}

int chost_ring_pop(void *rv, uint8_t *out, uint64_t *seqnum, int64_t *ts_ns,
                   int timeout_ms) {
  return chost_ring_pop_n(rv, out, seqnum, 1, ts_ns, timeout_ms);
}

uint64_t chost_ring_dropped(void *rv) {
  return static_cast<BlockRing *>(rv)->dropped.load();
}

uint32_t chost_ring_fill(void *rv) {
  auto *r = static_cast<BlockRing *>(rv);
  return static_cast<uint32_t>(r->wp.load() - r->rp.load());
}

// ---- DSP helpers -------------------------------------------------------

// float32 (interleaved IQ or any layout) -> int8 with scale, round-to-
// nearest, saturation. cdsp::convto8bit analog (cdsp.cc:51-54).
void chost_requantize_i8(const float *in, int8_t *out, size_t n, float scale) {
  for (size_t i = 0; i < n; ++i) {
    float v = in[i] * scale;
    v = v < -128.0f ? -128.0f : (v > 127.0f ? 127.0f : v);
    out[i] = static_cast<int8_t>(lrintf(v));
  }
}

// uint8 offset-binary -> float32, scale 1/127 (cdsp::convtosigned +
// convtofloat, cdsp.cc:21-44).
void chost_dequantize_u8(const uint8_t *in, float *out, size_t n) {
  constexpr float k = 1.0f / 127.0f;
  for (size_t i = 0; i < n; ++i) out[i] = (static_cast<int>(in[i]) - 128) * k;
}

// ---- publisher ---------------------------------------------------------

int chost_zmq_available(void) { return zmqdl::api().ok ? 1 : 0; }

void *chost_pub_create(const char *data_addr, const char *debug_addr,
                       int header) {
  auto &z = zmqdl::api();
  if (!z.ok) return nullptr;
  auto *p = new Publisher();
  p->ctx = z.ctx_new();
  p->data_sock = z.socket(p->ctx, zmqdl::PUB);
  if (z.bind(p->data_sock, data_addr) != 0) {
    z.close(p->data_sock);
    z.ctx_term(p->ctx);
    delete p;
    return nullptr;
  }
  if (debug_addr && debug_addr[0]) {
    p->debug_sock = z.socket(p->ctx, zmqdl::PUB);
    if (z.bind(p->debug_sock, debug_addr) != 0) {
      z.close(p->debug_sock);
      p->debug_sock = nullptr;
    }
  }
  p->header = header != 0;
  return p;
}

void chost_pub_destroy(void *pv) {
  auto *p = static_cast<Publisher *>(pv);
  if (!p) return;
  auto &z = zmqdl::api();
  if (p->data_sock) z.close(p->data_sock);
  if (p->debug_sock) z.close(p->debug_sock);
  if (p->ctx && z.ctx_term) z.ctx_term(p->ctx);
  delete p;
}

// Assemble + send one frame: hdr0 {gseq, N, L} + N x uint32 seqnums +
// N x L x 2 int8 payload (cpacketizer.cc:109-172 layout), then the debug
// phase factors (N complex64) on the debug socket. Returns bytes sent or -1.
int64_t chost_pub_send(void *pv, uint32_t n_channels, uint32_t block_len,
                       const uint32_t *seqnums, const int8_t *iq,
                       const float *phases_iq /* 2*N floats, may be null */) {
  auto *p = static_cast<Publisher *>(pv);
  auto &z = zmqdl::api();
  size_t payload = size_t(2) * n_channels * block_len;
  size_t len = p->header ? sizeof(Hdr0) + 4 * size_t(n_channels) + payload
                         : payload;
  p->frame.resize(len);
  uint8_t *w = p->frame.data();
  if (p->header) {
    Hdr0 h{p->globalseqn, n_channels, block_len, 0};
    std::memcpy(w, &h, sizeof(h));
    w += sizeof(h);
    std::memcpy(w, seqnums, 4 * size_t(n_channels));
    w += 4 * size_t(n_channels);
  }
  std::memcpy(w, iq, payload);
  int rc = z.send(p->data_sock, p->frame.data(), len, 0);
  if (rc < 0) return -1;
  if (p->debug_sock && phases_iq) {
    z.send(p->debug_sock, phases_iq, 8 * size_t(n_channels), 0);
  }
  p->globalseqn++;
  return static_cast<int64_t>(len);
}

uint32_t chost_pub_gseq(void *pv) {
  return static_cast<Publisher *>(pv)->globalseqn;
}

}  // extern "C"

// -------------------------------------------------------------- producers --
//
// The capture side of the runtime: an asynchronous reader thread pushing raw
// blocks into the ring — the reference's per-device `asynch_threadf`
// (src/crtlsdr.cc:44-59, librtlsdr USB callbacks) generalized to the two
// ingest transports the TPU host actually has: file replay (recorded
// captures, rate-paced to simulate a live array) and a ZMQ raw-stream
// receiver (the czmqsdr stub's intent, include/csdrdevice.h:270-272 — a
// remote capture daemon streams raw frames over the network).

namespace {

struct Producer {
  BlockRing *ring = nullptr;
  std::thread th;
  std::atomic<bool> stop{false};
  std::atomic<bool> done{false};
  std::atomic<uint64_t> pushed{0};
  std::atomic<int> error{0};
  // file replay
  std::string path;
  double rate = 0.0;  // blocks/s; <= 0 => flat out
  bool loop = false;
  // zmq receiver
  void *zctx = nullptr;
  void *zsock = nullptr;
  std::atomic<uint64_t> hdr_frames{0};   // seqnum-carrying frames received
  std::atomic<uint64_t> rejected{0};     // wrong-size/geometry messages
};

void file_producer_main(Producer *p) {
  std::vector<uint8_t> buf(p->ring->block_bytes);
  uint64_t seq = 0;
  auto next = std::chrono::steady_clock::now();
  do {
    FILE *f = std::fopen(p->path.c_str(), "rb");
    if (!f) {
      p->error.store(1);
      p->done.store(true);  // keep chost_producer_running truthful on error
      return;
    }
    while (!p->stop.load(std::memory_order_relaxed)) {
      size_t got = std::fread(buf.data(), 1, buf.size(), f);
      if (got < buf.size()) break;  // EOF or short tail
      if (p->rate > 0) {
        next += std::chrono::nanoseconds(
            static_cast<int64_t>(1e9 / p->rate));
        std::this_thread::sleep_until(next);
      }
      // A full ring counts a drop and the block is lost — exactly the
      // reference's under-load failure mode (README.md:42); downstream
      // seqnum-gap detection (pipeline/step.py) sees the jump.
      chost_ring_push(p->ring, buf.data(), ++seq);
      p->pushed.fetch_add(1, std::memory_order_relaxed);
    }
    std::fclose(f);
  } while (p->loop && !p->stop.load(std::memory_order_relaxed));
  p->done.store(true);
}

// Network ingest accepts BOTH daemon wire modes per message:
//   * raw: exactly block_bytes of u8 capture samples (the reference's -R
//     mode, src/main.cc:105,148-150) — carries NO seqnums, so a local
//     frame counter is synthesized and upstream drops are invisible;
//   * header: the reference wire frame (hdr0 {gseq, N, L} + N x u32
//     per-channel seqnums + N*L*2 int8 payload, include/cpacketizer.h:32-37)
//     — the daemon's per-device capture seqnums (the reference's `readcnt`,
//     src/cpacketizer.cc:142) are pushed into the ring's per-channel
//     tracks, so a capture-side drop on the daemon host gaps EXACTLY that
//     channel in the remote pipeline (in-pipeline gap detection stays live
//     across the network hop). Wire payload is signed int8 (u8 ^ 0x80,
//     cdsp::convtosigned); the ring carries raw u8, so the offset is
//     re-applied here (one pass, auto-vectorized).
void zmq_producer_main(Producer *p) {
  auto &z = zmqdl::api();
  const size_t payload_bytes = p->ring->block_bytes;
  const uint32_t n_tracks = p->ring->n_seq;
  // headroom for hdr0 + seqnums of up to 4096 channels
  std::vector<uint8_t> buf(payload_bytes + sizeof(Hdr0) + 4 * 4096);
  std::vector<uint64_t> seqs(n_tracks ? n_tracks : 1);
  uint64_t seq = 0;
  while (!p->stop.load(std::memory_order_relaxed)) {
    int n = z.recv(p->zsock, buf.data(), buf.size(), 0);
    if (n < 0) continue;  // RCVTIMEO poll tick
    // zmq_recv returns the FULL message size even when it truncated the
    // copy to buf.size() — anything larger than the buffer was truncated
    // and must be rejected before any length check is trusted (a hostile
    // hdr0 with huge N could otherwise pass the exact-length test while
    // the buffer holds fewer bytes: heap overflow).
    if (static_cast<size_t>(n) > buf.size()) {
      p->rejected.fetch_add(1, std::memory_order_relaxed);
      continue;
    }
    if (static_cast<size_t>(n) == payload_bytes) {  // raw block
      chost_ring_push(p->ring, buf.data(), ++seq);
      p->pushed.fetch_add(1, std::memory_order_relaxed);
      continue;
    }
    if (static_cast<size_t>(n) >= sizeof(Hdr0)) {
      Hdr0 h;
      std::memcpy(&h, buf.data(), sizeof(h));
      size_t pay = size_t(2) * h.N * h.L;
      // geometry contract: the byte count must match AND, on a
      // per-channel ring, the wire channel count must equal the ring's
      // track count — a frame with the right total bytes but the wrong
      // (N, L) split would otherwise scramble channels and mis-attribute
      // seqnums in the very path built for per-channel drop visibility.
      bool geom_ok = n_tracks <= 1 || h.N == n_tracks;
      if (geom_ok && pay == payload_bytes &&
          static_cast<size_t>(n) == sizeof(Hdr0) + 4 * size_t(h.N) + pay) {
        const uint8_t *sp = buf.data() + sizeof(Hdr0);
        uint32_t nn = h.N < seqs.size() ? h.N : uint32_t(seqs.size());
        for (uint32_t i = 0; i < nn; ++i) {
          uint32_t v;
          std::memcpy(&v, sp + 4 * size_t(i), 4);
          seqs[i] = v;
        }
        uint8_t *pl = buf.data() + sizeof(Hdr0) + 4 * size_t(h.N);
        for (size_t i = 0; i < pay; ++i) pl[i] ^= 0x80;
        chost_ring_push_n(p->ring, pl, seqs.data(), nn);
        p->pushed.fetch_add(1, std::memory_order_relaxed);
        p->hdr_frames.fetch_add(1, std::memory_order_relaxed);
        ++seq;
        continue;
      }
    }
    p->rejected.fetch_add(1, std::memory_order_relaxed);
  }
  p->done.store(true);
}

}  // namespace

extern "C" {

// Replay a raw capture file (contiguous [n_blocks x block_bytes] u8 blocks,
// each block = one ring slot: (N+1) x L x 2 interleaved IQ, ref first) into
// the ring at `rate_blocks_per_s` (<= 0 = as fast as the ring drains).
void *chost_producer_file_start(void *ring, const char *path,
                                double rate_blocks_per_s, int loop) {
  auto *p = new Producer();
  p->ring = static_cast<BlockRing *>(ring);
  p->path = path;
  p->rate = rate_blocks_per_s;
  p->loop = loop != 0;
  p->th = std::thread(file_producer_main, p);
  return p;
}

// Receive raw blocks (header-less frames of exactly block_bytes) from a ZMQ
// SUB connection and push them into the ring — the network capture daemon
// contract (reference raw mode, src/main.cc:105,148-150).
void *chost_producer_zmq_start(void *ring, const char *addr) {
  auto &z = zmqdl::api();
  if (!z.ok) return nullptr;
  auto *p = new Producer();
  p->ring = static_cast<BlockRing *>(ring);
  p->zctx = z.ctx_new();
  p->zsock = z.socket(p->zctx, zmqdl::SUB);
  int timeout = 100;
  z.setsockopt(p->zsock, zmqdl::SUBSCRIBE, "", 0);
  z.setsockopt(p->zsock, zmqdl::RCVTIMEO, &timeout, sizeof(timeout));
  if (z.connect(p->zsock, addr) != 0) {
    z.close(p->zsock);
    z.ctx_term(p->zctx);
    delete p;
    return nullptr;
  }
  p->th = std::thread(zmq_producer_main, p);
  return p;
}

uint64_t chost_producer_pushed(void *pv) {
  return static_cast<Producer *>(pv)->pushed.load();
}

// Seqnum-carrying (header) frames received by a ZMQ producer.
uint64_t chost_producer_hdr_frames(void *pv) {
  return static_cast<Producer *>(pv)->hdr_frames.load();
}

// Messages rejected for wrong size/geometry (neither a raw block of
// block_bytes nor a header frame whose hdr0 matches its length).
uint64_t chost_producer_rejected(void *pv) {
  return static_cast<Producer *>(pv)->rejected.load();
}

int chost_producer_error(void *pv) {
  return static_cast<Producer *>(pv)->error.load();
}

// Returns 1 while the producer thread is still running (file replay ends on
// EOF when not looping).
int chost_producer_running(void *pv) {
  return static_cast<Producer *>(pv)->done.load() ? 0 : 1;
}

void chost_producer_stop(void *pv) {
  auto *p = static_cast<Producer *>(pv);
  if (!p) return;
  p->stop.store(true);
  if (p->th.joinable()) p->th.join();
  if (p->zsock) zmqdl::api().close(p->zsock);
  if (p->zctx) zmqdl::api().ctx_term(p->zctx);
  delete p;
}

}  // extern "C"

// ------------------------------------------------------------- librtlsdr --
//
// The hardware capture path: drive real RTL-SDR dongles through librtlsdr
// (dlopen'd, same shim pattern as libzmq above — the tejeez fork's extra
// symbols `rtlsdr_set_dithering` / `rtlsdr_set_sample_freq_correction_f`
// are resolved when present, README.md:35-37). Behavioral contract taken
// from the reference's crtlsdr:
//
//   * enumeration by USB serial string      (src/crtlsdr.cc:70-106)
//   * order-sensitive open sequence: sample rate -> dithering OFF (MUST
//     precede tuning, src/crtlsdr.cc:121) -> center freq -> AGC -> tuner
//     gain mode/gain -> zero freq correction (src/crtlsdr.cc:112-135)
//   * per-device async capture thread released by a shared start barrier
//     so all dongles begin within one async window (src/crtlsdr.cc:44-59,
//     common.h:151-168, main.cc:252-258)
//   * retune re-disables dithering before set_center_freq
//     (src/crtlsdr.cc:142-146)
//
// Topology differs from the reference by design: instead of pointer-
// stealing rings + mutex choreography per device, each device's USB
// callback appends into a bounded per-device byte FIFO and one assembler
// thread builds combined [ref | ch1..chN] blocks (the RingSource layout)
// into the owned-slot ring. Overflow drops whole channel-blocks, keeping
// IQ framing; downstream seqnum-gap detection reports the loss.

namespace rtldl {

using get_count_t = uint32_t (*)();
using usb_strings_t = int (*)(uint32_t, char *, char *, char *);
using open_t = int (*)(void **, uint32_t);
using close_t = int (*)(void *);
using set_u32_t = int (*)(void *, uint32_t);
using set_int_t = int (*)(void *, int);
using set_f_t = int (*)(void *, float);
using reset_t = int (*)(void *);
using read_cb_t = void (*)(unsigned char *, uint32_t, void *);
using read_async_t = int (*)(void *, read_cb_t, void *, uint32_t, uint32_t);
using cancel_t = int (*)(void *);

struct Api {
  void *handle = nullptr;
  get_count_t get_device_count = nullptr;
  usb_strings_t get_device_usb_strings = nullptr;
  open_t open = nullptr;
  close_t close = nullptr;
  set_u32_t set_sample_rate = nullptr;
  set_u32_t set_center_freq = nullptr;
  set_int_t set_agc_mode = nullptr;
  set_int_t set_tuner_gain_mode = nullptr;
  set_int_t set_tuner_gain = nullptr;
  set_int_t set_freq_correction = nullptr;   // stock librtlsdr (ppm int)
  reset_t reset_buffer = nullptr;
  read_async_t read_async = nullptr;
  cancel_t cancel_async = nullptr;
  // tejeez coherent-rtlsdr fork extensions (optional symbols)
  set_int_t set_dithering = nullptr;
  set_f_t set_sample_freq_correction_f = nullptr;
  bool ok = false;
};

static Api g_api;
static std::mutex g_api_mtx;

static bool load(const char *path) {
  std::lock_guard<std::mutex> g(g_api_mtx);
  Api a;
  if (path && path[0]) {
    a.handle = dlopen(path, RTLD_NOW | RTLD_LOCAL);
  } else {
    const char *env = std::getenv("COHERENT_LIBRTLSDR");
    const char *names[] = {env, "librtlsdr.so.0", "librtlsdr.so"};
    for (const char *n : names) {
      if (!n || !n[0]) continue;
      a.handle = dlopen(n, RTLD_NOW | RTLD_LOCAL);
      if (a.handle) break;
    }
  }
  if (!a.handle) return false;
  auto sym = [&](const char *n) { return dlsym(a.handle, n); };
  a.get_device_count =
      reinterpret_cast<get_count_t>(sym("rtlsdr_get_device_count"));
  a.get_device_usb_strings =
      reinterpret_cast<usb_strings_t>(sym("rtlsdr_get_device_usb_strings"));
  a.open = reinterpret_cast<open_t>(sym("rtlsdr_open"));
  a.close = reinterpret_cast<close_t>(sym("rtlsdr_close"));
  a.set_sample_rate = reinterpret_cast<set_u32_t>(sym("rtlsdr_set_sample_rate"));
  a.set_center_freq = reinterpret_cast<set_u32_t>(sym("rtlsdr_set_center_freq"));
  a.set_agc_mode = reinterpret_cast<set_int_t>(sym("rtlsdr_set_agc_mode"));
  a.set_tuner_gain_mode =
      reinterpret_cast<set_int_t>(sym("rtlsdr_set_tuner_gain_mode"));
  a.set_tuner_gain = reinterpret_cast<set_int_t>(sym("rtlsdr_set_tuner_gain"));
  a.set_freq_correction =
      reinterpret_cast<set_int_t>(sym("rtlsdr_set_freq_correction"));
  a.reset_buffer = reinterpret_cast<reset_t>(sym("rtlsdr_reset_buffer"));
  a.read_async = reinterpret_cast<read_async_t>(sym("rtlsdr_read_async"));
  a.cancel_async = reinterpret_cast<cancel_t>(sym("rtlsdr_cancel_async"));
  a.set_dithering = reinterpret_cast<set_int_t>(sym("rtlsdr_set_dithering"));
  a.set_sample_freq_correction_f =
      reinterpret_cast<set_f_t>(sym("rtlsdr_set_sample_freq_correction_f"));
  a.ok = a.get_device_count && a.get_device_usb_strings && a.open && a.close &&
         a.set_sample_rate && a.set_center_freq && a.reset_buffer &&
         a.read_async && a.cancel_async;
  if (!a.ok) return false;
  g_api = a;  // old handle (if any) is intentionally never dlclosed
  return true;
}

static Api &api() {
  static std::once_flag once;
  std::call_once(once, [] { load(nullptr); });
  return g_api;
}

}  // namespace rtldl

namespace {

struct RtlCapture;

struct RtlDev {
  RtlCapture *owner = nullptr;
  void *dev = nullptr;   // guarded by hmtx (device thread closes it on exit)
  int index = -1;
  uint32_t gain = 0;  // tenths of dB, per dongle (config-file gains)
  bool hot = false;   // hot-added (console `add`): no collective start barrier
  std::string serial;
  std::thread th;
  std::mutex hmtx;  // guards `dev` against close-vs-setter TOCTOU
  // bounded byte FIFO: USB callback -> assembler
  std::mutex mtx;
  std::condition_variable cv;
  std::vector<uint8_t> fifo;
  size_t fifo_cap = 0;
  // capture-order accounting (guarded by mtx): `removed` counts whole
  // channel-blocks taken off the FIFO front — consumed by the assembler OR
  // dropped on overflow — so the next consumed block's capture seqnum is
  // removed + 1. This is the per-device `readcnt` the reference publishes
  // (src/crtlsdr.cc:181-188): a FIFO drop gaps THIS channel's seqnums only.
  uint64_t removed = 0;
  std::atomic<uint64_t> dropped_blocks{0};
  std::atomic<int> open_rc{kOpenPending};
  std::atomic<bool> thread_done{false};
  static constexpr int kOpenPending = -1000;
};

struct RtlCapture {
  BlockRing *ring = nullptr;
  std::vector<std::unique_ptr<RtlDev>> devs;  // [0] = reference channel
  std::mutex devs_mtx;  // guards devs; assembler holds it per frame
  // COUNT of waiters that want devs_mtx with priority (add/del/stop and
  // every DevsLock below). A counter, not a bool: two concurrent waiters
  // must not wipe each other's flag when the first one clears it, or the
  // second is re-exposed to the assembler's 200 ms-hold loop.
  std::atomic<int> mutate_pending{0};
  std::thread assembler;
  std::atomic<bool> stop{false};
  std::atomic<bool> done{false};
  std::atomic<int> error{0};
  std::atomic<uint64_t> pushed{0};
  std::atomic<uint64_t> stalls{0};  // frames abandoned on device timeout
  std::atomic<uint32_t> spawned{0}, exited{0};  // device-thread liveness
  uint32_t chan_bytes = 0;  // 2 * block_len (one channel-block)
  uint32_t max_chans = 0;   // ring block_bytes / chan_bytes (hot-add capacity)
  uint32_t asyncbufn = 8;
  uint32_t fs = 0, fcenter = 0, gain = 0, ref_gain = 0;
  int agc = 0;
  // start barrier (common.h:151-168 analog): capture begins only once every
  // device is opened+configured, so dongles start within one async window.
  std::mutex bmtx;
  std::condition_variable bcv;
  uint32_t ready = 0;
  uint32_t barrier_n = 0;  // initial cohort size (hot-adds don't join it)
  bool aborted = false;
};

int rtl_find_index_by_serial(const std::string &serial) {
  auto &r = rtldl::api();
  if (!r.ok) return -1;
  uint32_t n = r.get_device_count();
  char manufact[256], product[256], ser[256];
  for (uint32_t i = 0; i < n; ++i) {
    if (r.get_device_usb_strings(i, manufact, product, ser) != 0) continue;
    if (serial == ser) return static_cast<int>(i);
  }
  return -1;
}

// The reference's order-sensitive open sequence (src/crtlsdr.cc:112-135):
// samplerate -> dithering OFF (before tuning!) -> fcenter -> AGC -> tuner
// gain mode manual -> tuner gain -> zero the retained freq correction.
int rtl_open_configure(RtlDev *d, uint32_t fs, uint32_t fcenter, uint32_t gain,
                       int agc) {
  auto &r = rtldl::api();
  int idx = rtl_find_index_by_serial(d->serial);
  if (idx < 0) return -1;
  d->index = idx;
  if (r.open(&d->dev, static_cast<uint32_t>(idx)) != 0) return -2;
  if (r.set_sample_rate(d->dev, fs) != 0) return -3;
  if (r.set_dithering && r.set_dithering(d->dev, 0) != 0) return -4;
  if (r.set_center_freq(d->dev, fcenter) != 0) return -5;
  if (r.set_agc_mode && r.set_agc_mode(d->dev, agc) != 0) return -6;
  if (r.set_tuner_gain_mode && r.set_tuner_gain_mode(d->dev, 1) != 0) return -7;
  if (r.set_tuner_gain && r.set_tuner_gain(d->dev, static_cast<int>(gain)) != 0)
    return -8;
  if (r.set_sample_freq_correction_f) {
    if (r.set_sample_freq_correction_f(d->dev, 0.0f) != 0) return -9;
  } else if (r.set_freq_correction) {
    r.set_freq_correction(d->dev, 0);  // stock lib returns -2 for ppm=0: ignore
  }
  return 0;
}

void rtl_async_callback(unsigned char *buf, uint32_t len, void *ctx) {
  auto *d = static_cast<RtlDev *>(ctx);
  std::lock_guard<std::mutex> g(d->mtx);
  if (d->fifo.size() + len > d->fifo_cap) {
    // Drop OLDEST whole channel-blocks (keeps IQ framing; the time skew
    // this introduces vs other channels is the reference's documented
    // under-load stale-buffer failure, README.md:42). Dropped blocks count
    // into `removed`, so THIS channel's next consumed seqnum gaps — the
    // in-pipeline gap detector sees exactly the per-channel stale-buffer
    // failure (pipeline/step.py _seq_gap).
    size_t need = d->fifo.size() + len - d->fifo_cap;
    size_t chan = d->owner->chan_bytes;
    size_t drop = ((need + chan - 1) / chan) * chan;
    // never split a block: only whole blocks off the front keep framing
    drop = std::min(drop, (d->fifo.size() / chan) * chan);
    d->fifo.erase(d->fifo.begin(), d->fifo.begin() + drop);
    d->dropped_blocks.fetch_add(drop / chan, std::memory_order_relaxed);
    d->removed += drop / chan;
  }
  d->fifo.insert(d->fifo.end(), buf, buf + len);
  d->cv.notify_one();
}

void rtl_device_main(RtlDev *d) {
  auto *c = d->owner;
  auto &r = rtldl::api();
  c->spawned.fetch_add(1);
  int rc = rtl_open_configure(d, c->fs, c->fcenter, d->gain, c->agc);
  d->open_rc.store(rc);
  if (d->hot) {
    // Console `add` path (console.cc:225-270): the reference releases a
    // hot-added device from its own 2-party barrier; here the device
    // simply starts streaming the moment it is configured.
    if (rc != 0) {
      std::lock_guard<std::mutex> g(d->hmtx);
      if (d->dev) r.close(d->dev);
      d->dev = nullptr;
      d->thread_done.store(true);
      c->exited.fetch_add(1);
      return;
    }
  } else {
    std::unique_lock<std::mutex> lk(c->bmtx);
    if (rc != 0) {
      c->error.store(rc);
      c->aborted = true;
    }
    c->ready++;
    c->bcv.notify_all();
    c->bcv.wait(lk, [&] { return c->ready == c->barrier_n; });
    if (c->aborted) {
      lk.unlock();
      std::lock_guard<std::mutex> g(d->hmtx);
      if (d->dev) r.close(d->dev);
      d->dev = nullptr;
      d->thread_done.store(true);
      c->exited.fetch_add(1);
      return;
    }
  }
  // Barrier released: start streaming (src/crtlsdr.cc:44-59).
  r.reset_buffer(d->dev);
  r.read_async(d->dev, rtl_async_callback, d, c->asyncbufn, c->chan_bytes);
  // read_async returns after rtlsdr_cancel_async (stop path) OR on its own
  // after a USB death — either way close under hmtx (no setter TOCTOU).
  {
    std::lock_guard<std::mutex> g(d->hmtx);
    r.close(d->dev);
    d->dev = nullptr;
  }
  d->thread_done.store(true);
      c->exited.fetch_add(1);
}

// Two-pass frame assembly: pass 1 WAITS until every device FIFO holds a
// whole channel-block WITHOUT consuming anything; pass 2 then consumes from
// all devices. A device timing out in pass 1 abandons the frame with zero
// blocks consumed — the one-pass consume-as-you-wait scheme would silently
// skew already-consumed channels by whole blocks against the slow device
// (uncounted coherence break). The assembler holds devs_mtx for the frame;
// console add/del raise `mutate_pending` (which wakes every pass-1 wait) and
// take the mutex between frames.
void rtl_assembler_main(RtlCapture *c) {
  std::vector<uint8_t> block(c->ring->block_bytes, 0x80);  // pad = u8 zero IQ
  // sized to the channel CAPACITY, not n_seq: a legacy 1-seq ring still
  // carries multiple devices, and pass 2 indexes by device (push_n then
  // stores only the ring's n_seq leading entries)
  std::vector<uint64_t> seqs(
      std::max<size_t>(c->ring->n_seq, c->max_chans), 0);
  const size_t chan = c->chan_bytes;
  while (!c->stop.load(std::memory_order_relaxed)) {
    if (c->mutate_pending.load(std::memory_order_acquire)) {
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
      continue;  // let add/del grab devs_mtx
    }
    std::unique_lock<std::mutex> dl(c->devs_mtx);
    if (c->devs.empty()) {  // all channels removed: idle until an add
      dl.unlock();
      std::this_thread::sleep_for(std::chrono::milliseconds(10));
      continue;
    }
    bool got_all = true;
    // pass 1: wait, consume nothing
    for (size_t i = 0; i < c->devs.size() && got_all; ++i) {
      RtlDev *d = c->devs[i].get();
      std::unique_lock<std::mutex> lk(d->mtx);
      if (!d->cv.wait_for(lk, std::chrono::milliseconds(200), [&] {
            return d->fifo.size() >= chan ||
                   c->stop.load(std::memory_order_relaxed) ||
                   c->mutate_pending.load(std::memory_order_relaxed);
          }))
        got_all = false;  // timeout: abandon frame, NOTHING was consumed
      if (c->stop.load(std::memory_order_relaxed)) return;
      if (c->mutate_pending.load(std::memory_order_relaxed)) got_all = false;
    }
    if (!got_all) {
      if (!c->mutate_pending.load(std::memory_order_relaxed))
        c->stalls.fetch_add(1, std::memory_order_relaxed);
      continue;  // re-check stop/mutate; frame intact
    }
    // pass 2: consume one channel-block from every device (no waits).
    // Only an overflow drop can shrink a FIFO concurrently, and a drop
    // leaves >= fifo_cap - chan bytes behind, so >= chan remains.
    size_t n = c->devs.size();
    for (size_t i = 0; i < n; ++i) {
      RtlDev *d = c->devs[i].get();
      std::lock_guard<std::mutex> lk(d->mtx);
      if (d->fifo.size() < chan) {  // defensive: pad + count as a drop
        std::memset(&block[i * chan], 0x80, chan);
        d->dropped_blocks.fetch_add(1, std::memory_order_relaxed);
        seqs[i] = ++d->removed;
        continue;
      }
      std::memcpy(&block[i * chan], d->fifo.data(), chan);
      d->fifo.erase(d->fifo.begin(), d->fifo.begin() + chan);
      seqs[i] = ++d->removed;  // capture-order seqnum incl. earlier drops
    }
    for (size_t i = n; i < seqs.size(); ++i) seqs[i] = 0;  // padding tracks
    for (size_t i = n * chan; i < block.size(); ++i) block[i] = 0x80;
    chost_ring_push_n(c->ring, block.data(), seqs.data(),
                      static_cast<uint32_t>(seqs.size()));
    c->pushed.fetch_add(1, std::memory_order_relaxed);
  }
}

// Cancel a device's async read until its thread exits, then join.
// cancel_async is a no-op before the thread has entered read_async (real
// librtlsdr returns "not running"), so a single cancel can race a
// just-opened device and hang the join forever — re-issue until the
// thread reports done.
void rtl_join_dev(RtlDev *d) {
  auto &r = rtldl::api();
  while (!d->thread_done.load(std::memory_order_acquire)) {
    {
      std::lock_guard<std::mutex> h(d->hmtx);
      if (d->dev && r.cancel_async) r.cancel_async(d->dev);
    }
    d->cv.notify_all();
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  if (d->th.joinable()) d->th.join();
}

// Ring geometry contract: a legacy ring (n_seq == 1) must match the device
// count exactly (frame-level seqnums, fixed channel set); a per-channel ring
// (n_seq > 1, created with chost_ring_create_seq) must have one seqnum track
// per channel slot and sets the hot-add capacity (devs may start below it).
bool rtl_capture_geometry_ok(RtlCapture *c) {
  if (c->devs.empty()) return false;
  if (c->ring->n_seq == 1) {
    if (c->ring->block_bytes != c->devs.size() * c->chan_bytes) return false;
    c->max_chans = static_cast<uint32_t>(c->devs.size());
  } else {
    if (c->ring->block_bytes != size_t(c->ring->n_seq) * c->chan_bytes)
      return false;
    if (c->devs.size() > c->ring->n_seq) return false;
    c->max_chans = c->ring->n_seq;
  }
  return true;
}

// Priority acquisition of devs_mtx for short-lived mutators and readers
// (retune/fs/ppm setters, counter/serial readers): raising mutate_pending
// first makes the assembler abandon its in-progress frame at the next
// pass-1 wake-up (every USB callback notifies) instead of these callers
// queueing behind an unfair mutex the assembler re-acquires in a tight
// loop and holds across up-to-200 ms waits — a console retune/status must
// never hang behind one stalled dongle.
struct DevsLock {
  RtlCapture *c;
  std::unique_lock<std::mutex> lk;
  explicit DevsLock(RtlCapture *cc) : c(cc) {
    c->mutate_pending.fetch_add(1, std::memory_order_release);
    lk = std::unique_lock<std::mutex>(c->devs_mtx);
    c->mutate_pending.fetch_sub(1, std::memory_order_release);
  }
};

}  // namespace

extern "C" {

// Load librtlsdr from an explicit path (tests inject a mock here), or pass
// NULL for the default search (env COHERENT_LIBRTLSDR, then system names).
int chost_rtlsdr_load(const char *path) { return rtldl::load(path) ? 1 : 0; }

int chost_rtlsdr_available(void) { return rtldl::api().ok ? 1 : 0; }

int chost_rtlsdr_device_count(void) {
  auto &r = rtldl::api();
  return r.ok ? static_cast<int>(r.get_device_count()) : 0;
}

// USB serial string of device `idx` -> out (returns length, or -1).
int chost_rtlsdr_device_serial(uint32_t idx, char *out, int cap) {
  auto &r = rtldl::api();
  if (!r.ok) return -1;
  char manufact[256], product[256], ser[256];
  if (r.get_device_usb_strings(idx, manufact, product, ser) != 0) return -1;
  int n = static_cast<int>(std::strlen(ser));
  if (n + 1 > cap) return -1;
  std::memcpy(out, ser, n + 1);
  return n;
}

// Start a multi-dongle coherent capture: `serials_csv` is a comma-separated
// list, REFERENCE FIRST (the RingSource block layout), e.g.
// "REF0001,SIG0001,SIG0002". block_len = complex samples per channel-block
// (ring block_bytes must equal n_serials * 2 * block_len). Gains in tenths
// of dB like the reference CLI (main.cc:133-136).
void *chost_rtlsdr_capture_start(void *ring, const char *serials_csv,
                                 uint32_t block_len, uint32_t fs,
                                 uint32_t fcenter, uint32_t gain,
                                 uint32_t ref_gain, int enable_agc,
                                 uint32_t asyncbufn) {
  auto &r = rtldl::api();
  if (!r.ok || !ring || !serials_csv || block_len == 0) return nullptr;
  auto *c = new RtlCapture();
  c->ring = static_cast<BlockRing *>(ring);
  c->chan_bytes = 2 * block_len;
  c->asyncbufn = asyncbufn ? asyncbufn : 8;
  c->fs = fs;
  c->fcenter = fcenter;
  c->gain = gain;
  c->ref_gain = ref_gain;
  c->agc = enable_agc;
  std::string csv(serials_csv);
  size_t pos = 0;
  while (pos <= csv.size()) {
    size_t comma = csv.find(',', pos);
    if (comma == std::string::npos) comma = csv.size();
    std::string s = csv.substr(pos, comma - pos);
    if (!s.empty()) {
      auto d = std::make_unique<RtlDev>();
      d->owner = c;
      d->serial = s;
      d->gain = c->devs.empty() ? ref_gain : gain;
      d->fifo_cap = size_t(c->asyncbufn) * c->chan_bytes * 2;
      c->devs.push_back(std::move(d));
    }
    pos = comma + 1;
  }
  if (!rtl_capture_geometry_ok(c)) {
    delete c;
    return nullptr;
  }
  c->barrier_n = static_cast<uint32_t>(c->devs.size());
  for (auto &d : c->devs) d->th = std::thread(rtl_device_main, d.get());
  c->assembler = std::thread(rtl_assembler_main, c);
  return c;
}

// Start variant with PER-DONGLE tuner gains (tenths of dB, reference
// first, comma-separated, exactly one per serial) — the per-channel gain
// configuration the reference left as future work (examplecfg/four.cfg:4).
// Gains must be known before the order-sensitive open sequence runs, so
// they are a start parameter, not a setter.
void *chost_rtlsdr_capture_start_gains(void *ring, const char *serials_csv,
                                       const char *gains_csv,
                                       uint32_t block_len, uint32_t fs,
                                       uint32_t fcenter, int enable_agc,
                                       uint32_t asyncbufn) {
  auto &r = rtldl::api();
  if (!r.ok || !ring || !serials_csv || !gains_csv || block_len == 0)
    return nullptr;
  std::vector<uint32_t> gains;
  {
    std::string gcsv(gains_csv);
    size_t pos = 0;
    while (pos <= gcsv.size()) {
      size_t comma = gcsv.find(',', pos);
      if (comma == std::string::npos) comma = gcsv.size();
      std::string s = gcsv.substr(pos, comma - pos);
      if (!s.empty()) gains.push_back(static_cast<uint32_t>(std::atoi(s.c_str())));
      pos = comma + 1;
    }
  }
  auto *c = new RtlCapture();
  c->ring = static_cast<BlockRing *>(ring);
  c->chan_bytes = 2 * block_len;
  c->asyncbufn = asyncbufn ? asyncbufn : 8;
  c->fs = fs;
  c->fcenter = fcenter;
  c->agc = enable_agc;
  c->ref_gain = gains.empty() ? 500 : gains.front();
  c->gain = gains.size() > 1 ? gains.back() : 500;  // hot-add default
  std::string csv(serials_csv);
  size_t pos = 0;
  while (pos <= csv.size()) {
    size_t comma = csv.find(',', pos);
    if (comma == std::string::npos) comma = csv.size();
    std::string s = csv.substr(pos, comma - pos);
    if (!s.empty()) {
      auto d = std::make_unique<RtlDev>();
      d->owner = c;
      d->serial = s;
      d->gain = c->devs.size() < gains.size() ? gains[c->devs.size()] : 500;
      d->fifo_cap = size_t(c->asyncbufn) * c->chan_bytes * 2;
      c->devs.push_back(std::move(d));
    }
    pos = comma + 1;
  }
  if (c->devs.size() != gains.size() || !rtl_capture_geometry_ok(c)) {
    delete c;
    return nullptr;
  }
  c->barrier_n = static_cast<uint32_t>(c->devs.size());
  for (auto &d : c->devs) d->th = std::thread(rtl_device_main, d.get());
  c->assembler = std::thread(rtl_assembler_main, c);
  return c;
}

uint64_t chost_rtlsdr_capture_pushed(void *cv) {
  return cv ? static_cast<RtlCapture *>(cv)->pushed.load() : 0;
}

// Negative open/config rc of the first failing device (0 = healthy).
int chost_rtlsdr_capture_error(void *cv) {
  return cv ? static_cast<RtlCapture *>(cv)->error.load() : 0;
}

// 0 after stop(), an aborted open, or once EVERY device thread has exited
// (USB death makes read_async return on its own — without this the consumer
// would spin on pop timeouts against a dead capture forever).
int chost_rtlsdr_capture_running(void *cv) {
  if (!cv) return 0;
  auto *c = static_cast<RtlCapture *>(cv);
  if (c->done.load() || c->aborted) return 0;
  uint32_t spawned = c->spawned.load();
  if (spawned > 0 && c->exited.load() >= spawned) return 0;
  return 1;
}

uint64_t chost_rtlsdr_capture_dropped(void *cv) {
  if (!cv) return 0;
  auto *c = static_cast<RtlCapture *>(cv);
  DevsLock g(c);
  uint64_t n = 0;
  for (auto &d : c->devs) n += d->dropped_blocks.load();
  return n;
}

// Frames abandoned because a device had no data within the 200 ms window
// (two-pass assembly: nothing was consumed — no silent channel skew).
uint64_t chost_rtlsdr_capture_stalls(void *cv) {
  return cv ? static_cast<RtlCapture *>(cv)->stalls.load() : 0;
}

int chost_rtlsdr_capture_ndev(void *cv) {
  if (!cv) return 0;
  auto *c = static_cast<RtlCapture *>(cv);
  DevsLock g(c);
  return static_cast<int>(c->devs.size());
}

// Serial of capture channel `ch` (0 = reference) -> out; returns length or -1.
int chost_rtlsdr_capture_serial(void *cv, uint32_t ch, char *out, int cap) {
  if (!cv) return -1;
  auto *c = static_cast<RtlCapture *>(cv);
  DevsLock g(c);
  if (ch >= c->devs.size()) return -1;
  const std::string &s = c->devs[ch]->serial;
  if (static_cast<int>(s.size()) + 1 > cap) return -1;
  std::memcpy(out, s.c_str(), s.size() + 1);
  return static_cast<int>(s.size());
}

// Hardware resampler skew — the reference control loop's actuator
// (ccontrol.cc:78-123 via rtlsdr_set_sample_freq_correction_f). ch 0 = the
// reference dongle (never skewed by the reference; exposed anyway).
// Returns -1 when the fork extension is absent or the device is down.
int chost_rtlsdr_capture_set_correction_f(void *cv, uint32_t ch, float ppm) {
  auto &r = rtldl::api();
  auto *c = static_cast<RtlCapture *>(cv);
  if (!c) return -1;
  DevsLock g(c);
  if (ch >= c->devs.size()) return -1;
  RtlDev *d = c->devs[ch].get();
  std::lock_guard<std::mutex> h(d->hmtx);
  if (!r.set_sample_freq_correction_f || !d->dev) return -1;
  return r.set_sample_freq_correction_f(d->dev, ppm);
}

// Retune every dongle (console `fcenter` semantics, console.cc:176-201) —
// dithering is re-disabled before each tune (src/crtlsdr.cc:142-146).
// Applied to EVERY healthy dongle even when one fails (no early return
// leaving a half-retuned array unreported); -1 on any failure so the
// caller can restore the old tuning across the array.
int chost_rtlsdr_capture_set_fcenter(void *cv, uint32_t hz) {
  auto &r = rtldl::api();
  auto *c = static_cast<RtlCapture *>(cv);
  if (!c) return -1;
  DevsLock g(c);
  int rc = 0;
  for (auto &d : c->devs) {
    std::lock_guard<std::mutex> h(d->hmtx);
    if (!d->dev) {
      rc = -1;
      continue;
    }
    if (r.set_dithering) r.set_dithering(d->dev, 0);
    if (r.set_center_freq(d->dev, hz) != 0) rc = -1;
  }
  if (rc == 0) c->fcenter = hz;
  return rc;
}

// Console `fs` semantics (console.cc:156-175): set the sample rate on
// every dongle while streaming and flush the per-device FIFOs (stale-rate
// samples). On partial failure the rate is still applied to EVERY healthy
// dongle (never an early return leaving a mixed-rate array unreported) and
// -1 is returned so the caller can surface it; the caller forces a resync
// either way, like the reference does.
int chost_rtlsdr_capture_set_sample_rate(void *cv, uint32_t fs) {
  auto &r = rtldl::api();
  auto *c = static_cast<RtlCapture *>(cv);
  if (!c) return -1;
  DevsLock g(c);
  int rc = 0;
  for (auto &d : c->devs) {
    std::lock_guard<std::mutex> h(d->hmtx);
    if (!d->dev || r.set_sample_rate(d->dev, fs) != 0) rc = -1;
  }
  if (rc == 0) c->fs = fs;
  for (auto &d : c->devs) {
    std::lock_guard<std::mutex> lk(d->mtx);
    d->fifo.clear();
  }
  return rc;
}

int chost_rtlsdr_capture_remove(void *cv, const char *serial);

// Hot-add a dongle to a RUNNING capture (console `add`, console.cc:225-270).
// Requires a per-channel ring with free capacity (chost_ring_create_seq).
// Blocks until the device is streaming or its open failed; returns the new
// channel index (>= 1) or a negative open/config rc.
// (mutate_pending makes the assembler abandon its frame and release
// devs_mtx at the next wait wake-up — every USB callback notifies — so the
// lock below is acquired within one 200 ms wait window at worst.)
int chost_rtlsdr_capture_add(void *cv, const char *serial,
                             uint32_t gain_tenths) {
  auto *c = static_cast<RtlCapture *>(cv);
  if (!c || !serial || !serial[0] || c->aborted) return -1;
  RtlDev *d;
  int index;
  {
    c->mutate_pending.fetch_add(1, std::memory_order_release);
    std::lock_guard<std::mutex> g(c->devs_mtx);
    if (c->devs.size() >= c->max_chans) {
      c->mutate_pending.fetch_sub(1, std::memory_order_release);
      return -1;  // ring has no spare channel slot
    }
    for (auto &e : c->devs) {
      if (e->serial == serial) {  // duplicate: that dongle is capturing
        c->mutate_pending.fetch_sub(1, std::memory_order_release);
        return -1;
      }
    }
    auto nd = std::make_unique<RtlDev>();
    nd->owner = c;
    nd->serial = serial;
    nd->gain = gain_tenths == 0xFFFFFFFFu ? c->gain : gain_tenths;
    nd->hot = true;
    nd->fifo_cap = size_t(c->asyncbufn) * c->chan_bytes * 2;
    d = nd.get();
    index = static_cast<int>(c->devs.size());
    c->devs.push_back(std::move(nd));
    d->th = std::thread(rtl_device_main, d);
    c->mutate_pending.fetch_sub(1, std::memory_order_release);
  }
  // Wait (outside the lock) for open+configure to finish.
  while (d->open_rc.load() == RtlDev::kOpenPending)
    std::this_thread::sleep_for(std::chrono::milliseconds(5));
  int rc = d->open_rc.load();
  if (rc != 0) {
    // remove the zombie BY IDENTITY (never by serial: a lookup could hit
    // another device), else its empty FIFO stalls every future frame
    std::unique_ptr<RtlDev> victim;
    c->mutate_pending.fetch_add(1, std::memory_order_release);
    {
      std::lock_guard<std::mutex> g(c->devs_mtx);
      for (size_t i = 0; i < c->devs.size(); ++i) {
        if (c->devs[i].get() == d) {
          victim = std::move(c->devs[i]);
          c->devs.erase(c->devs.begin() + i);
          break;
        }
      }
      c->mutate_pending.fetch_sub(1, std::memory_order_release);
    }
    if (victim) {
      rtl_join_dev(victim.get());
      c->spawned.fetch_sub(1);
      c->exited.fetch_sub(1);
    }
    return rc;
  }
  return index;
}

// Hot-remove a dongle (console `del`): cancels its async read, joins its
// thread, drops its channel slot — remaining channels shift down one, the
// layout the server's row remap mirrors. Returns the former index or -1.
int chost_rtlsdr_capture_remove(void *cv, const char *serial) {
  auto *c = static_cast<RtlCapture *>(cv);
  if (!c || !serial) return -1;
  auto &r = rtldl::api();
  std::unique_ptr<RtlDev> victim;
  int index = -1;
  c->mutate_pending.fetch_add(1, std::memory_order_release);
  {
    std::lock_guard<std::mutex> g(c->devs_mtx);
    for (size_t i = 0; i < c->devs.size(); ++i) {
      if (c->devs[i]->serial == serial) {
        index = static_cast<int>(i);
        victim = std::move(c->devs[i]);
        c->devs.erase(c->devs.begin() + i);
        break;
      }
    }
    c->mutate_pending.fetch_sub(1, std::memory_order_release);
  }
  if (!victim) return -1;
  (void)r;
  rtl_join_dev(victim.get());
  // its thread already exited (counted); keep liveness math consistent
  c->spawned.fetch_sub(1);
  c->exited.fetch_sub(1);
  return index;
}

// Terminal teardown. stop() may race the assembler and concurrent console
// setters/readers (which it drains via devs_mtx below), but NOT a concurrent
// add/remove/second-stop — those mutators are serialized by the caller (the
// Python server runs all console commands and stop on one thread); after
// stop returns the handle is freed and every capture_* call on it is UB.
void chost_rtlsdr_capture_stop(void *cv) {
  auto *c = static_cast<RtlCapture *>(cv);
  if (!c) return;
  c->stop.store(true);
  c->mutate_pending.fetch_add(1, std::memory_order_release);  // unblock pass 1
  // Detach the device list under devs_mtx (the assembler or an in-flight
  // setter may still be walking it), then join outside the lock: joins can
  // take hundreds of ms and the assembler needs the mutex to notice stop.
  std::vector<std::unique_ptr<RtlDev>> doomed;
  {
    std::lock_guard<std::mutex> g(c->devs_mtx);
    doomed.swap(c->devs);
  }
  for (auto &d : doomed) rtl_join_dev(d.get());
  if (c->assembler.joinable()) c->assembler.join();
  c->done.store(true);
  delete c;
}

}  // extern "C"
