// Native data plane: RecordIO files + async prefetch queue (a copy of
// paddle_tpu/native/recordio.cc: the two packages read and write the
// same record files).
//
// Reference parity: the Go master shards datasets as RecordIO chunks
// (go/master/service.go:106 partition; recordio vendored lib) and the
// legacy PyDataProvider2 feeds training through an async double-buffer
// queue (paddle/gserver/dataproviders/PyDataProvider2.cpp:511). This file
// provides both as a small C library consumed from Python via ctypes
// (a plain C interface, no pybind11): CRC-checked length-prefixed records
// and a bounded multi-threaded prefetch queue that overlaps host-side IO
// and decode with device steps.
//
// Record format: [u32 magic][u32 len][u32 crc32(payload)][payload bytes].
// A torn tail (partial final record) terminates iteration cleanly, so a
// writer crash never corrupts earlier records — same guarantee the Go
// pserver checkpoints get from CRC + atomic rename.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <condition_variable>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x50524543u;  // "PREC"

uint32_t crc32_of(const uint8_t* data, size_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Writer {
  FILE* f;
};

struct Reader {
  FILE* f;
  std::vector<uint8_t> buf;
};

// ---------------------------------------------------------------------
// Async prefetch queue: N reader threads stream records from a list of
// files into a bounded queue (backpressure keeps memory flat).
// ---------------------------------------------------------------------
struct Prefetcher {
  std::vector<std::string> files;
  size_t capacity;
  std::queue<std::vector<uint8_t>> q;
  std::mutex mu;
  std::condition_variable can_push, can_pop;
  bool done = false;
  bool cancel = false;
  std::thread worker;
  std::vector<uint8_t> current;

  void run() {
    for (const auto& path : files) {
      FILE* f = fopen(path.c_str(), "rb");
      if (!f) continue;
      while (true) {
        uint32_t hdr[3];
        if (fread(hdr, sizeof(uint32_t), 3, f) != 3) break;
        if (hdr[0] != kMagic) break;
        std::vector<uint8_t> payload(hdr[1]);
        if (fread(payload.data(), 1, hdr[1], f) != hdr[1]) break;
        if (crc32_of(payload.data(), payload.size()) != hdr[2]) break;
        std::unique_lock<std::mutex> lk(mu);
        can_push.wait(lk, [&] { return q.size() < capacity || cancel; });
        if (cancel) {
          fclose(f);
          goto out;
        }
        q.push(std::move(payload));
        can_pop.notify_one();
      }
      fclose(f);
    }
  out: {
    std::lock_guard<std::mutex> lk(mu);
    done = true;
    can_pop.notify_all();
  }
  }
};

}  // namespace

extern "C" {

// ---- writer ----------------------------------------------------------
void* rio_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer{f};
  return w;
}

int rio_write(void* wp, const uint8_t* data, uint32_t len) {
  auto* w = static_cast<Writer*>(wp);
  uint32_t hdr[3] = {kMagic, len, crc32_of(data, len)};
  if (fwrite(hdr, sizeof(uint32_t), 3, w->f) != 3) return -1;
  if (fwrite(data, 1, len, w->f) != len) return -1;
  return 0;
}

void rio_writer_close(void* wp) {
  auto* w = static_cast<Writer*>(wp);
  fclose(w->f);
  delete w;
}

// ---- reader (synchronous) -------------------------------------------
void* rio_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  return new Reader{f, {}};
}

// returns the payload length (0 for an empty record), -1 at end of
// file or at a torn or corrupt record; payload via rio_data
int64_t rio_next(void* rp) {
  auto* r = static_cast<Reader*>(rp);
  uint32_t hdr[3];
  if (fread(hdr, sizeof(uint32_t), 3, r->f) != 3) return -1;
  if (hdr[0] != kMagic) return -1;
  r->buf.resize(hdr[1]);
  if (fread(r->buf.data(), 1, hdr[1], r->f) != hdr[1]) return -1;
  if (crc32_of(r->buf.data(), r->buf.size()) != hdr[2]) return -1;
  return static_cast<int64_t>(hdr[1]);
}

const uint8_t* rio_data(void* rp) {
  return static_cast<Reader*>(rp)->buf.data();
}

void rio_close(void* rp) {
  auto* r = static_cast<Reader*>(rp);
  fclose(r->f);
  delete r;
}

// ---- async prefetcher ------------------------------------------------
void* pq_open(const char** paths, int n_paths, int capacity) {
  auto* p = new Prefetcher();
  for (int i = 0; i < n_paths; i++) p->files.emplace_back(paths[i]);
  p->capacity = capacity > 0 ? capacity : 64;
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// blocks for the next record; returns its length (0 for an empty
// record), -1 at the end of the stream
int64_t pq_next(void* pp) {
  auto* p = static_cast<Prefetcher*>(pp);
  std::unique_lock<std::mutex> lk(p->mu);
  p->can_pop.wait(lk, [&] { return !p->q.empty() || p->done; });
  if (p->q.empty()) return -1;
  p->current = std::move(p->q.front());
  p->q.pop();
  p->can_push.notify_one();
  return static_cast<int64_t>(p->current.size());
}

const uint8_t* pq_data(void* pp) {
  return static_cast<Prefetcher*>(pp)->current.data();
}

void pq_close(void* pp) {
  auto* p = static_cast<Prefetcher*>(pp);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->cancel = true;
    p->can_push.notify_all();
  }
  // drain so the worker can observe cancel even while waiting to push
  p->worker.join();
  delete p;
}

}  // extern "C"
