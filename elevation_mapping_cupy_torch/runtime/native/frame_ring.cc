// Native bounded frame ring: preallocated slab ring buffer for sensor frames.
//
// The reference's ingestion memory story is ROS subscriber queues
// (queue_size=1, elevation_mapping_ros.cpp:88) + per-message heap churn.
// This ring gives the runtime a fixed-memory, thread-safe MPSC buffer:
// one allocation at startup, copy-in/copy-out, drop-oldest or drop-newest
// under backpressure, and counters matching the Statistics surface.
//
// C ABI for ctypes; see runtime/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>

namespace {

struct Ring {
  int64_t capacity;      // frames
  int64_t slab_bytes;    // max payload per frame
  int64_t header_bytes;  // fixed header size per frame
  uint8_t* slabs;        // capacity * slab_bytes
  uint8_t* headers;      // capacity * header_bytes
  int64_t* sizes;        // payload bytes per slot
  int64_t head = 0;      // next pop
  int64_t count = 0;
  int64_t pushed = 0, popped = 0, dropped = 0;
  std::mutex mu;
};

}  // namespace

extern "C" {

void* ring_create(int64_t capacity, int64_t slab_bytes, int64_t header_bytes) {
  if (capacity <= 0 || slab_bytes <= 0 || header_bytes < 0) return nullptr;
  auto* r = new (std::nothrow) Ring();
  if (!r) return nullptr;
  r->capacity = capacity;
  r->slab_bytes = slab_bytes;
  r->header_bytes = header_bytes;
  r->slabs = new (std::nothrow) uint8_t[capacity * slab_bytes];
  r->headers = new (std::nothrow) uint8_t[capacity * (header_bytes ? header_bytes : 1)];
  r->sizes = new (std::nothrow) int64_t[capacity];
  if (!r->slabs || !r->headers || !r->sizes) {
    delete[] r->slabs;
    delete[] r->headers;
    delete[] r->sizes;
    delete r;
    return nullptr;
  }
  return r;
}

void ring_destroy(void* h) {
  auto* r = static_cast<Ring*>(h);
  if (!r) return;
  delete[] r->slabs;
  delete[] r->headers;
  delete[] r->sizes;
  delete r;
}

// Returns: 0 = stored, 1 = stored after dropping the oldest frame,
// -1 = rejected (full, drop_oldest=0), -2 = payload too large.
int32_t ring_push(void* h, const uint8_t* header, const uint8_t* payload,
                  int64_t payload_bytes, int32_t drop_oldest) {
  auto* r = static_cast<Ring*>(h);
  if (payload_bytes > r->slab_bytes) return -2;
  std::lock_guard<std::mutex> lock(r->mu);
  int32_t rc = 0;
  if (r->count == r->capacity) {
    if (!drop_oldest) {
      ++r->dropped;
      return -1;
    }
    r->head = (r->head + 1) % r->capacity;  // overwrite oldest
    --r->count;
    ++r->dropped;
    rc = 1;
  }
  const int64_t slot = (r->head + r->count) % r->capacity;
  if (r->header_bytes && header)
    std::memcpy(r->headers + slot * r->header_bytes, header, r->header_bytes);
  if (payload_bytes)
    std::memcpy(r->slabs + slot * r->slab_bytes, payload, payload_bytes);
  r->sizes[slot] = payload_bytes;
  ++r->count;
  ++r->pushed;
  return rc;
}

// Returns payload bytes copied, or -1 when empty.
int64_t ring_pop(void* h, uint8_t* header_out, uint8_t* payload_out,
                 int64_t payload_cap) {
  auto* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lock(r->mu);
  if (r->count == 0) return -1;
  const int64_t slot = r->head;
  const int64_t nbytes = r->sizes[slot] < payload_cap ? r->sizes[slot] : payload_cap;
  if (r->header_bytes && header_out)
    std::memcpy(header_out, r->headers + slot * r->header_bytes, r->header_bytes);
  if (nbytes && payload_out)
    std::memcpy(payload_out, r->slabs + slot * r->slab_bytes, nbytes);
  r->head = (r->head + 1) % r->capacity;
  --r->count;
  ++r->popped;
  return nbytes;
}

int64_t ring_size(void* h) {
  auto* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lock(r->mu);
  return r->count;
}

void ring_stats(void* h, int64_t* pushed, int64_t* popped, int64_t* dropped) {
  auto* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lock(r->mu);
  if (pushed) *pushed = r->pushed;
  if (popped) *popped = r->popped;
  if (dropped) *dropped = r->dropped;
}

}  // extern "C"
