// Native embedding KV store: the host library behind the master's and
// the KV shards' embedding tables (a copy of the reference's
// elasticdl_tpu/master/embedding_cpp/embedding_store.cc, the same C
// interface and semantics).
//
// Per-layer row arenas with an int64 -> row hash index; batch lookup
// and update are single C calls over contiguous numpy buffers, with
// SETNX semantics for the lazy, race-free init of unseen ids.
//
// Concurrency: a store-level shared_mutex guards the layer map; each
// table has its own shared_mutex (readers-writer). ctypes releases the
// GIL during calls, so concurrent RPC threads look up in parallel.
//
// Built at first use by master/embedding_store.py with
//   g++ -O3 -shared -fPIC -std=c++17 embedding_store.cc
// into master/embedding_cpp/_build/ and loaded over ctypes.

#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Table {
  int64_t dim = 0;
  std::vector<float> arena;                     // rows * dim floats
  std::unordered_map<int64_t, size_t> index;    // id -> row number
  mutable std::shared_mutex mu;
};

struct Store {
  std::unordered_map<std::string, std::unique_ptr<Table>> tables;
  mutable std::shared_mutex mu;

  Table* get(const char* layer) const {
    std::shared_lock<std::shared_mutex> lk(mu);
    auto it = tables.find(layer);
    return it == tables.end() ? nullptr : it->second.get();
  }

  Table* get_or_create(const char* layer, int64_t dim) {
    {
      std::shared_lock<std::shared_mutex> lk(mu);
      auto it = tables.find(layer);
      if (it != tables.end()) return it->second.get();
    }
    std::unique_lock<std::shared_mutex> lk(mu);
    auto& slot = tables[layer];
    if (!slot) {
      slot = std::make_unique<Table>();
      slot->dim = dim;
    }
    return slot.get();
  }
};

}  // namespace

extern "C" {

void* edlkv_new() { return new Store(); }

void edlkv_free(void* s) { delete static_cast<Store*>(s); }

// Table dim; 0 when the layer has never been written.
int64_t edlkv_dim(void* s, const char* layer) {
  Table* t = static_cast<Store*>(s)->get(layer);
  if (!t) return 0;
  std::shared_lock<std::shared_mutex> lk(t->mu);
  return t->dim;
}

// Batch fetch: fills out[n*dim] (zero rows for misses) and
// unknown[<=n] with miss positions; returns the miss count.
// Returns -1 if the table exists but dim does not match.
int64_t edlkv_lookup(void* s, const char* layer, const int64_t* ids,
                     int64_t n, float* out, int64_t dim,
                     int64_t* unknown) {
  Table* t = static_cast<Store*>(s)->get(layer);
  int64_t misses = 0;
  if (!t) {
    for (int64_t i = 0; i < n; ++i) unknown[misses++] = i;
    if (dim > 0) std::memset(out, 0, sizeof(float) * n * dim);
    return misses;
  }
  std::shared_lock<std::shared_mutex> lk(t->mu);
  if (t->dim != dim) return -1;
  for (int64_t i = 0; i < n; ++i) {
    auto it = t->index.find(ids[i]);
    if (it == t->index.end()) {
      std::memset(out + i * dim, 0, sizeof(float) * dim);
      unknown[misses++] = i;
    } else {
      std::memcpy(out + i * dim, t->arena.data() + it->second * dim,
                  sizeof(float) * dim);
    }
  }
  return misses;
}

// Batch write; creates the table (with `dim`) on first write. With
// setnx != 0 only absent keys are written (lazy init race winner
// keeps its row). Later duplicates of an id within one call win,
// matching sequential SET semantics. Returns rows written, or -1 on
// dim mismatch with an existing table.
int64_t edlkv_update(void* s, const char* layer, const int64_t* ids,
                     int64_t n, const float* values, int64_t dim,
                     int setnx) {
  if (dim <= 0) return -1;
  Table* t = static_cast<Store*>(s)->get_or_create(layer, dim);
  std::unique_lock<std::shared_mutex> lk(t->mu);
  if (t->dim != dim) return -1;
  int64_t written = 0;
  for (int64_t i = 0; i < n; ++i) {
    auto it = t->index.find(ids[i]);
    if (it == t->index.end()) {
      size_t row = t->index.size();
      t->index.emplace(ids[i], row);
      t->arena.resize((row + 1) * dim);
      std::memcpy(t->arena.data() + row * dim, values + i * dim,
                  sizeof(float) * dim);
      ++written;
    } else if (!setnx) {
      std::memcpy(t->arena.data() + it->second * dim, values + i * dim,
                  sizeof(float) * dim);
      ++written;
    }
  }
  return written;
}

int64_t edlkv_rows(void* s, const char* layer) {
  Table* t = static_cast<Store*>(s)->get(layer);
  if (!t) return 0;
  std::shared_lock<std::shared_mutex> lk(t->mu);
  return static_cast<int64_t>(t->index.size());
}

int64_t edlkv_total_rows(void* s) {
  Store* st = static_cast<Store*>(s);
  std::shared_lock<std::shared_mutex> lk(st->mu);
  int64_t total = 0;
  for (auto& kv : st->tables) {
    std::shared_lock<std::shared_mutex> tl(kv.second->mu);
    total += static_cast<int64_t>(kv.second->index.size());
  }
  return total;
}

int64_t edlkv_num_layers(void* s) {
  Store* st = static_cast<Store*>(s);
  std::shared_lock<std::shared_mutex> lk(st->mu);
  return static_cast<int64_t>(st->tables.size());
}

// Copies the i-th layer name (iteration order; stable while no layer
// is being created) into buf; returns its length or -1 if i is out of
// range / buf too small.
int64_t edlkv_layer_name(void* s, int64_t i, char* buf, int64_t cap) {
  Store* st = static_cast<Store*>(s);
  std::shared_lock<std::shared_mutex> lk(st->mu);
  int64_t k = 0;
  for (auto& kv : st->tables) {
    if (k++ == i) {
      int64_t len = static_cast<int64_t>(kv.first.size());
      if (len + 1 > cap) return -1;
      std::memcpy(buf, kv.first.c_str(), len + 1);
      return len;
    }
  }
  return -1;
}

// Bulk export for checkpointing: fills ids_out[<=capacity] and
// vals_out[<=capacity*dim] in index order and returns the count
// written. `capacity` bounds the writes — the caller sized its
// buffers from edlkv_rows() WITHOUT a lock, and a concurrent update
// may have grown the table since; rows beyond capacity are simply not
// exported (the snapshot is a point-in-time view either way).
// Returns -1 on dim mismatch.
int64_t edlkv_export(void* s, const char* layer, int64_t* ids_out,
                     float* vals_out, int64_t dim, int64_t capacity) {
  Table* t = static_cast<Store*>(s)->get(layer);
  if (!t) return 0;
  std::shared_lock<std::shared_mutex> lk(t->mu);
  if (t->dim != dim) return -1;
  int64_t i = 0;
  for (auto& kv : t->index) {
    if (i >= capacity) break;
    ids_out[i] = kv.first;
    std::memcpy(vals_out + i * dim, t->arena.data() + kv.second * dim,
                sizeof(float) * dim);
    ++i;
  }
  return i;
}

}  // extern "C"
