// Sparse-table shard kernel: the parameter-server data path in native code.
//
// Reference capability: CommonSparseTable (fluid/distributed/table/
// common_sparse_table.cc) — shard-hashed embedding rows with per-row
// adagrad, duplicate-id merge on push, and raw save/load.  The RPC layer
// above this lives in Python (distributed/ps_service.py, the brpc_ps_*
// role); this file owns the hot loops: pull gather, merged adagrad push.
//
// Layout: rows [R, D] f32 + adagrad accumulator [R] f32, contiguous.
// All ids here are LOCAL row indices (the client maps global id ->
// (server = id % S, local = id / S)).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <mutex>
#include <random>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// mmap file layout: 64-byte header, then rows*dim data floats, then rows
// accum floats.  `ready` is written LAST on a fresh init, so a crash mid-
// initialization leaves an invalid header, not silent garbage.
struct SsdHeader {
  uint64_t magic;
  uint64_t rows;
  uint64_t dim;
  uint64_t ready;
  uint64_t pad[4];
};
constexpr uint64_t kSsdMagic = 0x4c42545000ULL;  // "PTBL"
static_assert(sizeof(SsdHeader) == 64, "header must stay 64 bytes");

struct Table {
  uint64_t rows;
  uint64_t dim;
  std::vector<float> mem_data;   // in-memory mode: [rows * dim]
  std::vector<float> mem_accum;  // [rows]
  // disk mode (SSDSparseTable role): rows+accum live in one mmap'd file —
  // the OS page cache keeps the hot working set resident while the table
  // exceeds RAM (vocab >> memory recommender embeddings)
  void* map = nullptr;   // mmap base (SsdHeader + payload)
  int fd = -1;
  uint64_t map_bytes = 0;
  std::mutex mu;

  float* payload() {
    return reinterpret_cast<float*>(static_cast<char*>(map)
                                    + sizeof(SsdHeader));
  }
  float* data() { return map ? payload() : mem_data.data(); }
  float* accum() {
    return map ? payload() + rows * dim : mem_accum.data();
  }
};

void fill_random(Table* t, uint64_t seed, float init_range) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> dist(-init_range, init_range);
  float* d = t->data();
  for (uint64_t i = 0; i < t->rows * t->dim; ++i) d[i] = dist(rng);
  std::memset(t->accum(), 0, t->rows * sizeof(float));
}

}  // namespace

extern "C" {

void* pst_create(uint64_t rows, uint64_t dim, uint64_t seed,
                 float init_range) {
  auto* t = new Table();
  t->rows = rows;
  t->dim = dim;
  t->mem_data.resize(rows * dim);
  t->mem_accum.assign(rows, 0.0f);
  fill_random(t, seed, init_range);
  return t;
}

// SSD-backed shard: the whole table lives in ONE mmap'd file at `path`
// (created and random-initialized when absent; reopened — with header
// validation — when present).  Returns nullptr on any failure, including
// a shape mismatch or a half-initialized file from a crashed process
// (never silently reinterprets or truncates trained rows).
void* pst_create_ssd(uint64_t rows, uint64_t dim, uint64_t seed,
                     float init_range, const char* path) {
  auto* t = new Table();
  t->rows = rows;
  t->dim = dim;
  t->map_bytes = sizeof(SsdHeader) + (rows * dim + rows) * sizeof(float);
  bool fresh = (access(path, F_OK) != 0);
  t->fd = ::open(path, O_RDWR | O_CREAT, 0644);
  if (t->fd < 0) {
    delete t;
    return nullptr;
  }
  if (!fresh) {
    struct stat st{};
    SsdHeader hdr{};
    if (fstat(t->fd, &st) != 0 || (uint64_t)st.st_size != t->map_bytes ||
        pread(t->fd, &hdr, sizeof(hdr), 0) != (ssize_t)sizeof(hdr) ||
        hdr.magic != kSsdMagic || hdr.rows != rows || hdr.dim != dim ||
        hdr.ready != 1) {
      ::close(t->fd);
      delete t;
      return nullptr;
    }
  } else if (ftruncate(t->fd, (off_t)t->map_bytes) != 0) {
    ::close(t->fd);
    delete t;
    return nullptr;
  }
  void* m = mmap(nullptr, t->map_bytes, PROT_READ | PROT_WRITE, MAP_SHARED,
                 t->fd, 0);
  if (m == MAP_FAILED) {
    ::close(t->fd);
    delete t;
    return nullptr;
  }
  t->map = m;
  if (fresh) {
    fill_random(t, seed, init_range);
    auto* hdr = static_cast<SsdHeader*>(t->map);
    hdr->magic = kSsdMagic;
    hdr->rows = rows;
    hdr->dim = dim;
    hdr->ready = 1;  // written after init: crash leaves an invalid header
    msync(t->map, t->map_bytes, MS_SYNC);
  }
  return t;
}

// flush disk-backed rows to stable storage (msync)
int pst_sync(void* h) {
  auto* t = static_cast<Table*>(h);
  if (!t->map) return 0;
  std::lock_guard<std::mutex> lk(t->mu);
  return msync(t->map, t->map_bytes, MS_SYNC);
}

void pst_destroy(void* h) {
  auto* t = static_cast<Table*>(h);
  if (t->map) {
    munmap(t->map, t->map_bytes);
    ::close(t->fd);
  }
  delete t;
}

uint64_t pst_rows(void* h) { return static_cast<Table*>(h)->rows; }
uint64_t pst_dim(void* h) { return static_cast<Table*>(h)->dim; }

// out[i, :] = rows[ids[i], :]
void pst_pull(void* h, const int64_t* ids, uint64_t n, float* out) {
  auto* t = static_cast<Table*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  const uint64_t D = t->dim;
  for (uint64_t i = 0; i < n; ++i) {
    const int64_t r = ids[i];
    if (r < 0 || (uint64_t)r >= t->rows) {
      std::memset(out + i * D, 0, D * sizeof(float));
      continue;
    }
    std::memcpy(out + i * D, t->data() + (uint64_t)r * D,
                D * sizeof(float));
  }
}

// Merged adagrad push (reference push_sparse merge + per-row adagrad):
// duplicate ids' grads are summed first, then per unique row
//   accum[r] += mean(g^2);  rows[r] -= lr * g / (sqrt(accum[r]) + eps)
void pst_push_adagrad(void* h, const int64_t* ids, const float* grads,
                      uint64_t n, float lr, float eps) {
  auto* t = static_cast<Table*>(h);
  const uint64_t D = t->dim;
  // merge duplicates outside the lock
  std::unordered_map<int64_t, uint64_t> slot;  // id -> merged index
  slot.reserve(n);
  std::vector<int64_t> uids;
  std::vector<float> merged;
  uids.reserve(n);
  merged.reserve(n * D);
  for (uint64_t i = 0; i < n; ++i) {
    const int64_t r = ids[i];
    if (r < 0 || (uint64_t)r >= t->rows) continue;
    auto it = slot.find(r);
    if (it == slot.end()) {
      slot.emplace(r, uids.size());
      uids.push_back(r);
      merged.insert(merged.end(), grads + i * D, grads + (i + 1) * D);
    } else {
      float* dst = merged.data() + it->second * D;
      const float* src = grads + i * D;
      for (uint64_t d = 0; d < D; ++d) dst[d] += src[d];
    }
  }
  std::lock_guard<std::mutex> lk(t->mu);
  float* acc = t->accum();
  float* base = t->data();
  for (uint64_t u = 0; u < uids.size(); ++u) {
    const uint64_t r = (uint64_t)uids[u];
    const float* g = merged.data() + u * D;
    float sq = 0.0f;
    for (uint64_t d = 0; d < D; ++d) sq += g[d] * g[d];
    acc[r] += sq / (float)D;
    const float scale = lr / (std::sqrt(acc[r]) + eps);
    float* row = base + r * D;
    for (uint64_t d = 0; d < D; ++d) row[d] -= scale * g[d];
  }
}

// Geo-async delta apply (reference SparseGeoTable role): rows[ids[i]] +=
// deltas[i].  Trainers train on a local cache and periodically send the
// accumulated difference; the server just adds it.
void pst_push_delta(void* h, const int64_t* ids, const float* deltas,
                    uint64_t n) {
  auto* t = static_cast<Table*>(h);
  const uint64_t D = t->dim;
  std::lock_guard<std::mutex> lk(t->mu);
  float* base = t->data();
  for (uint64_t i = 0; i < n; ++i) {
    const int64_t r = ids[i];
    if (r < 0 || (uint64_t)r >= t->rows) continue;
    float* row = base + (uint64_t)r * D;
    const float* d = deltas + i * D;
    for (uint64_t k = 0; k < D; ++k) row[k] += d[k];
  }
}

// raw snapshot: [rows, dim] u64 header + data + accum
int pst_save(void* h, const char* path) {
  auto* t = static_cast<Table*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint64_t hdr[2] = {t->rows, t->dim};
  std::fwrite(hdr, sizeof(uint64_t), 2, f);
  std::fwrite(t->data(), sizeof(float), t->rows * t->dim, f);
  std::fwrite(t->accum(), sizeof(float), t->rows, f);
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Graph table (reference common_graph_table.cc: graph storage + neighbor
// sampling service for GNN recsys).  Adjacency is a hash map keyed by the
// GLOBAL node id (the client shards edges by src % S, so one server holds
// the full out-neighborhood of each node it owns); sampling is uniform
// without replacement, or weighted (Efraimidis–Spirakis top-k keys) when
// edge weights were supplied.  Missing slots pad with -1.
// ---------------------------------------------------------------------------

namespace {

constexpr uint64_t kFeatMagic = 0xFEA7FEA75EC7104Eull;

struct GraphTable {
  std::unordered_map<int64_t, std::vector<int64_t>> adj;
  std::unordered_map<int64_t, std::vector<float>> wts;  // parallel to adj
  std::unordered_map<int64_t, std::vector<float>> feat;  // node features
  uint64_t feat_dim = 0;  // fixed by the first set_node_feat call
  std::vector<int64_t> nodes;  // insertion order, for random node batches
  std::unordered_map<int64_t, size_t> node_pos;
  uint64_t edges = 0;
  bool weighted = false;
  std::mt19937_64 rng;
  std::mutex mu;

  void touch(int64_t id) {
    if (node_pos.find(id) == node_pos.end()) {
      node_pos.emplace(id, nodes.size());
      nodes.push_back(id);
    }
  }
};

}  // namespace

void* pgt_create(uint64_t seed) {
  auto* g = new GraphTable();
  g->rng.seed(seed);
  return g;
}

void pgt_destroy(void* h) { delete static_cast<GraphTable*>(h); }

// append edges src[i] -> dst[i] (weights nullable; mixing weighted and
// unweighted calls upgrades earlier edges to weight 1)
void pgt_add_edges(void* h, const int64_t* src, const int64_t* dst,
                   const float* w, uint64_t n) {
  auto* g = static_cast<GraphTable*>(h);
  std::lock_guard<std::mutex> lk(g->mu);
  if (w && !g->weighted) {
    g->weighted = true;
    for (auto& kv : g->adj)  // backfill weight 1 for earlier edges
      g->wts[kv.first].assign(kv.second.size(), 1.0f);
  }
  for (uint64_t i = 0; i < n; ++i) {
    // only src joins this shard's node set — dst nodes are registered on
    // THEIR owning shard via pgt_add_nodes (the client fans them out), so
    // per-shard node counts partition the global node set exactly
    g->touch(src[i]);
    g->adj[src[i]].push_back(dst[i]);
    if (g->weighted) g->wts[src[i]].push_back(w ? w[i] : 1.0f);
    ++g->edges;
  }
}

void pgt_add_nodes(void* h, const int64_t* ids, uint64_t n) {
  auto* g = static_cast<GraphTable*>(h);
  std::lock_guard<std::mutex> lk(g->mu);
  for (uint64_t i = 0; i < n; ++i) g->touch(ids[i]);
}

uint64_t pgt_num_nodes(void* h) {
  auto* g = static_cast<GraphTable*>(h);
  std::lock_guard<std::mutex> lk(g->mu);
  return g->nodes.size();
}

uint64_t pgt_num_edges(void* h) {
  auto* g = static_cast<GraphTable*>(h);
  std::lock_guard<std::mutex> lk(g->mu);
  return g->edges;
}

void pgt_degrees(void* h, const int64_t* ids, uint64_t n, int64_t* out) {
  auto* g = static_cast<GraphTable*>(h);
  std::lock_guard<std::mutex> lk(g->mu);
  for (uint64_t i = 0; i < n; ++i) {
    auto it = g->adj.find(ids[i]);
    out[i] = it == g->adj.end() ? 0 : (int64_t)it->second.size();
  }
}

// out[i, :] = up to k sampled out-neighbors of ids[i], -1 padded.
// degree <= k returns the whole neighborhood (reference sample semantics);
// otherwise k distinct neighbors — uniformly, or by weight when weighted.
void pgt_sample_neighbors(void* h, const int64_t* ids, uint64_t n,
                          uint64_t k, int64_t* out) {
  auto* g = static_cast<GraphTable*>(h);
  std::lock_guard<std::mutex> lk(g->mu);
  std::vector<uint32_t> idx;
  std::vector<std::pair<float, uint32_t>> keys;  // weighted top-k
  std::uniform_real_distribution<float> uni(
      std::numeric_limits<float>::min(), 1.0f);
  for (uint64_t i = 0; i < n; ++i) {
    int64_t* row = out + i * k;
    auto it = g->adj.find(ids[i]);
    const uint64_t d = it == g->adj.end() ? 0 : it->second.size();
    if (d <= k) {
      for (uint64_t j = 0; j < k; ++j)
        row[j] = j < d ? it->second[j] : -1;
      continue;
    }
    const auto& nb = it->second;
    if (g->weighted) {
      // Efraimidis–Spirakis: top-k of u^(1/w) draws k items w/o
      // replacement with probability proportional to weight
      const auto& wt = g->wts[ids[i]];
      keys.clear();
      keys.reserve(d);
      for (uint64_t j = 0; j < d; ++j) {
        float u = uni(g->rng);
        float key = wt[j] > 0 ? std::pow(u, 1.0f / wt[j]) : 0.0f;
        keys.emplace_back(key, (uint32_t)j);
      }
      std::partial_sort(keys.begin(), keys.begin() + k, keys.end(),
                        [](auto& a, auto& b) { return a.first > b.first; });
      for (uint64_t j = 0; j < k; ++j) row[j] = nb[keys[j].second];
    } else {
      // partial Fisher–Yates over an index scratch
      idx.resize(d);
      for (uint64_t j = 0; j < d; ++j) idx[j] = (uint32_t)j;
      for (uint64_t j = 0; j < k; ++j) {
        std::uniform_int_distribution<uint64_t> pick(j, d - 1);
        std::swap(idx[j], idx[pick(g->rng)]);
        row[j] = nb[idx[j]];
      }
    }
  }
}

// k nodes drawn uniformly (with replacement) from this shard's node set
void pgt_random_sample_nodes(void* h, uint64_t k, int64_t* out) {
  auto* g = static_cast<GraphTable*>(h);
  std::lock_guard<std::mutex> lk(g->mu);
  if (g->nodes.empty()) {
    for (uint64_t i = 0; i < k; ++i) out[i] = -1;
    return;
  }
  std::uniform_int_distribution<uint64_t> pick(0, g->nodes.size() - 1);
  for (uint64_t i = 0; i < k; ++i) out[i] = g->nodes[pick(g->rng)];
}

// Node feature blobs (reference common_graph_table.h:121
// get_node_feat/set_node_feat): the half of the GNN path that feeds the
// model — sampled subgraphs come back with their input vectors attached.
// Feature dim is fixed by the first set call; a mismatch returns -1.
int pgt_set_node_feat(void* h, const int64_t* ids, const float* feats,
                      uint64_t n, uint64_t dim) {
  auto* g = static_cast<GraphTable*>(h);
  std::lock_guard<std::mutex> lk(g->mu);
  if (dim == 0) return -1;
  if (g->feat_dim == 0) g->feat_dim = dim;
  if (g->feat_dim != dim) return -1;
  for (uint64_t i = 0; i < n; ++i) {
    g->touch(ids[i]);
    auto& v = g->feat[ids[i]];
    v.assign(feats + i * dim, feats + (i + 1) * dim);
  }
  return 0;
}

// out is [n * dim]; nodes with no stored feature fill with zeros and set
// found[i] = 0 (found nullable).  dim must match the table's feat_dim
// (0 allowed when the table holds no features yet: everything zero-fills).
int pgt_get_node_feat(void* h, const int64_t* ids, uint64_t n,
                      uint64_t dim, float* out, uint8_t* found) {
  auto* g = static_cast<GraphTable*>(h);
  std::lock_guard<std::mutex> lk(g->mu);
  if (g->feat_dim != 0 && dim != g->feat_dim) return -1;
  for (uint64_t i = 0; i < n; ++i) {
    auto it = g->feat.find(ids[i]);
    if (it == g->feat.end()) {
      std::fill(out + i * dim, out + (i + 1) * dim, 0.0f);
      if (found) found[i] = 0;
    } else {
      std::copy(it->second.begin(), it->second.end(), out + i * dim);
      if (found) found[i] = 1;
    }
  }
  return 0;
}

uint64_t pgt_feat_dim(void* h) {
  auto* g = static_cast<GraphTable*>(h);
  std::lock_guard<std::mutex> lk(g->mu);
  return g->feat_dim;
}

// snapshot: u64 n_nodes, u64 flags (bit0 weighted, bit1 features), then
// per node: id, degree, neighbors, weights?; if bit1: u64 feat_dim,
// u64 n_feat, then per feature node: id + feat_dim floats.  Old files
// (flags in {0,1}) load unchanged.
int pgt_save(void* h, const char* path) {
  auto* g = static_cast<GraphTable*>(h);
  std::lock_guard<std::mutex> lk(g->mu);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint64_t flags = (g->weighted ? 1ull : 0ull)
                   | (g->feat.empty() ? 0ull : 2ull);
  uint64_t hdr[2] = {g->nodes.size(), flags};
  std::fwrite(hdr, sizeof(uint64_t), 2, f);
  for (int64_t id : g->nodes) {
    auto it = g->adj.find(id);
    uint64_t d = it == g->adj.end() ? 0 : it->second.size();
    std::fwrite(&id, sizeof(int64_t), 1, f);
    std::fwrite(&d, sizeof(uint64_t), 1, f);
    if (d) {
      std::fwrite(it->second.data(), sizeof(int64_t), d, f);
      if (g->weighted) std::fwrite(g->wts[id].data(), sizeof(float), d, f);
    }
  }
  if (flags & 2ull) {
    // magic guards the section boundary so truncated/corrupt files fail
    // with -3 instead of misparsing; NOTE this is a format extension —
    // pre-feature loaders misread flags=2 as 'weighted', so feature
    // snapshots require this loader version or newer
    uint64_t fhdr[3] = {kFeatMagic, g->feat_dim, g->feat.size()};
    std::fwrite(fhdr, sizeof(uint64_t), 3, f);
    for (const auto& kv : g->feat) {
      std::fwrite(&kv.first, sizeof(int64_t), 1, f);
      std::fwrite(kv.second.data(), sizeof(float), g->feat_dim, f);
    }
  }
  std::fclose(f);
  return 0;
}

int pgt_load(void* h, const char* path) {
  auto* g = static_cast<GraphTable*>(h);
  std::lock_guard<std::mutex> lk(g->mu);
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint64_t hdr[2];
  if (std::fread(hdr, sizeof(uint64_t), 2, f) != 2) {
    std::fclose(f);
    return -2;
  }
  g->adj.clear();
  g->wts.clear();
  g->feat.clear();
  g->feat_dim = 0;
  g->nodes.clear();
  g->node_pos.clear();
  g->edges = 0;
  g->weighted = (hdr[1] & 1ull) != 0;
  for (uint64_t i = 0; i < hdr[0]; ++i) {
    int64_t id;
    uint64_t d;
    if (std::fread(&id, sizeof(int64_t), 1, f) != 1 ||
        std::fread(&d, sizeof(uint64_t), 1, f) != 1) {
      std::fclose(f);
      return -3;
    }
    g->touch(id);
    if (!d) continue;
    auto& nb = g->adj[id];
    nb.resize(d);
    if (std::fread(nb.data(), sizeof(int64_t), d, f) != d) {
      std::fclose(f);
      return -3;
    }
    if (g->weighted) {
      auto& wt = g->wts[id];
      wt.resize(d);
      if (std::fread(wt.data(), sizeof(float), d, f) != d) {
        std::fclose(f);
        return -3;
      }
    }
    g->edges += d;
  }
  if (hdr[1] & 2ull) {
    uint64_t fhdr[3];
    if (std::fread(fhdr, sizeof(uint64_t), 3, f) != 3 ||
        fhdr[0] != kFeatMagic) {
      std::fclose(f);
      return -3;
    }
    // bound the claimed sizes against the bytes actually remaining, so a
    // corrupt header can never drive a huge allocation before the short
    // read would fail
    long pos = std::ftell(f);
    std::fseek(f, 0, SEEK_END);
    long end = std::ftell(f);
    std::fseek(f, pos, SEEK_SET);
    uint64_t remain = end > pos ? static_cast<uint64_t>(end - pos) : 0;
    if (fhdr[1] == 0 || fhdr[1] > remain / sizeof(float)) {
      std::fclose(f);
      return -3;
    }
    uint64_t per = sizeof(int64_t) + fhdr[1] * sizeof(float);
    if (fhdr[2] > remain / per) {
      std::fclose(f);
      return -3;
    }
    g->feat_dim = fhdr[1];
    for (uint64_t i = 0; i < fhdr[2]; ++i) {
      int64_t id;
      if (std::fread(&id, sizeof(int64_t), 1, f) != 1) {
        std::fclose(f);
        return -3;
      }
      g->touch(id);
      auto& v = g->feat[id];
      v.resize(g->feat_dim);
      if (std::fread(v.data(), sizeof(float), g->feat_dim, f)
          != g->feat_dim) {
        std::fclose(f);
        return -3;
      }
    }
  }
  std::fclose(f);
  return 0;
}

int pst_load(void* h, const char* path) {
  auto* t = static_cast<Table*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint64_t hdr[2];
  if (std::fread(hdr, sizeof(uint64_t), 2, f) != 2 || hdr[0] != t->rows ||
      hdr[1] != t->dim) {
    std::fclose(f);
    return -2;
  }
  size_t r1 = std::fread(t->data(), sizeof(float), t->rows * t->dim, f);
  size_t r2 = std::fread(t->accum(), sizeof(float), t->rows, f);
  std::fclose(f);
  return (r1 == t->rows * t->dim && r2 == t->rows) ? 0 : -3;
}

}  // extern "C"
