// Native HNSW approximate-nearest-neighbor index.
//
// In-repo replacement for the reference's pip ANN backends (annoy / faiss /
// milvus are optional here): a compact single-file HNSW (Malkov & Yashunin,
// arXiv:1603.09320) with inner-product / L2 / angular metrics, exposed via a
// C API consumed through ctypes (see ../hnsw.py).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 hnsw.cpp -o libhnsw.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

namespace {

enum Metric { METRIC_IP = 0, METRIC_L2 = 1, METRIC_ANGULAR = 2 };

struct HNSW {
  int dim = 0;
  int metric = METRIC_IP;
  int M = 16;
  int ef_construction = 200;
  int entry = -1;
  int max_level = -1;
  double mult = 0.0;  // 1 / ln(M)
  std::mt19937 rng;
  std::vector<float> data;                            // n * dim
  std::vector<std::vector<std::vector<int>>> links;   // node -> level -> neighbors

  int size() const { return static_cast<int>(links.size()); }

  // "distance": smaller is better for every metric (ip/angular use -dot).
  float dist(const float* a, const float* b) const {
    if (metric == METRIC_L2) {
      float s = 0.f;
      for (int i = 0; i < dim; ++i) {
        float d = a[i] - b[i];
        s += d * d;
      }
      return s;
    }
    float s = 0.f;
    for (int i = 0; i < dim; ++i) s += a[i] * b[i];
    return -s;
  }

  const float* vec(int id) const { return data.data() + static_cast<size_t>(id) * dim; }

  int random_level() {
    std::uniform_real_distribution<double> u(0.0, 1.0);
    double r = u(rng);
    if (r < 1e-12) r = 1e-12;
    return static_cast<int>(-std::log(r) * mult);
  }

  // beam search at one level; returns min-heap contents as sorted (dist, id).
  std::vector<std::pair<float, int>> search_layer(const float* q, int ep, int level, int ef) const {
    std::priority_queue<std::pair<float, int>> best;                 // max-heap by dist (worst on top)
    std::priority_queue<std::pair<float, int>, std::vector<std::pair<float, int>>, std::greater<>> cand;
    std::vector<uint8_t> visited(size(), 0);
    float d0 = dist(q, vec(ep));
    best.emplace(d0, ep);
    cand.emplace(d0, ep);
    visited[ep] = 1;
    while (!cand.empty()) {
      auto [dc, c] = cand.top();
      if (dc > best.top().first && static_cast<int>(best.size()) >= ef) break;
      cand.pop();
      if (level < static_cast<int>(links[c].size())) {
        for (int nb : links[c][level]) {
          if (visited[nb]) continue;
          visited[nb] = 1;
          float d = dist(q, vec(nb));
          if (static_cast<int>(best.size()) < ef || d < best.top().first) {
            best.emplace(d, nb);
            cand.emplace(d, nb);
            if (static_cast<int>(best.size()) > ef) best.pop();
          }
        }
      }
    }
    std::vector<std::pair<float, int>> out;
    out.reserve(best.size());
    while (!best.empty()) {
      out.push_back(best.top());
      best.pop();
    }
    std::sort(out.begin(), out.end());
    return out;
  }

  // heuristic neighbor selection (keep diverse closest m)
  std::vector<int> select_neighbors(const float* q, std::vector<std::pair<float, int>>& cands, int m) const {
    std::vector<int> result;
    for (auto& [d, id] : cands) {
      if (static_cast<int>(result.size()) >= m) break;
      bool ok = true;
      for (int r : result) {
        if (dist(vec(id), vec(r)) < d) {  // closer to an already-selected node than to q
          ok = false;
          break;
        }
      }
      if (ok) result.push_back(id);
    }
    // backfill with closest skipped candidates
    for (auto& [d, id] : cands) {
      if (static_cast<int>(result.size()) >= m) break;
      if (std::find(result.begin(), result.end(), id) == result.end()) result.push_back(id);
    }
    return result;
  }

  void add(const float* v) {
    int id = size();
    data.insert(data.end(), v, v + dim);
    if (metric == METRIC_ANGULAR) {  // store normalized
      float* p = data.data() + static_cast<size_t>(id) * dim;
      float n = 0.f;
      for (int i = 0; i < dim; ++i) n += p[i] * p[i];
      n = std::sqrt(std::max(n, 1e-12f));
      for (int i = 0; i < dim; ++i) p[i] /= n;
    }
    int level = random_level();
    links.emplace_back(level + 1);
    if (entry < 0) {
      entry = id;
      max_level = level;
      return;
    }
    const float* q = vec(id);
    int ep = entry;
    for (int l = max_level; l > level; --l) {
      // greedy move at upper levels
      bool improved = true;
      float dq = dist(q, vec(ep));
      while (improved) {
        improved = false;
        if (l < static_cast<int>(links[ep].size())) {
          for (int nb : links[ep][l]) {
            float d = dist(q, vec(nb));
            if (d < dq) {
              dq = d;
              ep = nb;
              improved = true;
            }
          }
        }
      }
    }
    for (int l = std::min(level, max_level); l >= 0; --l) {
      auto cands = search_layer(q, ep, l, ef_construction);
      int m = (l == 0) ? 2 * M : M;
      auto neigh = select_neighbors(q, cands, M);
      links[id][l] = neigh;
      for (int nb : neigh) {
        auto& lst = links[nb][l];
        lst.push_back(id);
        if (static_cast<int>(lst.size()) > m) {
          // shrink: keep m best by distance to nb
          std::vector<std::pair<float, int>> scored;
          scored.reserve(lst.size());
          for (int x : lst) scored.emplace_back(dist(vec(nb), vec(x)), x);
          std::sort(scored.begin(), scored.end());
          auto kept = select_neighbors(vec(nb), scored, m);
          lst = kept;
        }
      }
      if (!cands.empty()) ep = cands.front().second;
    }
    if (level > max_level) {
      max_level = level;
      entry = id;
    }
  }

  void search(const float* q, int k, int ef, int* out_ids, float* out_dists) const {
    std::vector<float> qn;
    if (metric == METRIC_ANGULAR) {
      qn.assign(q, q + dim);
      float n = 0.f;
      for (int i = 0; i < dim; ++i) n += qn[i] * qn[i];
      n = std::sqrt(std::max(n, 1e-12f));
      for (int i = 0; i < dim; ++i) qn[i] /= n;
      q = qn.data();
    }
    if (entry < 0) {
      for (int i = 0; i < k; ++i) {
        out_ids[i] = -1;
        out_dists[i] = 0.f;
      }
      return;
    }
    int ep = entry;
    for (int l = max_level; l > 0; --l) {
      bool improved = true;
      float dq = dist(q, vec(ep));
      while (improved) {
        improved = false;
        if (l < static_cast<int>(links[ep].size())) {
          for (int nb : links[ep][l]) {
            float d = dist(q, vec(nb));
            if (d < dq) {
              dq = d;
              ep = nb;
              improved = true;
            }
          }
        }
      }
    }
    auto res = search_layer(q, ep, 0, std::max(ef, k));
    for (int i = 0; i < k; ++i) {
      if (i < static_cast<int>(res.size())) {
        out_ids[i] = res[i].second;
        out_dists[i] = res[i].first;
      } else {
        out_ids[i] = -1;
        out_dists[i] = 0.f;
      }
    }
  }

  bool save(const char* path) const {
    FILE* f = std::fopen(path, "wb");
    if (!f) return false;
    int n = size();
    std::fwrite(&dim, 4, 1, f);
    std::fwrite(&metric, 4, 1, f);
    std::fwrite(&M, 4, 1, f);
    std::fwrite(&ef_construction, 4, 1, f);
    std::fwrite(&entry, 4, 1, f);
    std::fwrite(&max_level, 4, 1, f);
    std::fwrite(&n, 4, 1, f);
    std::fwrite(data.data(), 4, data.size(), f);
    for (const auto& node : links) {
      int levels = static_cast<int>(node.size());
      std::fwrite(&levels, 4, 1, f);
      for (const auto& lst : node) {
        int cnt = static_cast<int>(lst.size());
        std::fwrite(&cnt, 4, 1, f);
        std::fwrite(lst.data(), 4, lst.size(), f);
      }
    }
    std::fclose(f);
    return true;
  }

  bool load(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    int n = 0;
    bool ok = std::fread(&dim, 4, 1, f) == 1 && std::fread(&metric, 4, 1, f) == 1 && std::fread(&M, 4, 1, f) == 1 &&
              std::fread(&ef_construction, 4, 1, f) == 1 && std::fread(&entry, 4, 1, f) == 1 &&
              std::fread(&max_level, 4, 1, f) == 1 && std::fread(&n, 4, 1, f) == 1;
    if (!ok) {
      std::fclose(f);
      return false;
    }
    mult = 1.0 / std::log(std::max(2, M));
    data.resize(static_cast<size_t>(n) * dim);
    ok = std::fread(data.data(), 4, data.size(), f) == data.size();
    links.assign(n, {});
    for (int i = 0; ok && i < n; ++i) {
      int levels = 0;
      ok = std::fread(&levels, 4, 1, f) == 1;
      links[i].resize(levels);
      for (int l = 0; ok && l < levels; ++l) {
        int cnt = 0;
        ok = std::fread(&cnt, 4, 1, f) == 1;
        links[i][l].resize(cnt);
        if (cnt) ok = std::fread(links[i][l].data(), 4, cnt, f) == static_cast<size_t>(cnt);
      }
    }
    std::fclose(f);
    return ok;
  }
};

}  // namespace

extern "C" {

void* hnsw_create(int dim, int metric, int M, int ef_construction, unsigned seed) {
  auto* h = new HNSW();
  h->dim = dim;
  h->metric = metric;
  h->M = std::max(2, M);
  h->ef_construction = ef_construction;
  h->mult = 1.0 / std::log(static_cast<double>(h->M));
  h->rng.seed(seed);
  return h;
}

void hnsw_add(void* idx, const float* vecs, int n) {
  auto* h = static_cast<HNSW*>(idx);
  for (int i = 0; i < n; ++i) h->add(vecs + static_cast<size_t>(i) * h->dim);
}

void hnsw_search(void* idx, const float* queries, int nq, int k, int ef_search, int* out_ids, float* out_dists) {
  auto* h = static_cast<HNSW*>(idx);
  for (int i = 0; i < nq; ++i) {
    h->search(queries + static_cast<size_t>(i) * h->dim, k, ef_search, out_ids + static_cast<size_t>(i) * k,
              out_dists + static_cast<size_t>(i) * k);
  }
}

int hnsw_save(void* idx, const char* path) { return static_cast<HNSW*>(idx)->save(path) ? 1 : 0; }

void* hnsw_load(const char* path) {
  auto* h = new HNSW();
  if (!h->load(path)) {
    delete h;
    return nullptr;
  }
  return h;
}

int hnsw_size(void* idx) { return static_cast<HNSW*>(idx)->size(); }
int hnsw_dim(void* idx) { return static_cast<HNSW*>(idx)->dim; }
void hnsw_free(void* idx) { delete static_cast<HNSW*>(idx); }

}  // extern "C"
