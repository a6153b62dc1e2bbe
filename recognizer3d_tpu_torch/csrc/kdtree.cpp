// Exact k-nearest-neighbour search over 3-D point clouds with a bucketed
// KD-tree, on the host: the port's copy of recognizer3d_tpu/native/kdtree.cpp,
// the same code. It serves knn="kdtree" (ops/knn_cpp.py): a median-split
// bucketed KD-tree build and a branch-and-bound query with a bounded
// max-heap, serial over the batch and parallel over the queries (OpenMP).
// Built by g++ at first use (ops/_build.py: build_kdtree) and loaded with
// ctypes through its plain C interface.
//
// Contract (as ops/knn.py): indices int32 (B, M, k) into the support,
// squared L2 distances float32 (B, M, k), ascending by distance.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int kLeafSize = 16;

struct Node {
  // internal node: split axis/value + children; leaf: [begin, end) range
  float split;
  int32_t left;   // -1 for leaf
  int32_t right;  // -1 for leaf
  int32_t begin;
  int32_t end;
  int8_t axis;
};

// Per-query bounded max-heap over (distance², index).
struct QueryState {
  std::vector<float> d;
  std::vector<int32_t> i;
  int32_t k = 0;
  float worst = std::numeric_limits<float>::infinity();

  void reset(int32_t k_in) {
    d.clear();
    i.clear();
    k = k_in;
    worst = std::numeric_limits<float>::infinity();
  }

  // restore the max-heap property from the root over the first n entries
  inline void sift_down(int32_t n) {
    int32_t c = 0;
    for (;;) {
      const int32_t l = 2 * c + 1, r = 2 * c + 2;
      int32_t largest = c;
      if (l < n && d[l] > d[largest]) largest = l;
      if (r < n && d[r] > d[largest]) largest = r;
      if (largest == c) break;
      std::swap(d[c], d[largest]);
      std::swap(i[c], i[largest]);
      c = largest;
    }
  }

  inline void push(float d2, int32_t idx) {
    if (static_cast<int32_t>(d.size()) < k) {
      d.push_back(d2);
      i.push_back(idx);
      int32_t c = static_cast<int32_t>(d.size()) - 1;
      while (c > 0) {
        const int32_t parent = (c - 1) / 2;
        if (d[parent] >= d[c]) break;
        std::swap(d[parent], d[c]);
        std::swap(i[parent], i[c]);
        c = parent;
      }
      if (static_cast<int32_t>(d.size()) == k) worst = d[0];
    } else if (d2 < worst) {
      d[0] = d2;
      i[0] = idx;
      sift_down(static_cast<int32_t>(d.size()));
      worst = d[0];
    }
  }
};

class KDTree {
 public:
  KDTree(const float* pts, int32_t n) : pts_(pts), n_(n) {
    order_.resize(n);
    for (int32_t i = 0; i < n; ++i) order_[i] = i;
    nodes_.reserve(2 * n / kLeafSize + 8);
    root_ = build(0, n);
  }

  // k smallest squared distances to `q`, ascending; fills exactly
  // min(k, n) entries and returns that count. Thread-safe.
  int32_t query(const float* q, int32_t k, QueryState& state,
                int32_t* out_idx, float* out_d2) const {
    state.reset(std::min(k, n_));
    if (state.k <= 0) return 0;  // k==0 request or empty support
    search(root_, q, state);
    const int32_t cnt = static_cast<int32_t>(state.d.size());
    // heap-sort in place (state.d is already a max-heap): ascending order
    // with zero per-query allocation — this runs once per query in the
    // parallel hot loop, so no std::vector churn here
    for (int32_t sz = cnt; sz > 1; --sz) {
      std::swap(state.d[0], state.d[sz - 1]);
      std::swap(state.i[0], state.i[sz - 1]);
      state.sift_down(sz - 1);
    }
    for (int32_t j = 0; j < cnt; ++j) {
      out_idx[j] = state.i[j];
      out_d2[j] = state.d[j];
    }
    return cnt;
  }

 private:
  int32_t build(int32_t begin, int32_t end) {
    Node node;
    node.begin = begin;
    node.end = end;
    node.left = node.right = -1;
    node.axis = 0;
    node.split = 0.0f;
    const int32_t id = static_cast<int32_t>(nodes_.size());
    nodes_.push_back(node);
    if (end - begin <= kLeafSize) return id;

    // split on the widest-extent axis at the median
    float lo[3] = {1e30f, 1e30f, 1e30f};
    float hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int32_t i = begin; i < end; ++i) {
      const float* p = pts_ + 3 * order_[i];
      for (int d = 0; d < 3; ++d) {
        lo[d] = std::min(lo[d], p[d]);
        hi[d] = std::max(hi[d], p[d]);
      }
    }
    int axis = 0;
    for (int d = 1; d < 3; ++d)
      if (hi[d] - lo[d] > hi[axis] - lo[axis]) axis = d;

    const int32_t mid = begin + (end - begin) / 2;
    std::nth_element(
        order_.begin() + begin, order_.begin() + mid, order_.begin() + end,
        [&](int32_t a, int32_t b) {
          return pts_[3 * a + axis] < pts_[3 * b + axis];
        });
    const float split = pts_[3 * order_[mid] + axis];

    const int32_t left = build(begin, mid);
    const int32_t right = build(mid, end);
    nodes_[id].axis = static_cast<int8_t>(axis);
    nodes_[id].split = split;
    nodes_[id].left = left;
    nodes_[id].right = right;
    return id;
  }

  void search(int32_t node_id, const float* q, QueryState& state) const {
    const Node& node = nodes_[node_id];
    if (node.left < 0) {  // leaf: scan the bucket
      for (int32_t i = node.begin; i < node.end; ++i) {
        const float* p = pts_ + 3 * order_[i];
        const float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
        state.push(dx * dx + dy * dy + dz * dz, order_[i]);
      }
      return;
    }
    const float delta = q[node.axis] - node.split;
    const int32_t near = delta < 0 ? node.left : node.right;
    const int32_t far = delta < 0 ? node.right : node.left;
    search(near, q, state);
    if (delta * delta < state.worst ||
        static_cast<int32_t>(state.d.size()) < state.k) {
      search(far, q, state);
    }
  }

  const float* pts_;
  int32_t n_;
  std::vector<int32_t> order_;
  std::vector<Node> nodes_;
  int32_t root_;
};

}  // namespace

extern "C" {

// Batched exact KNN. Layouts: support (B, N, 3) f32 contiguous, query
// (B, M, 3) f32 contiguous; outputs (B, M, k) int32 / f32. When N < k the
// trailing slots repeat the last valid neighbour (mirrors the framework's
// padded-sampling semantics).
void knn_kdtree_batch(const float* support, int64_t b, int64_t n,
                      const float* query, int64_t m, int32_t k,
                      int32_t* out_idx, float* out_d2) {
  if (b <= 0 || m <= 0 || k <= 0) return;
  if (n <= 0) {
    // no support points: fail loudly downstream (idx 0 into an empty set
    // would read out of bounds if gathered; +inf fails any radius test).
    // The Python front-end rejects this before calling; defensive here.
    std::fill(out_idx, out_idx + b * m * k, 0);
    std::fill(out_d2, out_d2 + b * m * k,
              std::numeric_limits<float>::infinity());
    return;
  }
  for (int64_t bi = 0; bi < b; ++bi) {
    const float* s = support + bi * n * 3;
    const float* q = query + bi * m * 3;
    int32_t* oi = out_idx + bi * m * k;
    float* od = out_d2 + bi * m * k;
    KDTree tree(s, static_cast<int32_t>(n));
#ifdef _OPENMP
#pragma omp parallel
    {
      QueryState state;
#pragma omp for schedule(static)
      for (int64_t qi = 0; qi < m; ++qi) {
        const int32_t cnt =
            tree.query(q + qi * 3, k, state, oi + qi * k, od + qi * k);
        for (int32_t j = cnt; j < k; ++j) {
          oi[qi * k + j] = cnt > 0 ? oi[qi * k + cnt - 1] : 0;
          od[qi * k + j] = cnt > 0 ? od[qi * k + cnt - 1] : 0.0f;
        }
      }
    }
#else
    QueryState state;
    for (int64_t qi = 0; qi < m; ++qi) {
      const int32_t cnt =
          tree.query(q + qi * 3, k, state, oi + qi * k, od + qi * k);
      for (int32_t j = cnt; j < k; ++j) {
        oi[qi * k + j] = cnt > 0 ? oi[qi * k + cnt - 1] : 0;
        od[qi * k + j] = cnt > 0 ? od[qi * k + cnt - 1] : 0.0f;
      }
    }
#endif
  }
}

int32_t knn_kdtree_abi_version() { return 1; }

}  // extern "C"
