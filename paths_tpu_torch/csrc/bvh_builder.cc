// Host BVH builder for the port's triangle tables: top-down binned-SAH over
// per-triangle boxes, flattened to the reference's skip-link layout.
//
// A copy of the BVH part of paths_tpu/native/bvh_builder.cc (entry
// paths_build_bvh), kept in the port so that it depends on nothing of the
// reference package.  The builder's order fixes triangle ids, which chunk each
// triangle falls in and so the recentred plane constants of the packed table;
// the copy is built with the reference's flags (paths_tpu/native/Makefile) so
// that the table equals the reference's bit for bit.  Python's builder
// (bvh/build.py) takes meshes of at most 512 triangles, as in the reference.
//
// The top levels of the recursion run on threads; the subtrees are
// independent, so the output does not depend on scheduling.
//
// C ABI (bound with ctypes in paths_tpu_torch/bvh/build.py):
//   paths_build_bvh(tri_min, tri_max, n_tris, leaf_size,
//                   node_min, node_max, hit_link, miss_link,
//                   prim_start, prim_count, order, &n_nodes, &depth)
// The caller allocates node buffers of capacity 2 * n + 2.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr int kNumBins = 16;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Aabb {
  Vec3 lo{std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity()};
  Vec3 hi{-std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity()};
  void grow(const Aabb& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  // Surface area (the SAH cost driver).
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.0f);
    float dy = std::max(hi.y - lo.y, 0.0f);
    float dz = std::max(hi.z - lo.z, 0.0f);
    return 2.0f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Node {
  Aabb bounds;
  int lo = 0, hi = 0;     // primitive range [lo, hi) in `order`
  Node* left = nullptr;   // nullptr => leaf
  Node* right = nullptr;
};

struct Builder {
  const float* tri_min;  // (n, 3)
  const float* tri_max;  // (n, 3)
  std::vector<Vec3> centers;
  std::vector<int64_t> order;
  int leaf_size;
  // Node arena: preallocated, bump-allocated under an atomic so worker
  // threads never contend on malloc.
  std::vector<Node> arena;
  std::atomic<size_t> arena_top{0};

  Node* alloc() {
    size_t i = arena_top.fetch_add(1, std::memory_order_relaxed);
    return &arena[i];
  }

  Aabb prim_bounds(int64_t p) const {
    Aabb b;
    b.lo = {tri_min[3 * p], tri_min[3 * p + 1], tri_min[3 * p + 2]};
    b.hi = {tri_max[3 * p], tri_max[3 * p + 1], tri_max[3 * p + 2]};
    return b;
  }

  Aabb range_bounds(int lo, int hi) const {
    Aabb b;
    for (int i = lo; i < hi; ++i) b.grow(prim_bounds(order[i]));
    return b;
  }

  // Split [lo, hi): returns mid, or -1 for "make a leaf".
  int split(Node* nd) {
    const int lo = nd->lo, hi = nd->hi, n = hi - lo;
    if (n <= leaf_size) return -1;

    // Centroid bounds pick the split axis.
    Vec3 cmin{std::numeric_limits<float>::infinity(),
              std::numeric_limits<float>::infinity(),
              std::numeric_limits<float>::infinity()};
    Vec3 cmax{-cmin.x, -cmin.y, -cmin.z};
    for (int i = lo; i < hi; ++i) {
      const Vec3& c = centers[order[i]];
      cmin = vmin(cmin, c);
      cmax = vmax(cmax, c);
    }
    float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    int axis = 0;
    if (ext[1] > ext[0]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    if (ext[axis] <= 0.0f) return lo + n / 2;  // all centroids identical

    const float cmin_a = axis == 0 ? cmin.x : axis == 1 ? cmin.y : cmin.z;
    const float inv_ext = kNumBins / ext[axis];

    // Binned SAH: one pass bins primitives, prefix/suffix sweeps score the
    // 15 candidate planes.
    int counts[kNumBins] = {0};
    Aabb bins[kNumBins];
    auto bin_of = [&](int64_t p) {
      const Vec3& c = centers[p];
      float ca = axis == 0 ? c.x : axis == 1 ? c.y : c.z;
      int b = static_cast<int>((ca - cmin_a) * inv_ext);
      return std::min(std::max(b, 0), kNumBins - 1);
    };
    for (int i = lo; i < hi; ++i) {
      int b = bin_of(order[i]);
      counts[b]++;
      bins[b].grow(prim_bounds(order[i]));
    }

    float larea[kNumBins], rarea[kNumBins];
    int lcount[kNumBins], rcount[kNumBins];
    {
      Aabb acc;
      int c = 0;
      for (int b = 0; b < kNumBins; ++b) {
        acc.grow(bins[b]);
        c += counts[b];
        larea[b] = acc.area();
        lcount[b] = c;
      }
      acc = Aabb();
      c = 0;
      for (int b = kNumBins - 1; b >= 0; --b) {
        acc.grow(bins[b]);
        c += counts[b];
        rarea[b] = acc.area();
        rcount[b] = c;
      }
    }
    float best_cost = std::numeric_limits<float>::infinity();
    int best_split = -1;
    for (int s = 0; s < kNumBins - 1; ++s) {
      if (lcount[s] == 0 || rcount[s + 1] == 0) continue;
      float cost = larea[s] * lcount[s] + rarea[s + 1] * rcount[s + 1];
      if (cost < best_cost) {
        best_cost = cost;
        best_split = s;
      }
    }
    if (best_split < 0) return lo + n / 2;

    // In-place stable-ish partition of order[lo:hi].
    int64_t* base = order.data();
    int64_t* mid_p = std::stable_partition(
        base + lo, base + hi,
        [&](int64_t p) { return bin_of(p) <= best_split; });
    int mid = static_cast<int>(mid_p - base);
    if (mid <= lo || mid >= hi) mid = lo + n / 2;
    return mid;
  }

  // fork_levels: spawn a thread for the right child while this thread takes
  // the left, for the top log2(hw_concurrency) levels of the tree (at most 4).
  void build(Node* nd, int fork_levels) {
    int mid = split(nd);
    if (mid < 0) return;  // leaf
    Node* l = alloc();
    Node* r = alloc();
    l->lo = nd->lo; l->hi = mid;
    r->lo = mid; r->hi = nd->hi;
    l->bounds = range_bounds(l->lo, l->hi);
    r->bounds = range_bounds(r->lo, r->hi);
    nd->left = l;
    nd->right = r;
    if (fork_levels > 0) {
      std::thread t([this, r, fork_levels] { build(r, fork_levels - 1); });
      build(l, fork_levels - 1);
      t.join();
    } else {
      build(l, 0);
      build(r, 0);
    }
  }
};

// Iterative preorder flatten with hit/miss skip links (the layout of
// bvh/build.py's Python builder).
void flatten(const Node* root, float* node_min, float* node_max,
             int32_t* hit_link, int32_t* miss_link, int32_t* prim_start,
             int32_t* prim_count, int64_t* n_nodes_out, int32_t* depth_out) {
  // Subtree sizes, indexed by arena offset (nodes live in one contiguous
  // arena whose first allocation is the root).
  const Node* base = root;
  size_t count = 0;
  {
    std::vector<const Node*> s{root};
    while (!s.empty()) {
      const Node* n = s.back();
      s.pop_back();
      ++count;
      if (n->left) {
        s.push_back(n->left);
        s.push_back(n->right);
      }
    }
  }
  std::vector<size_t> size_by_index(count * 2, 0);
  {
    std::vector<std::pair<const Node*, bool>> s{{root, false}};
    while (!s.empty()) {
      auto [n, done] = s.back();
      s.pop_back();
      size_t idx = static_cast<size_t>(n - base);
      if (!n->left) {
        size_by_index[idx] = 1;
        continue;
      }
      if (done) {
        size_by_index[idx] = 1 + size_by_index[n->left - base] +
                             size_by_index[n->right - base];
      } else {
        s.push_back({n, true});
        s.push_back({n->left, false});
        s.push_back({n->right, false});
      }
    }
  }

  int64_t out = 0;
  int32_t max_depth = 0;
  struct Frame {
    const Node* n;
    int32_t skip;
    int32_t depth;
  };
  std::vector<Frame> s{{root, -1, 0}};
  while (!s.empty()) {
    Frame f = s.back();
    s.pop_back();
    const Node* n = f.n;
    int64_t i = out++;
    node_min[3 * i] = n->bounds.lo.x;
    node_min[3 * i + 1] = n->bounds.lo.y;
    node_min[3 * i + 2] = n->bounds.lo.z;
    node_max[3 * i] = n->bounds.hi.x;
    node_max[3 * i + 1] = n->bounds.hi.y;
    node_max[3 * i + 2] = n->bounds.hi.z;
    miss_link[i] = f.skip;
    max_depth = std::max(max_depth, f.depth);
    if (!n->left) {
      prim_start[i] = n->lo;
      prim_count[i] = n->hi - n->lo;
      hit_link[i] = f.skip;
    } else {
      prim_start[i] = 0;
      prim_count[i] = 0;
      hit_link[i] = static_cast<int32_t>(i + 1);
      int32_t right_idx =
          static_cast<int32_t>(i + 1 + size_by_index[n->left - base]);
      s.push_back({n->right, f.skip, f.depth + 1});
      s.push_back({n->left, right_idx, f.depth + 1});
    }
  }
  *n_nodes_out = out;
  *depth_out = max_depth;
}

}  // namespace

extern "C" {

// Returns 0 on success.  Buffers: node_* capacity >= 4*ceil(n/1)+2 is safe;
// the binding allocates 2*n + 2 nodes (leaf_size >= 1 means <= n leaves,
// a binary tree over L leaves has 2L-1 nodes).
int paths_build_bvh(const float* tri_min, const float* tri_max, int64_t n,
                    int32_t leaf_size, float* node_min, float* node_max,
                    int32_t* hit_link, int32_t* miss_link,
                    int32_t* prim_start, int32_t* prim_count, int64_t* order,
                    int64_t* n_nodes, int32_t* depth) {
  if (n <= 0 || leaf_size < 1) return 1;
  Builder b;
  b.tri_min = tri_min;
  b.tri_max = tri_max;
  b.leaf_size = leaf_size;
  b.centers.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    b.centers[i] = {(tri_min[3 * i] + tri_max[3 * i]) * 0.5f,
                    (tri_min[3 * i + 1] + tri_max[3 * i + 1]) * 0.5f,
                    (tri_min[3 * i + 2] + tri_max[3 * i + 2]) * 0.5f};
  }
  b.order.resize(n);
  for (int64_t i = 0; i < n; ++i) b.order[i] = i;
  b.arena.resize(2 * static_cast<size_t>(n) + 2);

  Node* root = b.alloc();
  root->lo = 0;
  root->hi = static_cast<int>(n);
  root->bounds = b.range_bounds(0, static_cast<int>(n));

  unsigned hw = std::thread::hardware_concurrency();
  int fork_levels = 0;
  while ((1u << fork_levels) < hw && fork_levels < 4) ++fork_levels;
  b.build(root, fork_levels);

  flatten(root, node_min, node_max, hit_link, miss_link, prim_start,
          prim_count, n_nodes, depth);
  std::memcpy(order, b.order.data(), sizeof(int64_t) * n);
  return 0;
}

}  // extern "C"
