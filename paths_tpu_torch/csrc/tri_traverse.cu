// Triangle traversal kernels for Hopper (sm_90a): closest-hit (K3) and
// any-hit (K4) over the packed plane-form triangle table, walked through a
// box hierarchy over the table's rows.
//
// Replaces paths_tpu/ops/sorted_traverse.py::_make_sorted_kernel in its two
// triangle forms (closest_hit_sorted, occludes_sorted), whose per-slot
// arithmetic is paths_tpu/ops/pallas_traverse.py::_tri_row_test_v2 on the
// origin recentred by _chunk_shift.  The contract ported is that kernel's
// outputs, not its TPU schedule: the reference sorts each ray block's
// candidate chunks by entry distance (_block_cull_keys), culls by the root
// box with a t_exit bound (_launch_sorted) and walks the list front to back
// until every lane of the block is settled.  Here each lane walks a
// hierarchy front to back on its own.
//
// Layout (built by ops/tri_traverse.py::pack_chunked):
//   tris (R, 128) f32: one BVH leaf per row, 8 slots per row, slot =
//     [n.xyz dd g1.xyz c1 g2.xyz c2 gid 0 ent 0], plane constants relative
//     to the slot's chunk centre c = 0.5 * (lo + hi); a leaf's triangles
//     fill its first slots, and an empty slot has gid = -1 and c1 = c2 =
//     -BIG (a degenerate one only c1 = c2 = -BIG).
//   meta (C, 128) f32 per chunk: [lo.xyz hi.xyz row0 nrows ...]; the walk
//     reads only a chunk's box, for the recentring.
//   nodes (M, 8) f32, two float4 per node: [lo.xyz ref | hi.xyz aux], the
//     mesh BVH's own binary tree over the rows, in preorder (root 0).  An
//     inner node has ref = left child, aux = right child; a leaf (one row)
//     has ref = -1 - row and aux = the row's chunk.  A leaf's box is its
//     row's box padded by row_tests.cuh's kBoxPad rule, an inner node's the
//     union of its children's, so f32 rounding of a box can only keep a
//     row, never drop one.  Indices as f32 (exact below 2^24).  The BVH's
//     tree was chosen over an implicit tree that halves contiguous row
//     ranges, which tests 2.2-2.7 times as many boxes per ray on doom and
//     dragon (scripts/tri_hierarchy_shapes.py).
//
// Per slot, with o' = o - 0.5f * (lo + hi) of its chunk (f32, as the
// pack-time centre): the plane-form test of row_tests.cuh::tri_slot, with
// the fourteen fused multiply-adds the reference kernel gets when XLA
// compiles it for the CPU.  The closest-hit answer is the lexicographic
// minimum of (t, table position row * 8 + slot) over slots that pass with
// t < t_init and gid != excl: t, gid and ent of that slot, or t = BIG and
// gid = ent = 0 when there is none.  Any-hit: some slot passes with t <
// t_max, gid != excl and ent != excl_ent; it collapses t to 0 at the first
// such slot and reports t == 0, so a lane seeded with t_max == 0 reports
// occluded, exactly as the reference kernel does.  A lane with o.x > 1e29
// is dead: a miss / not occluded (occluded when t_max == 0).
//
// The walk, one thread per lane: slab-test the root; at an inner node
// slab-test both children against the running t_best, descend into the
// nearer (the left one on a tie) and push the farther with its entry
// distance; at a leaf test its slots; then pop, discarding entries whose
// entry distance is greater than t_best.  Out of table order a strict
// t < t_best no longer gives the first slot of a tie, so a slot replaces the
// best when t < t_best || (t == t_best && pos < pos_best), with pos_best = -1
// until a hit: a slot at exactly t_init never enters.  A box entered at
// exactly t_best is kept (tmin <= t_best), and so is a popped entry at
// exactly t_best, so a tie in another row is always reached.  A stack entry
// is pushed once per inner level on the current path, so the stack holds at
// most the tree's depth in inner nodes; pack_chunked refuses a tree deeper
// than kStack = 64 (doom_standin's tree has 17 levels, dragon_standin's 21:
// scripts/tri_hierarchy_shapes.py).
//
// What bounds it on this card: bytes.  The function's work, counted by
// chip_smoke.py::leaf_bound -- the needed leaves' triangles (64 B each) and
// the nodes a lane enters (40 B), read once -- takes longer to move at 3.35
// TB/s than its operations (32 FP32 per slot, an FMA counted as one) take
// at 33 T op/s; the table (7.7 MB for 96k triangles, 18 MB for 200k) and
// the nodes (1 MB, 2.2 MB) stay in the 50 MB L2.  What holds the kernel far
// from that bound is the number of dependent node and slot reads per lane
// and the divergence between the lanes of a warp.  A walk of the chunks in
// id order slab-tests every chunk box per lane (about 1,900 on doom) and
// every slot of a chunk it enters (64 or 160); the hierarchy brings that to
// the boxes along the lane's own front-to-back path (tens) and the slots of
// the rows it enters (at most 8 each, stopping at the first empty one), and
// prunes every box beyond the current best.
//
// Left out by design: tensor cores and TMA (a divergent per-lane walk has
// no matrix product and no tile to copy), lane sorting before launch (more
// eager kernels on a path bound by host dispatch), shared-memory staging of
// the top levels.  IEEE division and -fmad=false: no FMA beyond those of the
// row test, so the results equal the plain PyTorch versions (brute force in
// table order) bit for bit.

#include <cuda_runtime.h>

#include "row_tests.cuh"

namespace {

using paths_rt::kBig;
using paths_rt::kDead;
using paths_rt::kRowFloats;
using paths_rt::tri_slot;

constexpr int kThreads = 256;
constexpr int kSlotsPerRow = 8;  // of 16 floats: four float4 per slot
constexpr int kStack = 64;       // walk stack entries (inner levels of the tree)

struct Hit {
  float t;
  int gid;
  int ent;
};

// The slab test of row_tests.cuh::crosses_padded_box on a node's padded
// box (a = [lo.xyz ref], b = [hi.xyz aux]), returning the entry distance
// and keeping a box entered at exactly t_best.  An axis whose slab distance
// is NaN (d == 0 with the origin on a plane of the box) does not constrain.
__device__ __forceinline__ bool enters(const float4 a, const float4 b,
                                       const float o[3], const float inv[3],
                                       float t_best, float& t_entry) {
  const float lo[3] = {a.x, a.y, a.z};
  const float hi[3] = {b.x, b.y, b.z};
  float tmin = -kBig;
  float tmax = kBig;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float t0 = (lo[ax] - o[ax]) * inv[ax];
    const float t1 = (hi[ax] - o[ax]) * inv[ax];
    if (isnan(t0) || isnan(t1)) continue;
    tmin = fmaxf(tmin, fminf(t0, t1));
    tmax = fminf(tmax, fmaxf(t0, t1));
  }
  t_entry = tmin;
  return tmin < tmax && tmin <= t_best && tmax > 0.0f;
}

template <bool AnyHit>
__device__ __forceinline__ Hit walk(const float4* __restrict__ nodes,
                                    const float* __restrict__ tris,
                                    const float* __restrict__ meta,
                                    const float o[3], const float d[3],
                                    int excl, int excl_ent, float t_seed) {
  Hit h{t_seed, 0, 0};
  if (o[0] > kDead || (AnyHit && t_seed == 0.0f)) return h;
  const float inv[3] = {1.0f / d[0], 1.0f / d[1], 1.0f / d[2]};
  float t_entry;
  const float4 ra = __ldg(nodes);
  const float4 rb = __ldg(nodes + 1);
  if (!enters(ra, rb, o, inv, h.t, t_entry)) return h;
  int ref = static_cast<int>(ra.w);  // the current node, its box entered
  int aux = static_cast<int>(rb.w);
  int pos_best = -1;
  int stack_ref[kStack];
  int stack_aux[kStack];
  float stack_t[kStack];
  int sp = 0;
  while (true) {
    if (ref >= 0) {  // inner node: both children against t_best
      const float4 la = __ldg(nodes + 2 * ref);
      const float4 lb = __ldg(nodes + 2 * ref + 1);
      const float4 ka = __ldg(nodes + 2 * aux);
      const float4 kb = __ldg(nodes + 2 * aux + 1);
      float tl;
      float tr;
      const bool hl = enters(la, lb, o, inv, h.t, tl);
      const bool hr = enters(ka, kb, o, inv, h.t, tr);
      if (hl && hr) {
        const bool right_first = tr < tl;
        stack_ref[sp] = static_cast<int>(right_first ? la.w : ka.w);
        stack_aux[sp] = static_cast<int>(right_first ? lb.w : kb.w);
        stack_t[sp] = right_first ? tl : tr;
        ++sp;
        ref = static_cast<int>(right_first ? ka.w : la.w);
        aux = static_cast<int>(right_first ? kb.w : lb.w);
        continue;
      }
      if (hl || hr) {
        ref = static_cast<int>(hl ? la.w : ka.w);
        aux = static_cast<int>(hl ? lb.w : kb.w);
        continue;
      }
    } else {  // leaf: one row of the table, recentred on its chunk
      const int r = -1 - ref;
      const float4* m = reinterpret_cast<const float4*>(
          meta + static_cast<size_t>(aux) * kRowFloats);
      const float4 m0 = __ldg(m);      // lo.xyz, hi.x
      const float4 m1 = __ldg(m + 1);  // hi.yz, row0, nrows
      const float os[3] = {o[0] - 0.5f * (m0.x + m0.w), o[1] - 0.5f * (m0.y + m1.x),
                           o[2] - 0.5f * (m0.z + m1.y)};
      const float4* row =
          reinterpret_cast<const float4*>(tris + static_cast<size_t>(r) * kRowFloats);
#pragma unroll 2
      for (int k = 0; k < kSlotsPerRow; ++k) {
        const float4 g = __ldg(row + 4 * k + 3);  // gid, 0, ent, 0
        const int gid = static_cast<int>(g.x);
        if (gid < 0) break;  // a leaf's triangles fill its first slots
        const float4 a = __ldg(row + 4 * k);      // n.xyz, dd
        const float4 b = __ldg(row + 4 * k + 1);  // g1.xyz, c1
        const float4 e = __ldg(row + 4 * k + 2);  // g2.xyz, c2
        float t;
        const bool met = tri_slot(a, b, e, os, d, t) && gid != excl;
        if constexpr (AnyHit) {
          if (met && t < h.t && static_cast<int>(g.z) != excl_ent) {
            h.t = 0.0f;
            return h;
          }
        } else {
          const int pos = r * kSlotsPerRow + k;
          if (met && (t < h.t || (t == h.t && pos < pos_best))) {
            h.t = t;
            h.gid = gid;
            h.ent = static_cast<int>(g.z);
            pos_best = pos;
          }
        }
      }
    }
    // Pop the nearest pending subtree that can still hold the answer.
    while (sp > 0 && stack_t[sp - 1] > h.t) --sp;
    if (sp == 0) break;
    --sp;
    ref = stack_ref[sp];
    aux = stack_aux[sp];
  }
  return h;
}

// One thread per ray.  The closest-hit form (AnyHit = false) writes t, gid
// and ent; the any-hit form writes the occluded flag.
template <bool AnyHit>
__global__ void __launch_bounds__(kThreads)
    tri_traverse(const float* __restrict__ tris,
                 const float* __restrict__ meta,
                 const float4* __restrict__ nodes,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const int* __restrict__ excl,
                 const int* __restrict__ excl_ent,
                 const float* __restrict__ t_seed, int n,
                 float* __restrict__ t_out, int* __restrict__ gid_out,
                 int* __restrict__ ent_out,
                 unsigned char* __restrict__ occluded) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const float ro[3] = {o[3 * lane], o[3 * lane + 1], o[3 * lane + 2]};
  const float rd[3] = {d[3 * lane], d[3 * lane + 1], d[3 * lane + 2]};
  const float t0 = t_seed[lane];
  const Hit h = walk<AnyHit>(nodes, tris, meta, ro, rd, excl[lane],
                             AnyHit ? excl_ent[lane] : 0, t0);
  if constexpr (AnyHit) {
    occluded[lane] = h.t == 0.0f ? 1 : 0;
  } else {
    t_out[lane] = h.t < t0 ? h.t : kBig;
    gid_out[lane] = h.gid;
    ent_out[lane] = h.ent;
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Launchers with a plain C interface (bound with ctypes).  They launch on the
// given stream, do not synchronise, and return the launch's cudaError_t.
extern "C" int tri_closest_hit(const float* tris, const float* meta,
                               const float* nodes, const float* o,
                               const float* d, const int* excl,
                               const float* t_init, int n, float* t_out,
                               int* gid_out, int* ent_out, void* stream) {
  tri_traverse<false><<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      tris, meta, reinterpret_cast<const float4*>(nodes), o, d, excl, nullptr,
      t_init, n, t_out, gid_out, ent_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tri_any_hit(const float* tris, const float* meta,
                           const float* nodes, const float* o, const float* d,
                           const int* excl, const int* excl_ent,
                           const float* t_max, int n, unsigned char* occluded,
                           void* stream) {
  tri_traverse<true><<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      tris, meta, reinterpret_cast<const float4*>(nodes), o, d, excl, excl_ent,
      t_max, n, nullptr, nullptr, nullptr, occluded);
  return static_cast<int>(cudaGetLastError());
}
