// Skip-link BVH closest-hit kernel for Hopper (sm_90a), K6.
//
// Replaces paths_tpu/ops/pallas_traverse.py::_kernel (launched by
// ::_launch_chunked from ::closest_hit_packet), the packet walk of the
// skip-link BVH that paths_tpu/bvh/build.py builds, with the vertex-layout
// row test ::_tri_row_test (row_tests.cuh::tri_vertex_slot).  The contract
// ported is that kernel's outputs lane by lane, not its TPU schedule: the
// (8,128) ray blocks, the one scalar cursor shared by 1,024 lanes, the whole
// tree copied into VMEM and the morton/octant lane sort (_coherence_perm)
// are not carried over.
//
// Layout (built by ops/packet_traverse.py::pack_bvh):
//   walk (M, 12) f32, one node per row in preorder: [lo.xyz hit_link |
//     hi.xyz miss_link | leaf_row count 0 0], the box padded by a relative
//     1e-4 at pack time (ops/packet_traverse.py::walk_nodes); links, rows
//     and counts as f32 (exact below 2^24).  It is the compact copy of the
//     reference's (M, 128) node table, which uses 10 floats a row.
//   tris (R, 128) f32, one leaf per row: 8 slots of [v0.xyz v1.xyz v2.xyz
//     n.xyz gid inv_area ent n.v0]; empty slots are never hit.
//
// Per lane: cursor = 0; while cursor >= 0, slab-test the node's padded box
// against t_best (crosses_padded_box); if it passes and the node is a leaf,
// test its `count` slots in order, a slot qualifying iff the row test
// passes && t < t_best && gid != excl && gid >= 0 (strict: the first slot in
// preorder wins a tie); cursor = passed ? hit_link : miss_link.  The padding
// makes this walk equal brute force over all triangles with the same row
// test.  A lane with o.x > 1e29 is dead: a miss.  Writes t_best < t_init ?
// t_best : BIG, and gid/ent (0 on a miss).
//
// What bounds it on this card: FP32 issue on the row tests (53 operations
// a (ray, triangle) pair, an FMA counted as one) and the latency
// of the dependent node reads; the compact nodes (48 B each) and the leaf
// rows (512 B each) of a 200k-triangle mesh, about 20 MB, stay in L2.
//
// What this design does about it (simple and right first): one thread per
// ray, 256 threads per block, each walking the tree alone.  Node and slot
// reads are float4 loads through the read-only path (__ldg); a leaf is
// tested only when the lane's own slab test passes, and only its occupied
// slots.  Divergence between the lanes of a warp is left as it falls: a
// later change may sort lanes or share work across a warp.  IEEE division
// and -fmad=false: no FMA beyond those of the row test, so the results
// equal the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

#include "row_tests.cuh"

namespace {

using paths_rt::crosses_padded_box;
using paths_rt::kBig;
using paths_rt::kDead;
using paths_rt::kRowFloats;
using paths_rt::tri_vertex_slot;

constexpr int kThreads = 256;
constexpr int kWalkFloat4 = 3;  // float4 per compact node row

__global__ void __launch_bounds__(kThreads)
    packet_walk(const float4* __restrict__ walk,
                const float* __restrict__ tris, const float* __restrict__ o,
                const float* __restrict__ d, const int* __restrict__ excl,
                const float* __restrict__ t_init, int n,
                float* __restrict__ t_out, int* __restrict__ gid_out,
                int* __restrict__ ent_out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const float ro[3] = {o[3 * lane], o[3 * lane + 1], o[3 * lane + 2]};
  const float rd[3] = {d[3 * lane], d[3 * lane + 1], d[3 * lane + 2]};
  const int ex = excl[lane];
  const float t0 = t_init[lane];
  float t_best = t0;
  int gid_best = 0;
  int ent_best = 0;
  if (!(ro[0] > kDead)) {
    const float inv[3] = {1.0f / rd[0], 1.0f / rd[1], 1.0f / rd[2]};
    int cursor = 0;
    while (cursor >= 0) {
      const float4* node = walk + static_cast<size_t>(cursor) * kWalkFloat4;
      const float4 a = __ldg(node);      // lo.xyz, hit_link
      const float4 b = __ldg(node + 1);  // hi.xyz, miss_link
      const float lo[3] = {a.x, a.y, a.z};
      const float hi[3] = {b.x, b.y, b.z};
      const bool hit = crosses_padded_box(lo, hi, ro, inv, t_best);
      if (hit) {
        const float4 c = __ldg(node + 2);  // leaf_row, count, 0, 0
        const int count = static_cast<int>(c.y);
        const float4* row = reinterpret_cast<const float4*>(
            tris + static_cast<size_t>(c.x) * kRowFloats);
        for (int k = 0; k < count; ++k) {
          const float4 s0 = __ldg(row + 4 * k);      // v0.xyz, v1.x
          const float4 s1 = __ldg(row + 4 * k + 1);  // v1.yz, v2.xy
          const float4 s2 = __ldg(row + 4 * k + 2);  // v2.z, n.xyz
          const float4 s3 = __ldg(row + 4 * k + 3);  // gid, inv_area, ent, n.v0
          float t;
          const bool met = tri_vertex_slot(s0, s1, s2, s3, ro, rd, t);
          const int gid = static_cast<int>(s3.x);
          if (met && t < t_best && gid != ex && gid >= 0) {
            t_best = t;
            gid_best = gid;
            ent_best = static_cast<int>(s3.z);
          }
        }
      }
      cursor = static_cast<int>(hit ? a.w : b.w);
    }
  }
  t_out[lane] = t_best < t0 ? t_best : kBig;
  gid_out[lane] = gid_best;
  ent_out[lane] = ent_best;
}

}  // namespace

// Launcher with a plain C interface (bound with ctypes).  It launches on the
// given stream, does not synchronise, and returns the launch's cudaError_t.
extern "C" int packet_closest_hit(const float* walk, const float* tris,
                                  const float* o, const float* d,
                                  const int* excl, const float* t_init, int n,
                                  float* t_out, int* gid_out, int* ent_out,
                                  void* stream) {
  packet_walk<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(walk), tris, o, d, excl, t_init, n,
      t_out, gid_out, ent_out);
  return static_cast<int>(cudaGetLastError());
}
