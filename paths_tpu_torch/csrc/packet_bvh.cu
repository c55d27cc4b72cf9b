// Skip-link BVH closest-hit kernel for Hopper (sm_90a), K6: a front-to-back
// stack walk of the BVH with explicit children.
//
// Replaces paths_tpu/ops/pallas_traverse.py::_kernel (launched by
// ::_launch_chunked from ::closest_hit_packet), the packet walk of the
// skip-link BVH that paths_tpu/bvh/build.py builds, with the vertex-layout
// row test ::_tri_row_test (row_tests.cuh::tri_vertex_slot).  The contract
// ported is that kernel's outputs lane by lane, not its TPU schedule: the
// (8,128) ray blocks, the one scalar cursor shared by 1,024 lanes, the whole
// tree copied into VMEM and the morton/octant lane sort (_coherence_perm)
// are not carried over, and neither is the skip-link order of the walk.
//
// Layout (built by ops/packet_traverse.py::pack_bvh):
//   tree (M, 8) f32, two float4 per node in preorder (root 0): [lo.xyz ref |
//     hi.xyz aux], the BVH's binary tree with explicit children (an inner
//     node's ref the next node, aux the left child's miss link); a leaf has
//     ref = -1 - leaf row and aux = its triangle count.  A leaf's box is its
//     triangles' f32 box padded by row_tests.cuh's kBoxPad rule, an inner
//     node's the union of its children's.  It is the tree of the triangle
//     kernels' table (csrc/tri_traverse.cu) with another aux.
//   tris (R, 128) f32, one leaf per row: 8 slots of [v0.xyz v1.xyz v2.xyz
//     n.xyz gid inv_area ent n.v0]; a leaf's triangles fill its first
//     `count` slots.
//
// The function: the lexicographic minimum of (t, table position leaf row *
// 8 + slot) over the slots whose row test passes with t < t_init, gid !=
// excl and gid >= 0 -- t, gid and ent of that slot, or t = BIG and gid =
// ent = 0 when there is none; a lane with o.x > 1e29 is dead, a miss.
// Leaves are numbered in preorder (pack_bvh checks that their triangle
// ranges ascend), so this is the first slot in preorder among the nearest,
// what the reference's skip-link walk with its strict t < t_best returns
// and what the plain version (ops/packet_traverse.py, the skip-link walk)
// computes.
//
// The walk, one thread per lane, is csrc/walk.cuh's (shared with K1, K3 and
// K4): front to back with a 64-entry stack, pruning every box beyond the
// running best, the (t, position) tie rule; pack_bvh refuses a tree deeper
// than the stack.  Against the skip-link walk in preorder it descends into
// the nearer child first and skips the far leaves that a nearer hit prunes.
// The leaf test: the row's `count` slots in order, with the row test's
// fused multiply-adds exactly as the reference kernel's CPU compilation
// contracts them (row_tests.cuh::tri_vertex_slot).
//
// What bounds it on this card: bytes -- the needed leaves' triangles (64 B a
// slot) and the nodes a lane enters, read once, take longer at 3.35 TB/s
// than their operations (53 FP32 a slot) at 33 T op/s; tree (32 B a node)
// and rows (512 B a leaf) of a 200k-triangle mesh, about 20 MB, stay in the
// 50 MB L2.  What holds the kernel from that bound is the chain of
// dependent node and slot reads per lane and the divergence between the
// lanes of a warp.  Left out by design, as for K3: tensor cores and TMA,
// lane sorting, shared-memory staging of the top levels.  IEEE division and
// -fmad=false: no FMA beyond those of the row test, so the results equal
// the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

#include "row_tests.cuh"
#include "walk.cuh"

namespace {

using paths_rt::Best;
using paths_rt::kBig;
using paths_rt::kRowFloats;
using paths_rt::tri_vertex_slot;

constexpr int kThreads = 256;
constexpr int kSlotsPerRow = 8;  // of 16 floats: four float4 per slot

// The leaf test: a leaf row (ref = -1 - row) and its `count` (aux) slots.
struct VertexRowLeaf {
  const float* tris;
  float o[3];
  float d[3];
  int excl;

  __device__ __forceinline__ bool operator()(int ref, int count, Best& best) const {
    const int r = -1 - ref;
    const float4* row =
        reinterpret_cast<const float4*>(tris + static_cast<size_t>(r) * kRowFloats);
    for (int k = 0; k < count; ++k) {
      const float4 s0 = __ldg(row + 4 * k);      // v0.xyz, v1.x
      const float4 s1 = __ldg(row + 4 * k + 1);  // v1.yz, v2.xy
      const float4 s2 = __ldg(row + 4 * k + 2);  // v2.z, n.xyz
      const float4 s3 = __ldg(row + 4 * k + 3);  // gid, inv_area, ent, n.v0
      float t;
      const bool met = tri_vertex_slot(s0, s1, s2, s3, o, d, t);
      const int gid = static_cast<int>(s3.x);
      if (met && gid != excl && gid >= 0) {
        best.offer(t, r * kSlotsPerRow + k, gid, static_cast<int>(s3.z));
      }
    }
    return false;
  }
};

__global__ void __launch_bounds__(kThreads)
    packet_walk(const float4* __restrict__ tree,
                const float* __restrict__ tris, const float* __restrict__ o,
                const float* __restrict__ d, const int* __restrict__ excl,
                const float* __restrict__ t_init, int n,
                float* __restrict__ t_out, int* __restrict__ gid_out,
                int* __restrict__ ent_out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const float ro[3] = {o[3 * lane], o[3 * lane + 1], o[3 * lane + 2]};
  const float rd[3] = {d[3 * lane], d[3 * lane + 1], d[3 * lane + 2]};
  const float t0 = t_init[lane];
  const VertexRowLeaf leaf{tris, {ro[0], ro[1], ro[2]}, {rd[0], rd[1], rd[2]},
                           excl[lane]};
  const Best h = paths_rt::walk<false>(tree, ro, rd, t0, leaf);
  t_out[lane] = h.t < t0 ? h.t : kBig;
  gid_out[lane] = h.gid;
  ent_out[lane] = h.ent;
}

}  // namespace

// Launcher with a plain C interface (bound with ctypes).  It launches on the
// given stream, does not synchronise, and returns the launch's cudaError_t.
extern "C" int packet_closest_hit(const float* tree, const float* tris,
                                  const float* o, const float* d,
                                  const int* excl, const float* t_init, int n,
                                  float* t_out, int* gid_out, int* ent_out,
                                  void* stream) {
  packet_walk<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tree), tris, o, d, excl, t_init, n,
      t_out, gid_out, ent_out);
  return static_cast<int>(cudaGetLastError());
}
