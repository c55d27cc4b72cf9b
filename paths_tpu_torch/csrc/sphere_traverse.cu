// Sphere traversal kernels for Hopper (sm_90a): closest-hit (K1) and
// any-hit (K2), each a walk of a tree over the table's slots: K1 front to
// back, K2 to its first occluder.
//
// Replaces paths_tpu/ops/sorted_traverse.py::_make_sorted_kernel in its two
// sphere forms (closest_hit_spheres_sorted, occludes_spheres_sorted), whose
// per-slot arithmetic is paths_tpu/ops/pallas_traverse.py::_sphere_row_test.
// The contract ported is that kernel's outputs, not its TPU schedule (lane
// sort, block cull, front-to-back chunk order, sub-block gating): lane order
// and visit order do not change a lane's result.
//
// Layout (built by ops/sphere_traverse.py::pack_spheres_chunked):
//   table (R, 128) f32: 16 slots per row, slot = [cx cy cz r^2 gid ent 0 0],
//     the spheres in morton order; an empty slot has r^2 = -1 and gid = -1.
//     Slot i sits at float 8 * i.
//   nodes (M, 8) f32, two float4 per node in preorder (root 0): [lo.xyz ref
//     | hi.xyz aux], a binary tree over contiguous ranges of the slots,
//     split at the highest differing morton bit, at most 4 slots a leaf
//     (scripts/sphere_hierarchy_shapes.py chose both); a leaf has ref = -1 -
//     its first slot and aux = its slot count, an inner node ref = left
//     child, aux = right child.  A leaf's box is its spheres' box padded by
//     row_tests.cuh's kBoxPad rule, an inner node's the union of its
//     children's.  The table's chunk meta is not read.
//
// Per slot: the sphere test of row_tests.cuh::sphere_slot, with the three
// fused multiply-adds the reference kernel gets when XLA compiles it for the
// CPU; qualifies iff the sphere is met ahead && t < t_best && gid != excl &&
// gid >= 0 (any-hit adds ent != excl_ent).  A lane with o.x > 1e29 is dead:
// a miss / not occluded.
//
// K1's answer is the lexicographic minimum of (t, slot index) over the
// slots that qualify against t_init: t_best < t_init ? t_best : BIG, and
// gid/ent of that slot (0 on a miss) -- the first slot among the nearest,
// as the plain version's first-index argmin.  K2's is whether some slot
// qualifies against t_max; it collapses t_best to 0 on the first one and
// reports t_best == 0, so a lane seeded with t_max == 0 reports occluded
// (and walks nothing), exactly as the reference kernel does, dead or not.
// Both walks are csrc/walk.cuh's (shared with K3, K4 and K6): a 64-entry
// stack, pruning every box beyond t_best (t_max for K2, which never
// shrinks it), nearer child first, the (t, position) tie rule for K1.  The
// leaf test reads its slots in order and skips the square root of a slot
// whose discriminant is negative (sphere_slot<true>): such a slot never
// qualifies, so the result is the same to the bit, and the large majority
// of (ray, sphere) pairs a lane tests are misses; the [gid ent] half of a
// slot is read only for a met sphere.
//
// What bounds them on this card: FP32 issue.  Each (ray, slot) pair is
// about 25 FP32 operations (built with -fmad=false: no FMA beyond the three
// above) against about 36 bytes of ray input and output per lane; the table
// (16 KB for 500 spheres) and nodes stay in L1/L2.  What held them from
// that bound was the work a walk of the chunks in id order does beyond it:
// on stress-500 a lane entered about 7 of its 16 chunks of 32 slots before
// its answer settled and paid a square root on every slot.  The tree
// brings that to about 43 box tests and 10 slot tests on primary rays, 26
// and 5 on incoherent ones (scripts/sphere_hierarchy_shapes.py), fewer for
// K2, which stops at its first occluder.  One thread per ray, 256 threads
// per block; IEEE sqrtf and division, and -fmad=false so nvcc contracts
// nothing else: the results equal the plain PyTorch versions bit for bit.

#include <cuda_runtime.h>

#include "row_tests.cuh"
#include "walk.cuh"

namespace {

using paths_rt::Best;
using paths_rt::kBig;
using paths_rt::sphere_slot;

constexpr int kThreads = 256;

// The leaf test: count (aux) slots from slot -1 - ref, each two float4
// ([c.xyz r^2], [gid ent 0 0]), the second read only for a met sphere.  The
// closest-hit form offers each qualifying slot to best; the any-hit form
// returns true at the first slot that qualifies against t_max (best.t).
template <bool AnyHit>
struct SlotRangeLeaf {
  const float4* table;
  float o[3];
  float d[3];
  int excl;
  int excl_ent;

  __device__ __forceinline__ bool operator()(int ref, int count, Best& best) const {
    const int first = -1 - ref;
    for (int k = 0; k < count; ++k) {
      const float4 s = __ldg(table + 2 * (first + k));  // c.xyz, r^2
      float t;
      if (!sphere_slot<true>(s.x, s.y, s.z, s.w, o, d, t)) continue;
      const float4 g = __ldg(table + 2 * (first + k) + 1);  // gid, ent, 0, 0
      const int gid = static_cast<int>(g.x);
      if (gid == excl || gid < 0) continue;
      if constexpr (AnyHit) {
        if (t < best.t && static_cast<int>(g.y) != excl_ent) return true;
      } else {
        best.offer(t, first + k, gid, static_cast<int>(g.y));
      }
    }
    return false;
  }
};

// One thread per ray.  The closest-hit form (AnyHit = false) writes t, gid
// and ent; the any-hit form writes the occluded flag.
template <bool AnyHit>
__global__ void __launch_bounds__(kThreads)
    sphere_traverse(const float4* __restrict__ table,
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
  const SlotRangeLeaf<AnyHit> leaf{table, {ro[0], ro[1], ro[2]}, {rd[0], rd[1], rd[2]},
                                   excl[lane], AnyHit ? excl_ent[lane] : 0};
  const Best h = paths_rt::walk<AnyHit>(nodes, ro, rd, t0, leaf);
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
extern "C" int sphere_closest_hit(const float* table, const float* nodes,
                                  const float* o, const float* d,
                                  const int* excl, const float* t_init, int n,
                                  float* t_out, int* gid_out, int* ent_out,
                                  void* stream) {
  sphere_traverse<false><<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), reinterpret_cast<const float4*>(nodes),
      o, d, excl, nullptr, t_init, n, t_out, gid_out, ent_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sphere_any_hit(const float* table, const float* nodes,
                              const float* o, const float* d,
                              const int* excl, const int* excl_ent,
                              const float* t_max, int n,
                              unsigned char* occluded, void* stream) {
  sphere_traverse<true><<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), reinterpret_cast<const float4*>(nodes),
      o, d, excl, excl_ent, t_max, n, nullptr, nullptr, nullptr, occluded);
  return static_cast<int>(cudaGetLastError());
}
