// Triangle traversal kernels for Hopper (sm_90a): closest-hit (K3) and
// any-hit (K4) over the packed plane-form triangle table.
//
// Replaces paths_tpu/ops/sorted_traverse.py::_make_sorted_kernel in its two
// triangle forms (closest_hit_sorted, occludes_sorted), whose per-slot
// arithmetic is paths_tpu/ops/pallas_traverse.py::_tri_row_test_v2 on the
// origin recentred by _chunk_shift.  The contract ported is that kernel's
// outputs, not its TPU schedule (lane sort, block cull, front-to-back chunk
// order, DMA ring, replicated table, sub-block gating, root-box lane cull):
// none of those changes a lane's result.
//
// Layout (built by ops/tri_traverse.py::pack_chunked):
//   tris (R, 128) f32: 8 slots per row, slot = [n.xyz dd g1.xyz c1 g2.xyz c2
//     gid 0 ent 0], plane constants relative to the slot's chunk centre
//     c = 0.5 * (lo + hi); an empty or degenerate slot has c1 = c2 = -BIG.
//   meta (C, 128) f32 per chunk: [lo.xyz hi.xyz row0 nrows ...] (the chunk's
//     triangle box; 8 or 20 rows per chunk).
//
// Per slot, with o' = o - 0.5f * (lo + hi) (f32, as the pack-time centre):
// the plane-form test of row_tests.cuh::tri_slot, with the fourteen fused
// multiply-adds the reference kernel gets when XLA compiles it for the CPU;
// qualifies iff it passes && t < t_best && gid != excl (any-hit adds
// ent != excl_ent).  Strict comparisons: the first qualifying slot
// in table order wins a tie.  A lane with o.x > 1e29 is dead: a miss / not
// occluded.  Closest-hit writes t_best < t_init ? t_best : BIG, and gid/ent
// (0 on a miss).  Any-hit collapses t_best to 0 on the first qualifying slot
// and reports t_best == 0, so a lane seeded with t_max == 0 reports occluded,
// exactly as the reference kernel does.
//
// What bounds it on this card: FP32 issue.  Each (ray, slot) pair is 32 FP32
// operations, an FMA counted as one (built with -fmad=false: no FMA beyond
// the fourteen above), against about 36 bytes of ray input and output per
// lane; the table (7.7 MB for 96k triangles, 18 MB for 200k) and the chunk
// meta stay in L2.
//
// What this design does about it (simple and right first): one thread per
// ray, 256 threads per block.  Every lane of a warp reads the same slot at
// the same time, so table and meta reads are broadcasts (four float4 loads
// per slot).  Each lane walks the chunks in id order (the BVH's spatial
// order) and skips a chunk whose box its ray does not cross before t_best --
// the per-lane slab test of sorted_traverse.py:518-525 on a box padded by a
// relative 1e-4, so that f32 rounding of the box can only keep a chunk, never
// drop one.  Any-hit returns at the first qualifying slot.  IEEE division and
// -fmad=false: the results equal the plain PyTorch version bit for bit.
// Front-to-back chunk order, per-row box gates, shared-memory staging and
// warp-cooperative culls are left for a later change.

#include <cuda_runtime.h>

#include "row_tests.cuh"

namespace {

using paths_rt::crosses_box;
using paths_rt::kBig;
using paths_rt::kDead;
using paths_rt::kRowFloats;
using paths_rt::tri_slot;

constexpr int kThreads = 256;
constexpr int kSlotsPerRow = 8;  // of 16 floats: four float4 per slot

struct Hit {
  float t;
  int gid;
  int ent;
};

template <bool AnyHit>
__device__ __forceinline__ Hit walk(const float* __restrict__ tris,
                                    const float* __restrict__ meta,
                                    int n_chunks, const float o[3],
                                    const float d[3], int excl, int excl_ent,
                                    float t_seed) {
  Hit h{t_seed, 0, 0};
  if (o[0] > kDead) return h;
  const float inv[3] = {1.0f / d[0], 1.0f / d[1], 1.0f / d[2]};
  for (int c = 0; c < n_chunks; ++c) {
    const float* m = meta + static_cast<size_t>(c) * kRowFloats;
    if (!crosses_box(m, o, inv, h.t)) continue;
    const float os[3] = {o[0] - 0.5f * (m[0] + m[3]), o[1] - 0.5f * (m[1] + m[4]),
                         o[2] - 0.5f * (m[2] + m[5])};
    const int row0 = static_cast<int>(m[6]);
    const int row1 = row0 + static_cast<int>(m[7]);
    for (int r = row0; r < row1; ++r) {
      const float4* row =
          reinterpret_cast<const float4*>(tris + static_cast<size_t>(r) * kRowFloats);
#pragma unroll 2
      for (int k = 0; k < kSlotsPerRow; ++k) {
        const float4 a = __ldg(row + 4 * k);      // n.xyz, dd
        const float4 b = __ldg(row + 4 * k + 1);  // g1.xyz, c1
        const float4 e = __ldg(row + 4 * k + 2);  // g2.xyz, c2
        const float4 g = __ldg(row + 4 * k + 3);  // gid, 0, ent, 0
        float t;
        const bool met = tri_slot(a, b, e, os, d, t);
        const int gid = static_cast<int>(g.x);
        const bool ok = met && t < h.t && gid != excl;
        if constexpr (AnyHit) {
          if (ok && static_cast<int>(g.z) != excl_ent) {
            h.t = 0.0f;
            return h;
          }
        } else if (ok) {
          h.t = t;
          h.gid = gid;
          h.ent = static_cast<int>(g.z);
        }
      }
    }
  }
  return h;
}

// One thread per ray.  The closest-hit form (AnyHit = false) writes t, gid
// and ent; the any-hit form writes the occluded flag.
template <bool AnyHit>
__global__ void __launch_bounds__(kThreads)
    tri_traverse(const float* __restrict__ tris,
                 const float* __restrict__ meta, int n_chunks,
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
  const Hit h = walk<AnyHit>(tris, meta, n_chunks, ro, rd, excl[lane],
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
                               int n_chunks, const float* o, const float* d,
                               const int* excl, const float* t_init, int n,
                               float* t_out, int* gid_out, int* ent_out,
                               void* stream) {
  tri_traverse<false><<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      tris, meta, n_chunks, o, d, excl, nullptr, t_init, n, t_out, gid_out,
      ent_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tri_any_hit(const float* tris, const float* meta, int n_chunks,
                           const float* o, const float* d, const int* excl,
                           const int* excl_ent, const float* t_max, int n,
                           unsigned char* occluded, void* stream) {
  tri_traverse<true><<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      tris, meta, n_chunks, o, d, excl, excl_ent, t_max, n, nullptr, nullptr,
      nullptr, occluded);
  return static_cast<int>(cudaGetLastError());
}
