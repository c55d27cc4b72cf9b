// Sphere traversal kernels for Hopper (sm_90a): closest-hit (K1) and any-hit
// (K2) over the packed small-sphere table.
//
// Replaces paths_tpu/ops/sorted_traverse.py::_make_sorted_kernel in its two
// sphere forms (closest_hit_spheres_sorted, occludes_spheres_sorted), whose
// per-slot arithmetic is paths_tpu/ops/pallas_traverse.py::_sphere_row_test.
// The contract ported is that kernel's outputs, not its TPU schedule (lane
// sort, block cull, front-to-back chunk order, sub-block gating): lane order
// and chunk order do not change a lane's result.
//
// Layout (built by ops/sphere_traverse.py::pack_spheres_chunked):
//   table (R, 128) f32: 16 slots per row, slot = [cx cy cz r^2 gid ent 0 0];
//     an empty slot has r^2 = -1 and gid = -1.
//   meta (C, 128) f32 per chunk: [lo.xyz hi.xyz row0 nrows] (sphere AABB).
//
// Per slot (strict comparisons; the first qualifying slot in visit order wins
// a tie): the sphere test of row_tests.cuh::sphere_slot, with the three fused
// multiply-adds the reference kernel gets when XLA compiles it for the CPU;
// qualifies iff the sphere is met ahead && t < t_best && gid != excl &&
// gid >= 0 (any-hit adds ent != excl_ent).
// A lane with o.x > 1e29 is dead: a miss / not occluded.
// Closest-hit writes t_best < t_init ? t_best : BIG, and gid/ent (0 on a miss).
// Any-hit collapses t_best to 0 on the first qualifying slot and reports
// t_best == 0, so a lane seeded with t_max == 0 reports occluded, exactly as
// the reference kernel does.
//
// What bounds it on this card: FP32 issue.  Each (ray, slot) pair is about 25
// FP32 operations (built with -fmad=false: no FMA beyond the three above),
// against about 36 bytes
// of ray input and output per lane; the table (16 KB for 500 spheres) and the
// chunk meta stay in L1/L2.  At stress-500 a full frame is 345,600 lanes x 512
// slots, about 4.4 GFLOP, against 12 MB of ray traffic.
//
// What this design does about it (simple and right first): one thread per
// ray, 256 threads per block.  Every lane of a warp reads the same slot at
// the same time, so table and meta reads are broadcasts from L1.  Each lane
// walks the chunks in id order and skips a chunk whose AABB its ray does not
// cross before t_best -- the precise per-lane slab test of
// sorted_traverse.py:518-525, on a box padded by a relative 1e-4 so that f32
// rounding of the box can only keep a chunk, never drop one.  Any-hit returns
// at the first qualifying slot.  IEEE sqrtf and division, and -fmad=false so
// nvcc contracts nothing else: the results equal the plain PyTorch version bit
// for bit.  Staging the table in
// shared memory, warp-cooperative culls and front-to-back chunk order are
// left for a later change.

#include <cuda_runtime.h>

#include "row_tests.cuh"

namespace {

using paths_rt::crosses_box;
using paths_rt::kBig;
using paths_rt::kDead;
using paths_rt::kRowFloats;
using paths_rt::sphere_slot;

constexpr int kThreads = 256;
constexpr int kSlotsPerRow = 16;
constexpr int kSlotStride = 8;

struct Hit {
  float t;
  int gid;
  int ent;
};

template <bool AnyHit>
__device__ __forceinline__ Hit walk(const float* __restrict__ table,
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
    const int row0 = static_cast<int>(m[6]);
    const int row1 = row0 + static_cast<int>(m[7]);
    for (int r = row0; r < row1; ++r) {
      const float* row = table + static_cast<size_t>(r) * kRowFloats;
#pragma unroll
      for (int k = 0; k < kSlotsPerRow; ++k) {
        const float* s = row + k * kSlotStride;
        float t;
        const bool met = sphere_slot(s[0], s[1], s[2], s[3], o, d, t);
        const int gid = static_cast<int>(s[4]);
        const bool ok = met && t < h.t && gid != excl && gid >= 0;
        if constexpr (AnyHit) {
          if (ok && static_cast<int>(s[5]) != excl_ent) {
            h.t = 0.0f;
            return h;
          }
        } else if (ok) {
          h.t = t;
          h.gid = gid;
          h.ent = static_cast<int>(s[5]);
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
    sphere_traverse(const float* __restrict__ table,
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
  const Hit h = walk<AnyHit>(table, meta, n_chunks, ro, rd, excl[lane],
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
extern "C" int sphere_closest_hit(const float* table, const float* meta,
                                  int n_chunks, const float* o, const float* d,
                                  const int* excl, const float* t_init, int n,
                                  float* t_out, int* gid_out, int* ent_out,
                                  void* stream) {
  sphere_traverse<false><<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      table, meta, n_chunks, o, d, excl, nullptr, t_init, n, t_out, gid_out,
      ent_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sphere_any_hit(const float* table, const float* meta,
                              int n_chunks, const float* o, const float* d,
                              const int* excl, const int* excl_ent,
                              const float* t_max, int n,
                              unsigned char* occluded, void* stream) {
  sphere_traverse<true><<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      table, meta, n_chunks, o, d, excl, excl_ent, t_max, n, nullptr, nullptr,
      nullptr, occluded);
  return static_cast<int>(cudaGetLastError());
}
