// Flat sphere kernels for Hopper (sm_90a), K5: closest-hit and any-hit by
// brute force over every slot of a small packed sphere table (at most 64
// rows = 1,024 slots), with no chunk meta and no cull.
//
// Replaces paths_tpu/ops/pallas_traverse.py::_make_flat_sphere_kernel
// (launched by ::_launch_flat_spheres), the render path's sphere route when
// PATHS_TPU_SPH_FLAT=1 and the table has at most SPH_FLAT_MAX_ROWS rows.  It
// computes K1's and K2's function (csrc/sphere_traverse.cu): the same row
// test (row_tests.cuh::sphere_slot, the reference's _sphere_row_test), every
// slot in table order, pad rows included (their canonical empty fill,
// r^2 = -1 and gid = -1, never qualifies).
//
// Per slot (strict comparisons; the first qualifying slot in table order
// wins a tie): qualifies iff the sphere is met ahead && t < t_best &&
// gid != excl && gid >= 0 (any-hit adds ent != excl_ent).  A lane with
// o.x > 1e29 is dead: a miss / not occluded (the reference's dead lanes miss
// through NaN arithmetic; the plain version tests o.x, and so does this).
// Closest-hit writes t_best < t_seed ? t_best : BIG, and gid/ent (0 on a
// miss).  Any-hit collapses t_best to 0 on the first qualifying slot and
// reports t_best == 0, so a lane seeded with t_max == 0 reports occluded, as
// the reference kernel does.
//
// What bounds it on this card: FP32 issue.  Each (ray, slot) pair is about
// 25 FP32 operations against about 36 bytes of ray input and output per
// lane, and with no cull every lane tests every slot: at stress-500 (32
// rows, 512 slots) a 345,600-lane frame is 177 M pairs, about 4.4 GFLOP.
//
// What this design does about it (simple and right first): one thread per
// ray, 256 threads per block.  Each block stages the whole table (at most
// 32 KB) in shared memory once; every lane of a warp then reads the same
// slot at the same time, a broadcast from shared memory with no bank
// conflict.  Any-hit returns at the first qualifying slot.  Built with
// -fmad=false: no FMA beyond the three of the row test.

#include <cuda_runtime.h>

#include "row_tests.cuh"

namespace {

using paths_rt::kBig;
using paths_rt::kDead;
using paths_rt::kRowFloats;
using paths_rt::sphere_slot;

constexpr int kThreads = 256;
constexpr int kSlotsPerRow = 16;  // of 8 floats: two float4 per slot
constexpr int kMaxRows = 64;      // ops/chunk_scan.py SPH_FLAT_MAX_ROWS

// One thread per ray.  The closest-hit form (AnyHit = false) writes t, gid
// and ent; the any-hit form writes the occluded flag.
template <bool AnyHit>
__global__ void __launch_bounds__(kThreads)
    flat_spheres(const float* __restrict__ table, int n_rows,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const int* __restrict__ excl,
                 const int* __restrict__ excl_ent,
                 const float* __restrict__ t_seed, int n,
                 float* __restrict__ t_out, int* __restrict__ gid_out,
                 int* __restrict__ ent_out,
                 unsigned char* __restrict__ occluded) {
  __shared__ float4 tab[kMaxRows * kRowFloats / 4];
  const int n_vec = n_rows * (kRowFloats / 4);
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    const float* src = table + 4 * i;
    tab[i] = make_float4(src[0], src[1], src[2], src[3]);
  }
  __syncthreads();

  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const float ro[3] = {o[3 * lane], o[3 * lane + 1], o[3 * lane + 2]};
  const float rd[3] = {d[3 * lane], d[3 * lane + 1], d[3 * lane + 2]};
  const int ex = excl[lane];
  const int ex_ent = AnyHit ? excl_ent[lane] : 0;
  const float t0 = t_seed[lane];
  float t_best = t0;
  int gid_best = 0;
  int ent_best = 0;
  if (!(ro[0] > kDead)) {
    const int n_slots = n_rows * kSlotsPerRow;
    for (int k = 0; k < n_slots; ++k) {
      const float4 s = tab[2 * k];      // cx cy cz r^2
      const float4 f = tab[2 * k + 1];  // gid ent 0 0
      float t;
      const bool met = sphere_slot(s.x, s.y, s.z, s.w, ro, rd, t);
      const int gid = static_cast<int>(f.x);
      const bool ok = met && t < t_best && gid != ex && gid >= 0;
      if constexpr (AnyHit) {
        if (ok && static_cast<int>(f.y) != ex_ent) {
          t_best = 0.0f;
          break;
        }
      } else if (ok) {
        t_best = t;
        gid_best = gid;
        ent_best = static_cast<int>(f.y);
      }
    }
  }
  if constexpr (AnyHit) {
    occluded[lane] = t_best == 0.0f ? 1 : 0;
  } else {
    t_out[lane] = t_best < t0 ? t_best : kBig;
    gid_out[lane] = gid_best;
    ent_out[lane] = ent_best;
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Launchers with a plain C interface (bound with ctypes).  They launch on the
// given stream, do not synchronise, and return the launch's cudaError_t
// (cudaErrorInvalidValue, without launching, for a table of more than 64
// rows).
extern "C" int flat_sphere_closest_hit(const float* table, int n_rows,
                                       const float* o, const float* d,
                                       const int* excl, const float* t_init,
                                       int n, float* t_out, int* gid_out,
                                       int* ent_out, void* stream) {
  if (n_rows < 0 || n_rows > kMaxRows) return cudaErrorInvalidValue;
  flat_spheres<false><<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, n_rows, o, d, excl, nullptr, t_init, n, t_out, gid_out, ent_out,
      nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flat_sphere_any_hit(const float* table, int n_rows,
                                   const float* o, const float* d,
                                   const int* excl, const int* excl_ent,
                                   const float* t_max, int n,
                                   unsigned char* occluded, void* stream) {
  if (n_rows < 0 || n_rows > kMaxRows) return cudaErrorInvalidValue;
  flat_spheres<true><<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      table, n_rows, o, d, excl, excl_ent, t_max, n, nullptr, nullptr,
      nullptr, occluded);
  return static_cast<int>(cudaGetLastError());
}
