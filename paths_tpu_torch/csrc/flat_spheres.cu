// Flat sphere kernels for Hopper (sm_90a), K5: closest-hit and any-hit by
// brute force over every slot of a small packed sphere table (at most 64
// rows = 1,024 slots), with no chunk meta, no tree and no cull.
//
// Replaces paths_tpu/ops/pallas_traverse.py::_make_flat_sphere_kernel
// (launched by ::_launch_flat_spheres), the render path's sphere route when
// PATHS_TPU_SPH_FLAT=1 and the table has at most SPH_FLAT_MAX_ROWS rows.  It
// computes K1's and K2's function (csrc/sphere_traverse.cu): the same row
// test (row_tests.cuh::sphere_slot, the reference's _sphere_row_test), every
// slot of the table, pad rows included (their canonical empty fill,
// r^2 = -1 and gid = -1, never qualifies).
//
// Per slot: qualifies iff the sphere is met ahead && t < t_best && gid !=
// excl && gid >= 0 (any-hit adds ent != excl_ent).  A lane with o.x > 1e29
// is dead: a miss / not occluded (the reference's dead lanes miss through
// NaN arithmetic; the plain version tests o.x, and so does this).
// Closest-hit writes the lexicographic minimum of (t, slot index) over the
// qualifying slots -- t_best < t_seed ? t_best : BIG, and gid/ent of that
// slot (0 on a miss) -- the first slot among the nearest, as the plain
// version's first-index argmin.  Any-hit reports whether some slot
// qualifies against t_max, and a lane seeded with t_max == 0 reports
// occluded (the reference kernel collapses t_best to 0 at an occluder and
// reports t_best == 0).
//
// What bounds it on this card: the FP32 instruction rate.  With no cull
// every lane tests every slot: at stress-500 (32 rows, 512 slots) a
// 65,536-lane tile is 33.5 M pairs and a 345,600-lane frame 177 M.  A pair
// whose discriminant is negative -- the large majority -- is 12 FP32
// operations (3 subtractions for o - c, b's multiply and two FMAs, c2's
// multiply, two FMAs and subtraction, the discriminant's FMA, its
// comparison): the all-pairs floor, lanes x slots x 12 over the FP32 peak,
// which chip_smoke.py prints beside the function's own bound.
//
// What this design does about it: a group of G = kGroup = 8 threads shares
// one lane (of G = 1, 2, 4 and 8, 8 was the fastest on an H100 on a
// main-path tile of 65,536 lanes; PERF.md).  Thread j of a group tests slots
// j, j + G, j + 2G, ... in ascending order, keeping its best by strict
// t < t_best (the first index among its own nearest); the group then takes
// the lexicographic minimum of (t, slot index) by __shfl_xor_sync, the rule
// of walk.cuh::Best::offer, so the first slot among the nearest wins.  A
// thread tests its slots in batches of kBatch: the batch's discriminants
// first (kBatch independent chains, row_tests.cuh::sphere_disc), then, only
// if one is not negative, the square roots and the [gid ent] reads of the
// met slots (sphere_root): one branch a batch, no root for a miss.  The
// any-hit form votes across the warp after every batch; a group stops at
// the first vote that finds an occluder in it, the warp when every group
// has.  Each block stages the table in shared memory once as two arrays,
// the [c.xyz r^2] float4s and the [gid ent] int pairs, padded with empty
// slots to whole batches: the G threads of a group read G neighbouring
// 16-byte words, the lanes of a warp the same G words (a broadcast), with
// no bank conflict.  Tensor cores, TMA and clusters do not fit this
// arithmetic.  IEEE sqrtf and -fmad=false: no FMA beyond the three of the
// row test, so the results equal the plain PyTorch versions bit for bit.

#include <cuda_runtime.h>

#include "row_tests.cuh"

namespace {

using paths_rt::kBig;
using paths_rt::kDead;
using paths_rt::sphere_disc;
using paths_rt::sphere_root;

constexpr int kThreads = 256;
constexpr int kSlotsPerRow = 16;  // of 8 floats: two float4 per slot
constexpr int kMaxRows = 64;      // ops/chunk_scan.py SPH_FLAT_MAX_ROWS
constexpr int kMaxSlots = kMaxRows * kSlotsPerRow;
constexpr int kBatch = 8;         // ops/chunk_scan.py FLAT_BATCH
constexpr int kGroup = 8;         // threads a lane, ops/chunk_scan.py FLAT_GROUP
constexpr unsigned kWarp = 0xffffffffu;

// The slots of a thread's batch i: j + kGroup * (i + u), u < kBatch.  Tests their
// discriminants; returns whether some sphere may be met (disc >= 0; a NaN
// discriminant never qualifies, as in sphere_slot).
__device__ __forceinline__ bool batch_discs(const float4* sph, int j, int i,
                                            const float o[3], const float d[3],
                                            float b[kBatch], float disc[kBatch]) {
  bool any = false;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const float4 s = sph[j + kGroup * (i + u)];
    disc[u] = sphere_disc(s.x, s.y, s.z, s.w, o, d, b[u]);
    any |= disc[u] >= 0.0f;
  }
  return any;
}

// kGroup threads a lane.  The closest-hit form (AnyHit = false) writes t,
// gid and ent; the any-hit form writes the occluded flag.
template <bool AnyHit>
__global__ void __launch_bounds__(kThreads)
    flat_spheres(const float4* __restrict__ table, int n_rows,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const int* __restrict__ excl,
                 const int* __restrict__ excl_ent,
                 const float* __restrict__ t_seed, int n,
                 float* __restrict__ t_out, int* __restrict__ gid_out,
                 int* __restrict__ ent_out,
                 unsigned char* __restrict__ occluded) {
  // The table's slots, padded with empty ones (r^2 = -1, gid = -1: never
  // met, never qualifying) to a multiple of G x kBatch, so that every
  // thread runs whole batches.
  constexpr int G = kGroup;
  __shared__ float4 sph[kMaxSlots];  // c.xyz, r^2
  __shared__ int2 ids[kMaxSlots];    // gid, ent
  const int n_slots = n_rows * kSlotsPerRow;
  const int n_pad = (n_slots + G * kBatch - 1) / (G * kBatch) * (G * kBatch);
  for (int k = threadIdx.x; k < n_pad; k += kThreads) {
    if (k < n_slots) {
      sph[k] = __ldg(table + 2 * k);
      const float4 g = __ldg(table + 2 * k + 1);
      ids[k] = make_int2(static_cast<int>(g.x), static_cast<int>(g.y));
    } else {
      sph[k] = make_float4(0.0f, 0.0f, 0.0f, -1.0f);
      ids[k] = make_int2(-1, -1);
    }
  }
  __syncthreads();

  // A group is G neighbouring threads of one warp.  Every thread of the
  // warp stays to the end (the votes and shuffles span the warp); a thread
  // past the last lane reads lane n - 1 and writes nothing.
  const long long lane_ll =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const bool in = lane_ll < n;
  const int lane = in ? static_cast<int>(lane_ll) : n - 1;
  const int j = threadIdx.x % G;
  const float ro[3] = {o[3 * lane], o[3 * lane + 1], o[3 * lane + 2]};
  const float rd[3] = {d[3 * lane], d[3 * lane + 1], d[3 * lane + 2]};
  const int ex = excl[lane];
  const float t0 = t_seed[lane];
  const bool live = in && !(ro[0] > kDead);
  const int per = n_pad / G;  // slots per thread, a multiple of kBatch
  float b[kBatch];
  float disc[kBatch];

  if constexpr (AnyHit) {
    // The group's threads vote after every batch; the warp stops once every
    // group has its answer.
    const int ex_ent = excl_ent[lane];
    const unsigned group = ((1u << G) - 1u) << (threadIdx.x % 32 / G * G);
    bool found = false;
    bool done = !live || t0 == 0.0f;
    for (int i = 0; i < per && !__all_sync(kWarp, done); i += kBatch) {
      bool hit = false;
      if (!done && batch_discs(sph, j, i, ro, rd, b, disc)) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          float t;
          if (!(disc[u] >= 0.0f) || !sphere_root(b[u], disc[u], t) || !(t < t0)) continue;
          const int2 id = ids[j + G * (i + u)];
          hit |= id.x != ex && id.x >= 0 && id.y != ex_ent;
        }
      }
      if (__ballot_sync(kWarp, hit) & group) found = done = true;
    }
    if (in && j == 0) occluded[lane] = found || t0 == 0.0f ? 1 : 0;
  } else {
    // Each thread's best by strict t < t_best over its slots in ascending
    // order: the first index among its own nearest.
    float t_best = t0;
    int pos = -1;
    if (live) {
      for (int i = 0; i < per; i += kBatch) {
        if (!batch_discs(sph, j, i, ro, rd, b, disc)) continue;  // all missed
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          float t;
          if (!(disc[u] >= 0.0f) || !sphere_root(b[u], disc[u], t) || !(t < t_best)) continue;
          const int k = j + G * (i + u);
          const int2 id = ids[k];
          if (id.x != ex && id.x >= 0) {
            t_best = t;
            pos = k;
          }
        }
      }
    }
    // The group's answer: the least (t, slot index), as Best::offer.  A
    // thread with no hit holds (t0, -1), and every hit has t < t0.
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2) {
      const float t_o = __shfl_xor_sync(kWarp, t_best, off);
      const int pos_o = __shfl_xor_sync(kWarp, pos, off);
      if (t_o < t_best || (t_o == t_best && pos_o < pos)) {
        t_best = t_o;
        pos = pos_o;
      }
    }
    if (in && j == 0) {
      const int2 id = pos >= 0 ? ids[pos] : make_int2(0, 0);
      t_out[lane] = t_best < t0 ? t_best : kBig;
      gid_out[lane] = id.x;
      ent_out[lane] = id.y;
    }
  }
}

template <bool AnyHit>
int launch(const float* table, int n_rows, const float* o, const float* d,
           const int* excl, const int* excl_ent, const float* t_seed, int n,
           float* t_out, int* gid_out, int* ent_out, unsigned char* occluded,
           void* stream) {
  if (n_rows < 0 || n_rows > kMaxRows) return cudaErrorInvalidValue;
  constexpr long long kLanesPerBlock = kThreads / kGroup;
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(n) + kLanesPerBlock - 1) / kLanesPerBlock);
  flat_spheres<AnyHit><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), n_rows, o, d, excl, excl_ent, t_seed, n,
      t_out, gid_out, ent_out, occluded);
  return static_cast<int>(cudaGetLastError());
}

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
  return launch<false>(table, n_rows, o, d, excl, nullptr, t_init, n, t_out, gid_out,
                       ent_out, nullptr, stream);
}

extern "C" int flat_sphere_any_hit(const float* table, int n_rows,
                                   const float* o, const float* d,
                                   const int* excl, const int* excl_ent,
                                   const float* t_max, int n,
                                   unsigned char* occluded, void* stream) {
  return launch<true>(table, n_rows, o, d, excl, excl_ent, t_max, n, nullptr, nullptr,
                      nullptr, occluded, stream);
}
