// Linear chunk-scan kernels for Hopper (sm_90a): closest-hit over a plane-
// form triangle table (K7), closest-hit over a sphere table (K8), and any-hit
// over either (K9), one kernel templated on the row test and the mode.
//
// Replaces paths_tpu/ops/pallas_traverse.py::_make_chunked_kernel (K7,
// closest_hit_chunked), ::_make_chunked_sphere_kernel (K8,
// closest_hit_spheres) and ::_make_anyhit_kernel (K9, occludes_chunked and
// occludes_spheres).  Their row tests are ::_tri_row_test_v2 on the origin
// recentred by ::_chunk_shift, and ::_sphere_row_test (row_tests.cuh).  The
// contract ported is those kernels' outputs, not their TPU schedule (lane
// sort, 1,024-lane blocks): a lane's result does not depend on its block.
//
// Layout (ops/tri_traverse.py::pack_chunked, default 32 rows per chunk;
// ops/sphere_traverse.py::pack_spheres_chunked, default 16 here):
//   table (R, 128) f32: 8 triangle slots of 16 floats, or 16 sphere slots of
//     8 floats, per row (row_tests.cuh gives each slot's fields).
//   meta (C, 128) f32 per chunk: [lo.xyz hi.xyz row0 nrows ...].
//
// Per slot (strict comparisons; the first qualifying slot in table order
// wins a tie): qualifies iff the row test passes && t < t_best &&
// gid != excl (spheres also gid >= 0; any-hit adds ent != excl_ent).  A
// lane with o.x > 1e29 is dead: a miss / not occluded.  Closest-hit writes
// t_best < t_init ? t_best : BIG, and gid/ent (0 on a miss).  Any-hit
// collapses t_best to 0 on the first qualifying slot and reports
// t_best == 0, so a lane seeded with t_max == 0 reports occluded, as the
// reference kernel does.
//
// What bounds it on this card: FP32 issue.  A (ray, slot) pair costs about 25
// (sphere) or 32 (triangle) FP32 operations while a lane moves about 36
// bytes; the tables (a few MB for a mesh of 100k triangles) stay in L2.
//
// What this design does about it (simple and right first): the reference's
// linear culled-chunk scan, with the cull decided per warp rather than per
// 1,024-lane block.  One thread per ray, 256 threads per block.  Each warp
// walks the chunks in id order; each live lane slab-tests the chunk's box,
// padded by a relative 1e-4 so that the cull is conservative (tmin < tmax,
// tmin < t_best, tmax > 0), against its running best; __any_sync decides
// whether the warp tests the chunk's rows, and then all 32 lanes test every
// slot of them, each slot a broadcast read.  Testing a slot that a lane's own
// cull would skip is brute force and cannot change its result, so the
// outputs equal the plain versions' (flat brute force) bit for bit.  In
// any-hit mode a lane collapses t_best to 0 and is done; the warp leaves once
// __all_sync says every lane is done.  Built with -fmad=false: no FMA beyond
// those of the row tests.

#include <cuda_runtime.h>

#include "row_tests.cuh"

namespace {

using paths_rt::crosses_box;
using paths_rt::kBig;
using paths_rt::kDead;
using paths_rt::kRowFloats;

constexpr int kThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;

// Sphere rows: 16 slots of [cx cy cz r^2 | gid ent 0 0], the origin as is.
struct SphereRows {
  static constexpr int kSlots = 16;
  __device__ static void origin(const float* __restrict__, const float o[3],
                                float os[3]) {
    os[0] = o[0];
    os[1] = o[1];
    os[2] = o[2];
  }
  __device__ static bool slot(const float4* __restrict__ row, int k,
                              const float os[3], const float d[3], float& t,
                              int& gid, int& ent) {
    const float4 s = __ldg(row + 2 * k);
    const float4 f = __ldg(row + 2 * k + 1);
    gid = static_cast<int>(f.x);
    ent = static_cast<int>(f.y);
    return paths_rt::sphere_slot(s.x, s.y, s.z, s.w, os, d, t) && gid >= 0;
  }
};

// Plane-form triangle rows: 8 slots of [n dd | g1 c1 | g2 c2 | gid 0 ent 0],
// the origin recentred on the chunk's box centre (_chunk_shift).
struct TriRows {
  static constexpr int kSlots = 8;
  __device__ static void origin(const float* __restrict__ m, const float o[3],
                                float os[3]) {
    os[0] = o[0] - 0.5f * (m[0] + m[3]);
    os[1] = o[1] - 0.5f * (m[1] + m[4]);
    os[2] = o[2] - 0.5f * (m[2] + m[5]);
  }
  __device__ static bool slot(const float4* __restrict__ row, int k,
                              const float os[3], const float d[3], float& t,
                              int& gid, int& ent) {
    const float4 a = __ldg(row + 4 * k);
    const float4 b = __ldg(row + 4 * k + 1);
    const float4 e = __ldg(row + 4 * k + 2);
    const float4 g = __ldg(row + 4 * k + 3);
    gid = static_cast<int>(g.x);
    ent = static_cast<int>(g.z);
    return paths_rt::tri_slot(a, b, e, os, d, t);
  }
};

// One thread per ray; every thread of a warp reaches the votes, so lanes
// past n take part as finished lanes.  The closest-hit form (AnyHit = false)
// writes t, gid and ent; the any-hit form writes the occluded flag.
template <class Rows, bool AnyHit>
__global__ void __launch_bounds__(kThreads)
    chunk_scan(const float* __restrict__ table, const float* __restrict__ meta,
               int n_chunks, const float* __restrict__ o,
               const float* __restrict__ d, const int* __restrict__ excl,
               const int* __restrict__ excl_ent,
               const float* __restrict__ t_seed, int n,
               float* __restrict__ t_out, int* __restrict__ gid_out,
               int* __restrict__ ent_out,
               unsigned char* __restrict__ occluded) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = lane < n;
  float ro[3] = {0.0f, 0.0f, 0.0f};
  float rd[3] = {1.0f, 1.0f, 1.0f};
  int ex = -1;
  int ex_ent = -1;
  float t0 = 0.0f;
  if (in_range) {
    for (int ax = 0; ax < 3; ++ax) {
      ro[ax] = o[3 * lane + ax];
      rd[ax] = d[3 * lane + ax];
    }
    ex = excl[lane];
    if constexpr (AnyHit) ex_ent = excl_ent[lane];
    t0 = t_seed[lane];
  }
  float t_best = t0;
  int gid_best = 0;
  int ent_best = 0;
  // A finished lane tests nothing more: out of range, dead, or (any-hit) a
  // seed that no slot can beat (t >= 0 for every qualifying slot).
  bool done = !in_range || ro[0] > kDead || (AnyHit && !(t0 > 0.0f));
  const float inv[3] = {1.0f / rd[0], 1.0f / rd[1], 1.0f / rd[2]};

  for (int c = 0; c < n_chunks; ++c) {
    if (__all_sync(kFullWarp, done)) break;
    const float* m = meta + static_cast<size_t>(c) * kRowFloats;
    const bool want = !done && crosses_box(m, ro, inv, t_best);
    if (!__any_sync(kFullWarp, want)) continue;
    float os[3];
    Rows::origin(m, ro, os);
    const int row0 = static_cast<int>(m[6]);
    const int row1 = row0 + static_cast<int>(m[7]);
    for (int r = row0; r < row1; ++r) {
      const float4* row = reinterpret_cast<const float4*>(
          table + static_cast<size_t>(r) * kRowFloats);
#pragma unroll 4
      for (int k = 0; k < Rows::kSlots; ++k) {
        float t;
        int gid, ent;
        const bool met = Rows::slot(row, k, os, rd, t, gid, ent);
        const bool ok = !done && met && t < t_best && gid != ex;
        if constexpr (AnyHit) {
          if (ok && ent != ex_ent) {
            t_best = 0.0f;
            done = true;
          }
        } else if (ok) {
          t_best = t;
          gid_best = gid;
          ent_best = ent;
        }
      }
      if constexpr (AnyHit) {
        if (__all_sync(kFullWarp, done)) break;
      }
    }
  }
  if (!in_range) return;
  if constexpr (AnyHit) {
    occluded[lane] = t_best == 0.0f ? 1 : 0;
  } else {
    t_out[lane] = t_best < t0 ? t_best : kBig;
    gid_out[lane] = gid_best;
    ent_out[lane] = ent_best;
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <class Rows>
int closest_hit(const float* table, const float* meta, int n_chunks,
                const float* o, const float* d, const int* excl,
                const float* t_init, int n, float* t_out, int* gid_out,
                int* ent_out, void* stream) {
  chunk_scan<Rows, false><<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      table, meta, n_chunks, o, d, excl, nullptr, t_init, n, t_out, gid_out,
      ent_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <class Rows>
int any_hit(const float* table, const float* meta, int n_chunks,
            const float* o, const float* d, const int* excl,
            const int* excl_ent, const float* t_max, int n,
            unsigned char* occluded, void* stream) {
  chunk_scan<Rows, true><<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      table, meta, n_chunks, o, d, excl, excl_ent, t_max, n, nullptr, nullptr,
      nullptr, occluded);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launchers with a plain C interface (bound with ctypes).  They launch on the
// given stream, do not synchronise, and return the launch's cudaError_t.
extern "C" int scan_tri_closest_hit(const float* tris, const float* meta,
                                    int n_chunks, const float* o,
                                    const float* d, const int* excl,
                                    const float* t_init, int n, float* t_out,
                                    int* gid_out, int* ent_out, void* stream) {
  return closest_hit<TriRows>(tris, meta, n_chunks, o, d, excl, t_init, n,
                              t_out, gid_out, ent_out, stream);
}

extern "C" int scan_sphere_closest_hit(const float* table, const float* meta,
                                       int n_chunks, const float* o,
                                       const float* d, const int* excl,
                                       const float* t_init, int n,
                                       float* t_out, int* gid_out,
                                       int* ent_out, void* stream) {
  return closest_hit<SphereRows>(table, meta, n_chunks, o, d, excl, t_init, n,
                                 t_out, gid_out, ent_out, stream);
}

extern "C" int scan_tri_any_hit(const float* tris, const float* meta,
                                int n_chunks, const float* o, const float* d,
                                const int* excl, const int* excl_ent,
                                const float* t_max, int n,
                                unsigned char* occluded, void* stream) {
  return any_hit<TriRows>(tris, meta, n_chunks, o, d, excl, excl_ent, t_max,
                          n, occluded, stream);
}

extern "C" int scan_sphere_any_hit(const float* table, const float* meta,
                                   int n_chunks, const float* o,
                                   const float* d, const int* excl,
                                   const int* excl_ent, const float* t_max,
                                   int n, unsigned char* occluded,
                                   void* stream) {
  return any_hit<SphereRows>(table, meta, n_chunks, o, d, excl, excl_ent,
                             t_max, n, occluded, stream);
}
