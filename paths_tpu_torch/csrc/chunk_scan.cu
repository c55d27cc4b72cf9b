// Linear chunk-scan kernel for Hopper (sm_90a): closest-hit over a sphere
// table (K8), and nothing else.  The triangle closest-hit (K7) and both
// any-hit forms (K9) walk their tables' hierarchies with the kernels of
// csrc/tri_traverse.cu and csrc/sphere_traverse.cu (ops/chunk_scan.py).
//
// Replaces paths_tpu/ops/pallas_traverse.py::_make_chunked_sphere_kernel
// (K8, closest_hit_spheres), whose row test is ::_sphere_row_test
// (row_tests.cuh).  The contract ported is that kernel's outputs, not its
// TPU schedule (lane sort, 1,024-lane blocks): a lane's result does not
// depend on its block.
//
// Layout (ops/sphere_traverse.py::pack_spheres_chunked, 16 rows per chunk
// here):
//   table (R, 128) f32: 16 sphere slots of 8 floats per row, slot =
//     [cx cy cz r^2 gid ent 0 0]; an empty slot has r^2 = -1 and gid = -1.
//   meta (C, 128) f32 per chunk: [lo.xyz hi.xyz row0 nrows ...].
//
// Per slot (strict comparisons; the first qualifying slot in table order
// wins a tie): qualifies iff the sphere test passes && t < t_best &&
// gid != excl && gid >= 0.  A lane with o.x > 1e29 is dead: a miss.  Writes
// t_best < t_init ? t_best : BIG, and gid/ent (0 on a miss).
//
// What bounds it on this card: FP32 issue.  A (ray, slot) pair costs about 25
// FP32 operations while a lane moves about 36 bytes; the table (16 KB at 500
// spheres) stays in cache.
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
// outputs equal the plain version's (flat brute force) bit for bit.  Built
// with -fmad=false: no FMA beyond those of the row test.

#include <cuda_runtime.h>

#include "row_tests.cuh"

namespace {

using paths_rt::crosses_box;
using paths_rt::kBig;
using paths_rt::kDead;
using paths_rt::kRowFloats;

constexpr int kThreads = 256;
constexpr int kSlots = 16;  // sphere slots per row: [cx cy cz r^2 | gid ent 0 0]
constexpr unsigned kFullWarp = 0xffffffffu;

// One thread per ray; every thread of a warp reaches the votes, so lanes
// past n take part as finished lanes.
__global__ void __launch_bounds__(kThreads)
    sphere_scan(const float* __restrict__ table, const float* __restrict__ meta,
                int n_chunks, const float* __restrict__ o,
                const float* __restrict__ d, const int* __restrict__ excl,
                const float* __restrict__ t_seed, int n,
                float* __restrict__ t_out, int* __restrict__ gid_out,
                int* __restrict__ ent_out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = lane < n;
  float ro[3] = {0.0f, 0.0f, 0.0f};
  float rd[3] = {1.0f, 1.0f, 1.0f};
  int ex = -1;
  float t0 = 0.0f;
  if (in_range) {
    for (int ax = 0; ax < 3; ++ax) {
      ro[ax] = o[3 * lane + ax];
      rd[ax] = d[3 * lane + ax];
    }
    ex = excl[lane];
    t0 = t_seed[lane];
  }
  float t_best = t0;
  int gid_best = 0;
  int ent_best = 0;
  // A finished lane tests nothing more: out of range or dead.
  const bool done = !in_range || ro[0] > kDead;
  const float inv[3] = {1.0f / rd[0], 1.0f / rd[1], 1.0f / rd[2]};

  for (int c = 0; c < n_chunks; ++c) {
    if (__all_sync(kFullWarp, done)) break;
    const float* m = meta + static_cast<size_t>(c) * kRowFloats;
    const bool want = !done && crosses_box(m, ro, inv, t_best);
    if (!__any_sync(kFullWarp, want)) continue;
    const int row0 = static_cast<int>(m[6]);
    const int row1 = row0 + static_cast<int>(m[7]);
    for (int r = row0; r < row1; ++r) {
      const float4* row = reinterpret_cast<const float4*>(
          table + static_cast<size_t>(r) * kRowFloats);
#pragma unroll 4
      for (int k = 0; k < kSlots; ++k) {
        const float4 s = __ldg(row + 2 * k);
        const float4 f = __ldg(row + 2 * k + 1);
        // ent is converted here, with gid: converted inside the branch it
        // cost two spilled registers and 3% on an H100.
        const int gid = static_cast<int>(f.x);
        const int ent = static_cast<int>(f.y);
        float t;
        const bool met = paths_rt::sphere_slot(s.x, s.y, s.z, s.w, ro, rd, t) && gid >= 0;
        if (!done && met && t < t_best && gid != ex) {
          t_best = t;
          gid_best = gid;
          ent_best = ent;
        }
      }
    }
  }
  if (!in_range) return;
  t_out[lane] = t_best < t0 ? t_best : kBig;
  gid_out[lane] = gid_best;
  ent_out[lane] = ent_best;
}

}  // namespace

// Launcher with a plain C interface (bound with ctypes).  It launches on the
// given stream, does not synchronise, and returns the launch's cudaError_t.
extern "C" int scan_sphere_closest_hit(const float* table, const float* meta,
                                       int n_chunks, const float* o,
                                       const float* d, const int* excl,
                                       const float* t_init, int n,
                                       float* t_out, int* gid_out,
                                       int* ent_out, void* stream) {
  sphere_scan<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      table, meta, n_chunks, o, d, excl, t_init, n, t_out, gid_out, ent_out);
  return static_cast<int>(cudaGetLastError());
}
