// The per-slot row tests and the chunk-box test shared by every traversal
// kernel of the port (K1-K5, K7-K9), so that each fused multiply-add of the
// contract is written once.
//
// The reference's row tests are paths_tpu/ops/pallas_traverse.py::
// _sphere_row_test and ::_tri_row_test_v2 (on the origin recentred by
// ::_chunk_shift).  XLA's CPU compilation of the reference kernels contracts
// some of their multiply-adds into FMAs (LLVM contraction, verified bit for
// bit in interpret mode); these functions issue exactly those as fmaf, and
// the kernels are built with -fmad=false so that nvcc contracts nothing
// else.  IEEE division and sqrtf (no fast-math flags).  The plain PyTorch
// versions (ops/sphere_traverse.py::_row_test, ops/tri_traverse.py::
// _row_test) emulate the same FMAs exactly, so kernels, plain versions and
// the reference agree bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace paths_rt {

constexpr int kRowFloats = 128;  // floats per table row and per meta row
constexpr float kBig = 3.4e38f;
constexpr float kDead = 1e29f;   // a lane whose origin x is past this is dead
constexpr float kBoxPad = 1e-4f;  // relative pad of a chunk box (conservative cull)

// Does the ray (o, 1/d) cross the chunk's box before t_best?  The box (meta
// columns 0:6) is padded by a relative 1e-4 so that f32 rounding of the box
// can only keep a chunk, never drop one: a cull with it never changes a
// lane's result.  An axis whose slab distance is NaN (d == 0 with the origin
// exactly on a padded plane) does not constrain: conservative.
__device__ __forceinline__ bool crosses_box(const float* __restrict__ m,
                                            const float o[3],
                                            const float inv[3],
                                            float t_best) {
  float tmin = -kBig;
  float tmax = kBig;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float lo = m[ax];
    const float hi = m[3 + ax];
    const float pad = kBoxPad * (fabsf(lo) + fabsf(hi) + (hi - lo)) + 1e-6f;
    const float t0 = (lo - pad - o[ax]) * inv[ax];
    const float t1 = (hi + pad - o[ax]) * inv[ax];
    if (isnan(t0) || isnan(t1)) continue;
    tmin = fmaxf(tmin, fminf(t0, t1));
    tmax = fminf(tmax, fmaxf(t0, t1));
  }
  return tmin < tmax && tmin < t_best && tmax > 0.0f;
}

// Sphere slot [cx cy cz r^2 gid ent 0 0]: oc = o - c, b = d.oc,
// c2 = oc.oc - r^2, disc = b^2 - c2, with the reference's three FMAs:
//   b = fma(dz, ocz, fma(dx, ocx, dy*ocy)),
//   c2 = fma(ocz, ocz, fma(ocx, ocx, ocy*ocy)) - r^2,  disc = fma(b, b, -c2);
//   root = sqrt(max(disc, 0)), d1 = -b + root, d2 = -b - root,
//   t = d2 > 0 ? d2 : d1.
// Returns whether the sphere is met ahead (disc >= 0 && d1 >= 0) and sets t.
// An empty slot (r^2 = -1, gid = -1) fails the caller's gid >= 0 test.
__device__ __forceinline__ bool sphere_slot(float cx, float cy, float cz,
                                            float r2, const float o[3],
                                            const float d[3], float& t) {
  const float ocx = o[0] - cx;
  const float ocy = o[1] - cy;
  const float ocz = o[2] - cz;
  const float b = fmaf(d[2], ocz, fmaf(d[0], ocx, d[1] * ocy));
  const float c2 = fmaf(ocz, ocz, fmaf(ocx, ocx, ocy * ocy)) - r2;
  const float disc = fmaf(b, b, -c2);
  const float root = sqrtf(fmaxf(disc, 0.0f));
  const float d1 = -b + root;
  const float d2 = -b - root;
  t = d2 > 0.0f ? d2 : d1;
  return disc >= 0.0f && d1 >= 0.0f;
}

// The reference's contracted three-term dot product.
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return fmaf(az, bz, fmaf(ax, bx, ay * by));
}

// Plane-form triangle slot, read as four float4: a = [n.xyz dd],
// b = [g1.xyz c1], e = [g2.xyz c2] (the fourth, [gid 0 ent 0], is the
// caller's).  os is the origin recentred on the slot's chunk,
// o - 0.5f * (lo + hi) (exact: the product by 0.5 is exact).  With the
// reference's fourteen FMAs (the six dot3 and the two barycentric forms):
//   t = (dd - dot(n, os)) / dot(n, d),
//   bx = fma(t, dot(g1, d), c1 + dot(g1, os)),  by likewise with g2, c2,
//   bz = (1 - bx) - by.
// Returns t >= 0 && bx >= 0 && by >= 0 && bz >= 0 and sets t.  The
// reference tests min(min(t, bx), min(by, bz)) >= 0 with a min that
// propagates NaN; fminf does not, so the test is four comparisons, the same
// predicate.  An empty or degenerate slot (c1 = c2 = -BIG) always fails.
__device__ __forceinline__ bool tri_slot(const float4 a, const float4 b,
                                         const float4 e, const float os[3],
                                         const float d[3], float& t) {
  const float cos_t = dot3(a.x, a.y, a.z, d[0], d[1], d[2]);
  t = (a.w - dot3(a.x, a.y, a.z, os[0], os[1], os[2])) / cos_t;
  const float bx = fmaf(t, dot3(b.x, b.y, b.z, d[0], d[1], d[2]),
                        b.w + dot3(b.x, b.y, b.z, os[0], os[1], os[2]));
  const float by = fmaf(t, dot3(e.x, e.y, e.z, d[0], d[1], d[2]),
                        e.w + dot3(e.x, e.y, e.z, os[0], os[1], os[2]));
  const float bz = (1.0f - bx) - by;
  return t >= 0.0f && bx >= 0.0f && by >= 0.0f && bz >= 0.0f;
}

}  // namespace paths_rt
