// The double-single ray/sphere test for Hopper (sm_90a), one launch a
// query: the closest hit over spheres [lo, hi) (sphere_ds_closest), the
// shadow test over spheres [0, n_spheres) (sphere_ds_any_hit) and one sphere
// per lane (sphere_ds_intersect).
//
// Replaces no TPU kernel: the reference evaluates geom/sphere.intersect with
// elementwise XLA operations, which its compiler fuses.  The port's eager
// version (geom/sphere.py over math/ds.py) is about 180 elementwise launches
// a sphere: doom's two big spheres cost about 1,450 launches a bounce
// iteration, the environment's ground about 740.  Here each query is one
// launch.
//
// The words are the eager version's bit for bit: every step below is the
// same float32 operation on the same operands in the same order as
// geom/sphere.intersect and math/ds.py, written with __fadd_rn, __fsub_rn,
// __fmul_rn, __fdiv_rn and __fsqrt_rn (round to nearest, never contracted
// into an FMA whatever the flags; the library is built with -fmad=false
// besides).  PyTorch's elementwise kernels on the card round each operation
// once, as these intrinsics do, and its sqrt and division are IEEE:
//   oc = o - c by two_sum, the centre's low part taken off the low word;
//   b = d.oc and oc.oc in double-single (Dekker's split by 4097, two_prod
//     without FMA), r^2 by two_prod;
//   disc = (b^2 - oc.oc) + r^2; a lane whose float disc is not >= 0 (NaN
//     included: rays from the integrator's DEAD_ORIGIN) takes a zero
//     discriminant, and ds.sqrt's one Newton step gives the root;
//   d1 = -b + root, d2 = -b - root, hit = disc >= 0 and d1 >= 0,
//     t = d2 > 0 ? d2 : d1 on a hit, 3.4e38f (BIG) on a miss.
// Closest hit: a sphere's t, BIG where it misses or is the lane's excluded
// sphere, wins where it is strictly below the running best (seeded by the
// caller's t and index), spheres in index order: the eager scan's
// first-index argmin over each step of spheres and its strict merge.  Any
// hit: a sphere occludes where it is hit at t < t_max, is not the excluded
// sphere and its entity is not excl_ent; OR-ed into the lane's flag, and a
// lane stops at its first occluder.
//
// What bounds it on this card: the launch.  A lane reads its ray (24 B) and
// a few words of keys and writes 5-8 B; the sphere rows (centre, low part,
// radius, entity: 32 B) are the same for every lane, read through __ldg.  At
// 65,536 lanes that is about 3 MB, about 1 us at 3.35 TB/s, against about
// 300 FP32 operations a lane and sphere (about 1 us at the FP32 rate for
// doom's two spheres), both near a launch's own few microseconds.  The
// design does what matters at that size: one launch where the eager version
// made about 360 a sphere.  One thread a lane, 256 a block (256 blocks at
// 65,536 lanes, more than the 132 SMs), no shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.4e38f;  // geom/sphere.BIG as float32
constexpr float kSplitter = 4097.0f;  // 2^12 + 1, math/ds._SPLITTER

struct DS {
  float hi, lo;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// ds.two_sum: a + b = s + e exactly.
__device__ __forceinline__ DS two_sum(float a, float b) {
  const float s = add(a, b);
  const float bb = sub(s, a);
  return {s, add(sub(a, sub(s, bb)), sub(b, bb))};
}

// ds.fast_two_sum, for |a| >= |b|.
__device__ __forceinline__ DS fast_two_sum(float a, float b) {
  const float s = add(a, b);
  return {s, sub(b, sub(s, a))};
}

// ds.split: a = hi + lo, each with at most 12 mantissa bits.
__device__ __forceinline__ DS split(float a) {
  const float t = mul(kSplitter, a);
  const float hi = sub(t, sub(t, a));
  return {hi, sub(a, hi)};
}

// ds.two_prod: a * b = p + e exactly, without FMA.
__device__ __forceinline__ DS two_prod(float a, float b) {
  const float p = mul(a, b);
  const DS x = split(a);
  const DS y = split(b);
  const float e = add(add(add(sub(mul(x.hi, y.hi), p), mul(x.hi, y.lo)), mul(x.lo, y.hi)),
                      mul(x.lo, y.lo));
  return {p, e};
}

// ds.add: (hi, lo) + (hi, lo).
__device__ __forceinline__ DS ds_add(DS x, DS y) {
  const DS s = two_sum(x.hi, y.hi);
  return fast_two_sum(s.hi, add(add(s.lo, x.lo), y.lo));
}

__device__ __forceinline__ DS ds_neg(DS x) { return {-x.hi, -x.lo}; }

// ds.sqr, which is ds.mul(x, x).
__device__ __forceinline__ DS ds_sqr(DS x) {
  const DS p = two_prod(x.hi, x.hi);
  return fast_two_sum(p.hi, add(add(p.lo, mul(x.hi, x.lo)), mul(x.lo, x.hi)));
}

__device__ __forceinline__ float to_f32(DS x) { return add(x.hi, x.lo); }

// ds.sqrt: one Newton step on the float root; a root of 0 where hi is not
// positive.
__device__ __forceinline__ DS ds_sqrt(DS x) {
  const float s = x.hi > 0.0f ? __fsqrt_rn(x.hi) : 0.0f;
  const DS p = two_prod(s, s);
  const float r = add(sub(sub(x.hi, p.hi), p.lo), x.lo);
  const float corr = s > 0.0f ? __fdiv_rn(r, mul(2.0f, s)) : 0.0f;
  return fast_two_sum(s, corr);
}

// geom/sphere.intersect for one ray and one sphere: t (kBig on a miss) and
// whether it hits; with has_lo, lo is the centre's low part.
__device__ __forceinline__ float sphere_test(const float o[3], const float d[3],
                                             const float c[3], bool has_lo,
                                             const float lo[3], float radius,
                                             bool* hit) {
  float och[3], ocl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const DS oc = two_sum(o[k], -c[k]);
    och[k] = oc.hi;
    ocl[k] = has_lo ? sub(oc.lo, lo[k]) : oc.lo;
  }
  DS b = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const DS p = two_prod(d[k], och[k]);
    b = ds_add(b, {p.hi, add(p.lo, mul(d[k], ocl[k]))});
  }
  DS oc2 = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const DS p = two_prod(och[k], och[k]);
    oc2 = ds_add(oc2, {p.hi, add(p.lo, mul(mul(2.0f, och[k]), ocl[k]))});
  }
  const DS r2 = two_prod(radius, radius);
  const DS disc = ds_add(ds_add(ds_sqr(b), ds_neg(oc2)), r2);
  const float disc_v = to_f32(disc);
  const bool valid = disc_v >= 0.0f;
  const DS safe = {valid ? (disc.hi < 0.0f ? 0.0f : disc.hi) : 0.0f,
                   valid ? disc.lo : 0.0f};
  const DS root = ds_sqrt(safe);
  const DS tmp = ds_neg(b);
  const float d1 = to_f32(ds_add(tmp, root));
  const float d2 = to_f32(ds_add(tmp, ds_neg(root)));
  *hit = valid && d1 >= 0.0f;
  return *hit ? (d2 > 0.0f ? d2 : d1) : kBig;
}

__device__ __forceinline__ void load3(const float* p, int i, float v[3]) {
  p += 3 * static_cast<long long>(i);
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = p[k];
}

// Row s of the sphere table: its centre and, where the table has them, its
// low part (else 0, which sphere_test does not read).
__device__ __forceinline__ void sphere_row(const float* center, const float* center_lo,
                                           int s, float c[3], float lo[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = __ldg(center + 3 * s + k);
    lo[k] = center_lo ? __ldg(center_lo + 3 * s + k) : 0.0f;
  }
}

__global__ void sphere_ds_closest_kernel(const float* __restrict__ center,
                                         const float* __restrict__ center_lo,
                                         const float* __restrict__ radius, int lo, int hi,
                                         const float* __restrict__ o,
                                         const float* __restrict__ d,
                                         const bool* __restrict__ excl,
                                         const int* __restrict__ excl_idx,
                                         const float* __restrict__ t_in,
                                         const int* __restrict__ i_in, int n,
                                         float* __restrict__ t_out,
                                         int* __restrict__ i_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float ro[3], rd[3], c[3], clo[3];
  load3(o, i, ro);
  load3(d, i, rd);
  const int skip = excl[i] ? excl_idx[i] : -1;
  float best = t_in[i];
  int best_i = i_in[i];
  for (int s = lo; s < hi; ++s) {
    sphere_row(center, center_lo, s, c, clo);
    bool hit;
    float t = sphere_test(ro, rd, c, center_lo != nullptr, clo, __ldg(radius + s), &hit);
    if (!hit || s == skip) t = kBig;
    if (t < best) {
      best = t;
      best_i = s;
    }
  }
  t_out[i] = best;
  i_out[i] = best_i;
}

__global__ void sphere_ds_any_hit_kernel(const float* __restrict__ center,
                                         const float* __restrict__ center_lo,
                                         const float* __restrict__ radius,
                                         const int* __restrict__ ent, int n_spheres,
                                         const float* __restrict__ o,
                                         const float* __restrict__ d,
                                         const bool* __restrict__ excl,
                                         const int* __restrict__ excl_idx,
                                         const float* __restrict__ t_max,
                                         const int* __restrict__ excl_ent,
                                         const bool* __restrict__ occ_in, int n,
                                         bool* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool occ = occ_in[i];
  if (!occ) {
    float ro[3], rd[3], c[3], clo[3];
    load3(o, i, ro);
    load3(d, i, rd);
    const int skip = excl[i] ? excl_idx[i] : -1;
    const float tm = t_max[i];
    const int xe = excl_ent[i];
    for (int s = 0; s < n_spheres && !occ; ++s) {
      sphere_row(center, center_lo, s, c, clo);
      bool hit;
      const float t =
          sphere_test(ro, rd, c, center_lo != nullptr, clo, __ldg(radius + s), &hit);
      occ = hit && t < tm && s != skip && __ldg(ent + s) != xe;
    }
  }
  occ_out[i] = occ;
}

__global__ void sphere_ds_intersect_kernel(const float* __restrict__ o,
                                           const float* __restrict__ d,
                                           const float* __restrict__ center,
                                           const float* __restrict__ radius, int n,
                                           float* __restrict__ t_out,
                                           bool* __restrict__ hit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float ro[3], rd[3], c[3];
  load3(o, i, ro);
  load3(d, i, rd);
  load3(center, i, c);
  bool hit;
  t_out[i] = sphere_test(ro, rd, c, false, c, radius[i], &hit);
  hit_out[i] = hit;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Lanes i < n: (t_out, i_out) = the closest of (t_in, i_in) and spheres
// [lo, hi) of the table (center, center_lo or null, radius), the sphere
// excl_idx skipped where excl.
extern "C" int sphere_ds_closest(const float* center, const float* center_lo,
                                 const float* radius, int lo, int hi,
                                 const float* o, const float* d,
                                 const bool* excl, const int* excl_idx,
                                 const float* t_in, const int* i_in, int n,
                                 float* t_out, int* i_out, void* stream) {
  sphere_ds_closest_kernel<<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      center, center_lo, radius, lo, hi, o, d, excl, excl_idx, t_in, i_in, n, t_out,
      i_out);
  return static_cast<int>(cudaGetLastError());
}

// Lanes i < n: occ_out = occ_in or some sphere of [0, n_spheres) occludes.
extern "C" int sphere_ds_any_hit(const float* center, const float* center_lo,
                                 const float* radius, const int* ent,
                                 int n_spheres, const float* o, const float* d,
                                 const bool* excl, const int* excl_idx,
                                 const float* t_max, const int* excl_ent,
                                 const bool* occ_in, int n, bool* occ_out,
                                 void* stream) {
  sphere_ds_any_hit_kernel<<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      center, center_lo, radius, ent, n_spheres, o, d, excl, excl_idx, t_max,
      excl_ent, occ_in, n, occ_out);
  return static_cast<int>(cudaGetLastError());
}

// Lanes i < n: (t, hit) of ray i against sphere (center[i], radius[i]).
extern "C" int sphere_ds_intersect(const float* o, const float* d,
                                   const float* center, const float* radius,
                                   int n, float* t_out, bool* hit_out,
                                   void* stream) {
  sphere_ds_intersect_kernel<<<blocks_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      o, d, center, radius, n, t_out, hit_out);
  return static_cast<int>(cudaGetLastError());
}
