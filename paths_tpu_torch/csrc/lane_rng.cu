// The counter-based lane RNG for Hopper (sm_90a): one shading uniform a
// launch (shading_uniform) and a lane's two camera CMJ points a launch
// (camera_cmj).
//
// Replaces no TPU kernel: the reference computes the same words with
// elementwise XLA operations (paths_tpu/sampling/hashing.py, cmj.py), which
// its compiler fuses.  The port's eager version (sampling/hashing.py,
// sampling/cmj.py) carries u32 words in int64 and multiplies in 16-bit
// halves, so one draw is about 125 elementwise launches and one camera
// sample about 350; here each is one launch, in native uint32_t words.
//
// The words are the plain versions' bit for bit:
//   hash_u32(k0..k3): h = 0x9E3779B9, then for each key
//     h = fmix32((h ^ k) * 0x85EBCA6B + 0xE6546B64), all mod 2^32, with
//     murmur3's finalizer fmix32 (multipliers 0x85EBCA6B, 0xC2B2AE35).
//   shading_uniform: ctr = bounce * DIMS_PER_BOUNCE + dim mod 2^32, the
//     four-key hash of (seed, pixel, sample, ctr), then (bits >> 8) * 2^-24
//     in f32 (exact: 24 bits).
//   camera_cmj: s = sample % (m n), batch = sample / (m n), the seeds
//     hash_u32(seed, pixel, batch, tag) for the square and disk tags (the
//     renderer passes render._SQUARE_TAG 0x5153, _DISK_TAG 0xD15C), and
//     cmj(s, m, n, p) for each (sampling.rs:166-235): permutations with the
//     multipliers 0xA73BD290, 0xA511E9B3, 0x63D83595, Pixar's jitter hash
//     (0xB36534E5, 0x93FC4795, 0xDF6E307F) with seeds p * 0xA399D265 and
//     p * 0x711AD6A5, the jitter's integer rounded to nearest f32 and scaled
//     by 1/4294967808 rounded to f32, as PyTorch applies a Python float to
//     an f32 tensor.  The wrapper takes m and n powers of two only, so the
//     divisions by them are exact, as in every device's eager version.
// The disk pattern's polar map (2 pi x, sqrt, cos, sin) stays in PyTorch.
//
// Lane keys come as int64 tensors, of which the low 32 bits are the word,
// as in hashing.as_u32; a null bounce pointer means the scalar bounce for
// every lane.  The seed comes by value, or, where seed_word is not null, as
// the low 32 bits of the int64 word it points to on the card: a launch
// captured into a CUDA graph then reads each replay's seed
// (step_graphs.py), where a by-value seed would be the capture's forever.
//
// What bounds them on this card: nothing of the card.  A lane reads two or
// three keys (8 B each) and writes 4 or 16 B against a few dozen integer
// operations; at 65,536 lanes that is under 2 MB, about half a microsecond
// at 3.35 TB/s, below a launch's own cost.  The design does the one thing
// that matters at that size: one launch where the eager version made a
// hundred.  One thread a lane, 256 a block, no shared memory; built with
// -fmad=false, though no float product here meets an addition it could be
// fused with to a different result.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

constexpr uint32_t kHashInit = 0x9E3779B9u;
constexpr uint32_t kMurmurC1 = 0x85EBCA6Bu;
constexpr uint32_t kMurmurC2 = 0xC2B2AE35u;
constexpr uint32_t kMixAdd = 0xE6546B64u;
constexpr uint32_t kDimsPerBounce = 10;  // hashing.DIMS_PER_BOUNCE

constexpr uint32_t kPermS = 0xA73BD290u;
constexpr uint32_t kPermX = 0xA511E9B3u;
constexpr uint32_t kPermY = 0x63D83595u;
constexpr uint32_t kJitterX = 0xA399D265u;
constexpr uint32_t kJitterY = 0x711AD6A5u;
constexpr uint32_t kPixarA = 0xB36534E5u;
constexpr uint32_t kPixarB = 0x93FC4795u;
constexpr uint32_t kPixarXor = 0xDF6E307Fu;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kMurmurC1;
  h ^= h >> 13;
  h *= kMurmurC2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t k) {
  return fmix32((h ^ k) * kMurmurC1 + kMixAdd);
}

__device__ __forceinline__ uint32_t hash4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return mix(mix(mix(mix(kHashInit, a), b), c), d);
}

// The low 32 bits of lane i of an int64 key tensor.
__device__ __forceinline__ uint32_t word(const long long* p, int i) {
  return static_cast<uint32_t>(p[i]);
}

// cmj.rand_float: Pixar's jitter hash of sample s under seed p, in [0, 1).
__device__ __forceinline__ float rand_float(uint32_t i, uint32_t p) {
  i ^= p;
  i ^= i >> 17;
  i ^= i >> 10;
  i *= kPixarA;
  i ^= i >> 12;
  i ^= i >> 21;
  i *= kPixarB;
  i ^= kPixarXor;
  i ^= i >> 17;
  i *= 1u | (p >> 18);
  return __uint2float_rn(i) * static_cast<float>(1.0 / 4294967808.0);
}

// cmj.cmj: the point of sample s in an m x n pattern under seed p.
__device__ __forceinline__ void cmj(uint32_t s, uint32_t m, uint32_t n,
                                    uint32_t p, float* x, float* y) {
  const uint32_t ps = (s + p * kPermS) % (m * n);
  const float sx = __uint2float_rn((ps % m + p * kPermX) % m);
  const float sy = __uint2float_rn((ps / m + p * kPermY) % n);
  const float jx = rand_float(s, p * kJitterX);
  const float jy = rand_float(s, p * kJitterY);
  const float fm = __uint2float_rn(m);
  const float fn = __uint2float_rn(n);
  *x = __fdiv_rn(__fadd_rn(__uint2float_rn(s % m), __fdiv_rn(__fadd_rn(sy, jx), fn)), fm);
  *y = __fdiv_rn(__fadd_rn(__uint2float_rn(s / m), __fdiv_rn(__fadd_rn(sx, jy), fm)), fn);
}

// The seed of a launch: the device word where there is one.
__device__ __forceinline__ uint32_t seed_of(uint32_t seed,
                                            const long long* seed_word) {
  return seed_word ? word(seed_word, 0) : seed;
}

__global__ void shading_uniform_kernel(uint32_t seed, const long long* seed_word,
                                       const long long* pixel,
                                       const long long* sample,
                                       const long long* bounce,
                                       uint32_t bounce_all, uint32_t dim, int n,
                                       float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t b = bounce ? word(bounce, i) : bounce_all;
  const uint32_t bits = hash4(seed_of(seed, seed_word), word(pixel, i),
                              word(sample, i), b * kDimsPerBounce + dim);
  out[i] = __uint2float_rn(bits >> 8) * (1.0f / 16777216.0f);
}

// out (4, n) f32: square x, square y, disk pattern x, disk pattern y.
__global__ void camera_cmj_kernel(uint32_t seed, const long long* seed_word,
                                  const long long* pixel,
                                  const long long* sample, uint32_t m,
                                  uint32_t n_pat, uint32_t square_tag,
                                  uint32_t disk_tag, int n, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t pid = word(pixel, i);
  const uint32_t sid = word(sample, i);
  const uint32_t key = seed_of(seed, seed_word);
  const uint32_t mn = m * n_pat;
  const uint32_t s = sid % mn;
  const uint32_t batch = sid / mn;
  const long long stride = n;
  cmj(s, m, n_pat, hash4(key, pid, batch, square_tag), out + i,
      out + stride + i);
  cmj(s, m, n_pat, hash4(key, pid, batch, disk_tag), out + 2 * stride + i,
      out + 3 * stride + i);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int lane_shading_uniform(uint32_t seed, const long long* seed_word,
                                    const long long* pixel,
                                    const long long* sample,
                                    const long long* bounce,
                                    uint32_t bounce_all, uint32_t dim, int n,
                                    float* out, void* stream) {
  shading_uniform_kernel<<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      seed, seed_word, pixel, sample, bounce, bounce_all, dim, n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lane_camera_cmj(uint32_t seed, const long long* seed_word,
                               const long long* pixel,
                               const long long* sample, uint32_t m,
                               uint32_t n_pat, uint32_t square_tag,
                               uint32_t disk_tag, int n, float* out,
                               void* stream) {
  camera_cmj_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      seed, seed_word, pixel, sample, m, n_pat, square_tag, disk_tag, n, out);
  return static_cast<int>(cudaGetLastError());
}
