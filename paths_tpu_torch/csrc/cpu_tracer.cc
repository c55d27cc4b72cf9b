// Multithreaded CPU path tracer: the host anchor and the independent
// oracle for the renderer (the port's copy of paths_tpu/native/cpu_tracer.cc,
// entry paths_cpu_render, kept in the port so that it depends on nothing of
// the reference package; bound with ctypes in paths_tpu_torch/native.py and
// built with the reference's flags, so the two libraries compute the same
// image bit for bit).
//
// An independent C++ implementation of the Rust renderer's algorithm (its
// semantics cited per function; a fresh implementation, not a translation)
// -- different language, acceleration structure, RNG and integrator
// formulation (scalar recursion, not a wavefront) -- so that
//   1. a CPU rate is measured on the host that runs the port (the same
//      thread count as the Rust renderer's worker pool, main.rs:87; its
//      rays/s counter, main.rs:107-112 and renderer.rs:101, is the unit), and
//   2. tests can compare two independently written renderers' converged
//      means (the mechanical form of the Rust renderer's "matches Mitsuba"
//      standard, its README.md:39).
//
// Scope: the material/light/sky set the bundled scenes exercise
// (Lambertian / Mirror / Gloss, point + sphere lights, flat / gradient /
// HDRI sky).  CookTorrance / FresnelCombination objects are rejected: the
// reference's Material::sample panics on them (material.rs:81-88), so no
// renderable reference scene can contain one.
//
// Intentionally mirrored reference quirks (shared with the wavefront
// renderer, see paths_tpu_torch/materials.py and lights.py):
//   - the non-unit cosine-hemisphere sample y = 1-u (geom.rs:10-24),
//     normalised only after the basis change;
//   - sphere-light inv_pdf divides by the squared distance via
//     ``magnitude()`` (vector.rs:27, geom.rs:160-169);
//   - smooth shading normals are barycentric sums without renormalisation
//     (model.rs:142-156).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double PI = 3.14159265358979323846;
constexpr double INF = 1e300;

struct V3 {
  double x = 0, y = 0, z = 0;
};
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator*(V3 a, double s) { return {a.x * s, a.y * s, a.z * s}; }
static inline V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
static inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline V3 normed(V3 a) {
  double n = std::sqrt(dot(a, a));
  return n > 0 ? a * (1.0 / n) : a;
}
static inline V3 vmin(V3 a, V3 b) { return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)}; }
static inline V3 vmax(V3 a, V3 b) { return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)}; }
static inline double comp(V3 v, int ax) { return ax == 0 ? v.x : (ax == 1 ? v.y : v.z); }

// xoshiro256++ -- public-domain PRNG (Blackman & Vigna), one state per thread.
struct Rng {
  uint64_t s[4];
  static uint64_t splitmix(uint64_t& x) {
    x += 0x9e3779b97f4a7c15ull;
    uint64_t z = x;
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  explicit Rng(uint64_t seed) {
    for (int i = 0; i < 4; i++) s[i] = splitmix(seed);
  }
  static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
  uint64_t next() {
    uint64_t r = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return r;
  }
  double uniform() { return (next() >> 11) * 0x1.0p-53; }  // [0, 1)
};

struct Ray {
  V3 o, d, inv;
};
static inline Ray make_ray(V3 o, V3 d) {
  return {o, d, {1.0 / d.x, 1.0 / d.y, 1.0 / d.z}};
}

// ---- scene ----

struct Scene {
  int n_sph = 0, n_tri = 0, n_ent = 0, n_lights = 0;
  const double *sph_c = nullptr, *sph_r = nullptr;
  const int32_t* sph_ent = nullptr;
  const double *v0 = nullptr, *v1 = nullptr, *v2 = nullptr, *fn = nullptr,
               *vn = nullptr, *vc = nullptr;
  const int32_t* tri_ent = nullptr;
  const uint8_t* tri_smooth = nullptr;
  const int32_t* mtype = nullptr;
  const double *albedo = nullptr, *emit = nullptr, *r0 = nullptr, *metal = nullptr;
  const uint8_t *albedo_vertex = nullptr, *ent_is_light = nullptr;
  const double* ent_emission = nullptr;
  const int32_t *ltype = nullptr, *lent = nullptr;
  const double *lpos = nullptr, *lrad = nullptr, *lcol = nullptr, *lint = nullptr;
  int sky_type = 0, sky_w = 0, sky_h = 0;
  V3 sky_a, sky_b;
  const float* sky_img = nullptr;
};

struct Hit {
  double t = INF;
  int prim = -1;   // prim id: [0, n_sph) spheres, then triangles
  double bx = 0, by = 0, bz = 0;
};

// Sphere intersection: quadratic discriminant, nearest non-negative root
// (geom.rs:208-235).
static inline bool sphere_hit(const Scene& S, int i, const Ray& r, double tmax,
                              double* t_out) {
  V3 c{S.sph_c[3 * i], S.sph_c[3 * i + 1], S.sph_c[3 * i + 2]};
  double rad = S.sph_r[i];
  V3 oc = r.o - c;
  double b = dot(r.d, oc);
  double disc = b * b - dot(oc, oc) + rad * rad;
  if (disc < 0) return false;
  double sq = std::sqrt(disc);
  double d1 = -b + sq, d2 = -b - sq;
  if (d1 < 0) return false;
  double t = d2 > 0 ? d2 : d1;
  if (t >= tmax) return false;
  *t_out = t;
  return true;
}

// Triangle intersection: plane hit + signed-area barycentrics, NaN-guarded
// (geom.rs:264-303).
static inline bool tri_hit(const Scene& S, int i, const Ray& r, double tmax,
                           double* t_out, double* bx, double* by, double* bz) {
  V3 a{S.v0[3 * i], S.v0[3 * i + 1], S.v0[3 * i + 2]};
  V3 b{S.v1[3 * i], S.v1[3 * i + 1], S.v1[3 * i + 2]};
  V3 c{S.v2[3 * i], S.v2[3 * i + 1], S.v2[3 * i + 2]};
  V3 n{S.fn[3 * i], S.fn[3 * i + 1], S.fn[3 * i + 2]};
  double cos_t = dot(n, r.d);
  double t = (dot(n, a) - dot(n, r.o)) / cos_t;
  if (!(t >= 0) || t >= tmax) return false;  // !(t>=0) also catches NaN
  V3 p = r.o + r.d * t;
  double inv_abc = 1.0 / dot(n, cross(b - a, c - a));
  double x = dot(n, cross(b - p, c - p)) * inv_abc;
  double y = dot(n, cross(c - p, a - p)) * inv_abc;
  double z = 1.0 - x - y;
  if (x < 0 || y < 0 || z < 0) return false;
  *t_out = t; *bx = x; *by = y; *bz = z;
  return true;
}

// ---- BVH: binned SAH over the mixed sphere+triangle soup (one global
// tree, like scene.rs:166-168), ordered stack traversal with t_best
// pruning (the capability of bvh.rs:78-141; construction algorithm is
// plain binned SAH, not the reference's AAC). ----

struct BvhNode {
  V3 lo, hi;
  int left = -1;    // internal: left child (right = left+1); leaf: first prim
  int count = 0;    // leaf: prim count; 0 for internal
};

struct Bvh {
  std::vector<BvhNode> nodes;
  std::vector<int> prims;  // permuted prim ids
};

static void bvh_build_range(Bvh& bvh, std::vector<int>& ids,
                            const std::vector<V3>& lo, const std::vector<V3>& hi,
                            const std::vector<V3>& cen, int begin, int end,
                            int node_ix) {
  BvhNode& fill = bvh.nodes[node_ix];
  V3 blo{INF, INF, INF}, bhi{-INF, -INF, -INF};
  V3 clo{INF, INF, INF}, chi{-INF, -INF, -INF};
  for (int i = begin; i < end; i++) {
    blo = vmin(blo, lo[ids[i]]);
    bhi = vmax(bhi, hi[ids[i]]);
    clo = vmin(clo, cen[ids[i]]);
    chi = vmax(chi, cen[ids[i]]);
  }
  fill.lo = blo;
  fill.hi = bhi;
  int n = end - begin;
  if (n <= 4) {
    fill.left = begin;
    fill.count = n;
    return;
  }
  // Binned SAH split on the widest centroid axis.
  V3 ext = chi - clo;
  int ax = ext.x > ext.y ? (ext.x > ext.z ? 0 : 2) : (ext.y > ext.z ? 1 : 2);
  double cmin = comp(clo, ax), cext = comp(ext, ax);
  int best_split = -1;
  constexpr int NB = 16;
  if (cext > 0) {
    struct Bin { V3 lo{INF, INF, INF}, hi{-INF, -INF, -INF}; int n = 0; };
    Bin bins[NB];
    double scale = NB / cext;
    for (int i = begin; i < end; i++) {
      int b = std::min(NB - 1, (int)((comp(cen[ids[i]], ax) - cmin) * scale));
      bins[b].lo = vmin(bins[b].lo, lo[ids[i]]);
      bins[b].hi = vmax(bins[b].hi, hi[ids[i]]);
      bins[b].n++;
    }
    double right_sa[NB];
    { V3 l{INF, INF, INF}, h{-INF, -INF, -INF};
      for (int b = NB - 1; b > 0; b--) {
        l = vmin(l, bins[b].lo); h = vmax(h, bins[b].hi);
        V3 e = vmax(h - l, {0, 0, 0});
        right_sa[b] = e.x * e.y + e.y * e.z + e.z * e.x;
      } }
    double best = INF;
    V3 l{INF, INF, INF}, h{-INF, -INF, -INF};
    int nl = 0;
    for (int b = 0; b < NB - 1; b++) {
      l = vmin(l, bins[b].lo); h = vmax(h, bins[b].hi); nl += bins[b].n;
      if (nl == 0 || nl == n) continue;
      V3 e = vmax(h - l, {0, 0, 0});
      double cost = nl * (e.x * e.y + e.y * e.z + e.z * e.x) +
                    (n - nl) * right_sa[b + 1];
      if (cost < best) { best = cost; best_split = b; }
    }
  }
  int mid;
  if (best_split < 0) {
    mid = begin + n / 2;  // degenerate spread: median split
    std::nth_element(ids.begin() + begin, ids.begin() + mid, ids.begin() + end,
                     [&](int a, int b) { return comp(cen[a], ax) < comp(cen[b], ax); });
  } else {
    double scale = NB / cext;
    auto it = std::partition(ids.begin() + begin, ids.begin() + end, [&](int id) {
      return (int)std::min((double)(NB - 1), (comp(cen[id], ax) - cmin) * scale) <= best_split;
    });
    mid = (int)(it - ids.begin());
    if (mid == begin || mid == end) mid = begin + n / 2;
  }
  int left_ix = (int)bvh.nodes.size();
  bvh.nodes[node_ix].left = left_ix;
  bvh.nodes[node_ix].count = 0;
  bvh.nodes.emplace_back();
  bvh.nodes.emplace_back();
  bvh_build_range(bvh, ids, lo, hi, cen, begin, mid, left_ix);
  bvh_build_range(bvh, ids, lo, hi, cen, mid, end, left_ix + 1);
}

static Bvh bvh_build(const Scene& S) {
  int n = S.n_sph + S.n_tri;
  std::vector<V3> lo(n), hi(n), cen(n);
  for (int i = 0; i < S.n_sph; i++) {
    V3 c{S.sph_c[3 * i], S.sph_c[3 * i + 1], S.sph_c[3 * i + 2]};
    V3 r{S.sph_r[i], S.sph_r[i], S.sph_r[i]};
    lo[i] = c - r; hi[i] = c + r; cen[i] = c;
  }
  for (int i = 0; i < S.n_tri; i++) {
    V3 a{S.v0[3 * i], S.v0[3 * i + 1], S.v0[3 * i + 2]};
    V3 b{S.v1[3 * i], S.v1[3 * i + 1], S.v1[3 * i + 2]};
    V3 c{S.v2[3 * i], S.v2[3 * i + 1], S.v2[3 * i + 2]};
    int j = S.n_sph + i;
    lo[j] = vmin(a, vmin(b, c)); hi[j] = vmax(a, vmax(b, c));
    cen[j] = (lo[j] + hi[j]) * 0.5;
  }
  Bvh bvh;
  bvh.prims.resize(n);
  for (int i = 0; i < n; i++) bvh.prims[i] = i;
  bvh.nodes.reserve(2 * n);
  bvh.nodes.emplace_back();
  if (n > 0) bvh_build_range(bvh, bvh.prims, lo, hi, cen, 0, n, 0);
  return bvh;
}

// Slab test with cached reciprocal directions (bvh.rs:8-21 capability).
static inline bool aabb_hit(const BvhNode& nd, const Ray& r, double tmax,
                            double* tnear) {
  double t0 = (nd.lo.x - r.o.x) * r.inv.x, t1 = (nd.hi.x - r.o.x) * r.inv.x;
  double tn = std::min(t0, t1), tf = std::max(t0, t1);
  t0 = (nd.lo.y - r.o.y) * r.inv.y; t1 = (nd.hi.y - r.o.y) * r.inv.y;
  tn = std::max(tn, std::min(t0, t1)); tf = std::min(tf, std::max(t0, t1));
  t0 = (nd.lo.z - r.o.z) * r.inv.z; t1 = (nd.hi.z - r.o.z) * r.inv.z;
  tn = std::max(tn, std::min(t0, t1)); tf = std::min(tf, std::max(t0, t1));
  if (tn > tf || tf < 0 || tn >= tmax) return false;
  *tnear = tn;
  return true;
}

static Hit closest_hit(const Scene& S, const Bvh& bvh, const Ray& r) {
  Hit h;
  if (bvh.prims.empty()) return h;
  int stack[96];
  int sp = 0;
  double tn_root;
  if (!aabb_hit(bvh.nodes[0], r, h.t, &tn_root)) return h;
  stack[sp++] = 0;
  while (sp) {
    const BvhNode& nd = bvh.nodes[stack[--sp]];
    if (nd.count) {
      for (int i = nd.left; i < nd.left + nd.count; i++) {
        int p = bvh.prims[i];
        double t, bx, by, bz;
        if (p < S.n_sph) {
          if (sphere_hit(S, p, r, h.t, &t)) { h.t = t; h.prim = p; }
        } else if (tri_hit(S, p - S.n_sph, r, h.t, &t, &bx, &by, &bz)) {
          h.t = t; h.prim = p; h.bx = bx; h.by = by; h.bz = bz;
        }
      }
    } else {
      double tl, tr;
      bool hl = aabb_hit(bvh.nodes[nd.left], r, h.t, &tl);
      bool hr = aabb_hit(bvh.nodes[nd.left + 1], r, h.t, &tr);
      // Descend the nearer child first (bvh.rs:110-127's ordered stack).
      if (hl && hr) {
        int near = nd.left, far = nd.left + 1;
        if (tr < tl) std::swap(near, far);
        stack[sp++] = far;
        stack[sp++] = near;
      } else if (hl) {
        stack[sp++] = nd.left;
      } else if (hr) {
        stack[sp++] = nd.left + 1;
      }
    }
  }
  return h;
}

// ---- shading (material.rs semantics) ----

// Non-unit cosine-hemisphere sample (geom.rs:10-24), y up.
static inline V3 cosine_sample(Rng& rng) {
  double u = rng.uniform(), v = rng.uniform();
  double r = std::sqrt(u), th = 2.0 * PI * v;
  return {r * std::cos(th), 1.0 - u, r * std::sin(th)};
}

// Orthonormal frame from a normal (vector.rs:51-61's form_basis role; any
// frame is statistically equivalent for the rotationally-symmetric local
// sample).
static inline void form_basis(V3 n, V3* t, V3* b) {
  V3 a = std::fabs(n.y) < 0.9 ? V3{0, 1, 0} : V3{1, 0, 0};
  *t = normed(cross(a, n));
  *b = cross(n, *t);
}

static inline V3 lambertian_sample_dir(V3 normal, Rng& rng) {
  V3 l = cosine_sample(rng);
  V3 t, b;
  form_basis(normal, &t, &b);
  return normed(t * l.x + normal * l.y + b * l.z);
}

static inline V3 reflect(V3 v, V3 n) { return normed(n * (2.0 * dot(n, v)) - v); }

struct Bsdf {
  V3 dir;        // sampled outgoing direction
  double pdf;
  V3 brdf;
  bool specular;
};

// material.rs:198-240 (Lambertian), :242-272 (Mirror), :274-371 (Gloss).
static Bsdf sample_material(int mt, V3 alb, double fr0, double metal,
                            V3 vec_out, V3 normal, Rng& rng) {
  if (mt == 1) {  // Mirror
    return {reflect(vec_out, normal), 1.0, {1, 1, 1}, true};
  }
  if (mt == 2) {  // Gloss: Schlick lerp of Lambertian and Mirror
    double cos_t = dot(vec_out, normal);
    double r = fr0 + (1.0 - fr0) * std::pow(1.0 - cos_t, 5.0);
    double spec_chance = fr0 > 0.5 ? r : 0.5;  // material.rs:307-310
    if (rng.uniform() <= spec_chance) {
      V3 tint = alb * metal + V3{1, 1, 1} * (1.0 - metal);
      return {reflect(vec_out, normal), spec_chance, tint * r, true};
    }
    V3 dir = lambertian_sample_dir(normal, rng);
    double pdf = dot(normal, dir) / PI;
    V3 brdf = alb * (dot(normal, dir) / PI) * (1.0 - metal) * (1.0 - r);
    return {dir, pdf * (1.0 - spec_chance), brdf, false};
  }
  // Lambertian
  V3 dir = lambertian_sample_dir(normal, rng);
  return {dir, dot(normal, dir) / PI, alb * (dot(normal, dir) / PI), false};
}

// NEE brdf eval, vec_in pointing INTO the surface (trace.rs:74 convention
// negates before this sees it, so here in_dir = direction toward light).
static V3 eval_brdf(int mt, V3 alb, double fr0, double metal, V3 vec_out,
                    V3 in_dir, V3 normal) {
  if (mt == 1) return {0, 0, 0};  // Mirror: delta, BLACK for NEE
  V3 diffuse = alb * (dot(normal, in_dir) / PI);
  if (mt == 2) {
    double cos_t = dot(vec_out, normal);
    double r = fr0 + (1.0 - fr0) * std::pow(1.0 - cos_t, 5.0);
    return diffuse * (1.0 - metal) * (1.0 - r);  // + specular(BLACK) * r
  }
  return diffuse;
}

// ---- sky (scene.rs:88-113) ----
static V3 sky_light(const Scene& S, V3 dir_neg) {
  // Called with the reference's `ray.direction * -1` argument.
  if (S.sky_type == 0) return S.sky_a;
  if (S.sky_type == 1) {
    double c = dir_neg.y;
    return S.sky_a * c + S.sky_b * (1.0 - c);
  }
  double lat = std::acos(dir_neg.y);
  double lon = std::atan2(dir_neg.z, dir_neg.x);
  double w = S.sky_w, h = S.sky_h;
  int x = std::min(S.sky_w - 1, (int)(w / 2.0 * (lon / PI) + w / 2.0));
  int y = std::min(S.sky_h - 1, (int)(h * (1.0 - lat / PI)));
  const float* p = S.sky_img + 3 * (y * S.sky_w + x);
  return {p[0], p[1], p[2]};
}

// ---- the integrator (trace.rs:7-121, independently re-derived) ----
static V3 trace_ray(const Scene& S, const Bvh& bvh, Ray ray, Rng& rng,
                    int max_bounces) {
  V3 colour{0, 0, 0}, throughput{1, 1, 1};
  bool last_specular = true;
  for (int loops = 0; loops <= max_bounces; loops++) {
    Hit h = closest_hit(S, bvh, ray);
    if (h.prim < 0) {
      colour = colour + throughput * sky_light(S, ray.d * -1.0);
      break;
    }
    V3 p = ray.o + ray.d * h.t;
    int ent;
    V3 normal;
    V3 alb;
    bool is_tri = h.prim >= S.n_sph;
    if (is_tri) {
      int i = h.prim - S.n_sph;
      ent = S.tri_ent[i];
      V3 gn{S.fn[3 * i], S.fn[3 * i + 1], S.fn[3 * i + 2]};
      // Backface flip (geom.rs:297-300)...
      if (dot(gn, ray.d) > 0) gn = gn * -1.0;
      normal = gn;
      if (S.tri_smooth[i]) {
        // ...replaced wholesale by the unflipped smooth normal when the
        // mesh interpolates (scene.rs:178-190, model.rs:142-156, no renorm).
        const double* q = S.vn + 9 * i;
        normal = V3{q[0], q[1], q[2]} * h.bx + V3{q[3], q[4], q[5]} * h.by +
                 V3{q[6], q[7], q[8]} * h.bz;
      }
      alb = {S.albedo[3 * ent], S.albedo[3 * ent + 1], S.albedo[3 * ent + 2]};
      if (S.albedo_vertex[ent]) {  // material.rs:169-196
        const double* q = S.vc + 9 * i;
        alb = V3{q[0], q[1], q[2]} * h.bx + V3{q[3], q[4], q[5]} * h.by +
              V3{q[6], q[7], q[8]} * h.bz;
      }
    } else {
      int i = h.prim;
      ent = S.sph_ent[i];
      V3 c{S.sph_c[3 * i], S.sph_c[3 * i + 1], S.sph_c[3 * i + 2]};
      normal = normed(p - c);
      alb = {S.albedo[3 * ent], S.albedo[3 * ent + 1], S.albedo[3 * ent + 2]};
    }

    double cos_in = dot(ray.d, normal * -1.0);
    if (cos_in <= 0) break;  // trace.rs:25-28

    if (S.ent_is_light[ent]) {  // trace.rs:30-41
      if (last_specular) {
        V3 e{S.ent_emission[3 * ent], S.ent_emission[3 * ent + 1],
             S.ent_emission[3 * ent + 2]};
        colour = colour + throughput * e;
      }
      break;
    }

    int mt = S.mtype[ent];
    double fr0 = S.r0[ent], metal = S.metal[ent];
    V3 vec_out = ray.d * -1.0;

    // NEE: one uniform light (trace.rs:52-81, scene.rs:199-206).
    if (S.n_lights > 0) {
      int li = std::min((int)(rng.uniform() * S.n_lights), S.n_lights - 1);
      V3 lp{S.lpos[3 * li], S.lpos[3 * li + 1], S.lpos[3 * li + 2]};
      V3 in_dir;  // from the light sample point TOWARD the surface
      double inv_pdf, max_dist = INF;
      if (S.ltype[li] == 1) {  // sphere area light (geom.rs:146-169)
        double u = rng.uniform(), v = rng.uniform();
        double th = 2.0 * PI * u, pc = 2.0 * v - 1.0;
        double ps = std::sqrt(std::max(0.0, 1.0 - pc * pc));
        V3 n{ps * std::cos(th), ps * std::sin(th), pc};
        V3 point = lp + n * S.lrad[li];
        V3 out_vec = p - point;
        double dist_sq = dot(out_vec, out_vec);  // `magnitude()` quirk
        in_dir = normed(out_vec);
        double area = 4.0 * PI * S.lrad[li] * S.lrad[li];
        inv_pdf = std::max(0.0, area * dot(n, in_dir) / dist_sq);
      } else {  // point light: intended semantics (lights.py)
        V3 out_vec = p - lp;
        max_dist = std::sqrt(dot(out_vec, out_vec));
        in_dir = out_vec * (1.0 / std::max(max_dist, 1e-300));
        inv_pdf = 1.0;
      }
      Ray shadow = make_ray(p + normal * 1e-4, in_dir * -1.0);
      Hit sh = closest_hit(S, bvh, shadow);
      bool occluded;
      if (S.ltype[li] == 1) {
        int se = sh.prim < 0 ? -1
                 : (sh.prim < S.n_sph ? S.sph_ent[sh.prim]
                                      : S.tri_ent[sh.prim - S.n_sph]);
        occluded = sh.prim >= 0 && se != S.lent[li];
      } else {
        occluded = sh.prim >= 0 && sh.t < max_dist;
      }
      double cos_th = std::max(0.0, dot(normal, shadow.d));
      if (!occluded && cos_th > 0) {
        V3 base{S.lcol[3 * li] * S.lint[li], S.lcol[3 * li + 1] * S.lint[li],
                S.lcol[3 * li + 2] * S.lint[li]};
        V3 brdf = eval_brdf(mt, alb, fr0, metal, vec_out, shadow.d, normal);
        // NB uniform light pick still divides by pdf=1/n_lights only via
        // inv_pdf in the reference (trace.rs:76-78 has no n_lights factor).
        colour = colour + base * brdf * inv_pdf * throughput;
      }
    }

    // BSDF bounce (trace.rs:84-101).
    Bsdf s = sample_material(mt, alb, fr0, metal, vec_out, normal, rng);
    last_specular = s.specular;
    Ray new_ray = make_ray(p + normal * 1e-4, s.dir);
    throughput = throughput * (s.brdf * (1.0 / s.pdf));
    double tmax = std::max(throughput.x, std::max(throughput.y, throughput.z));
    if (tmax <= 0) break;
    V3 em{S.emit[3 * ent], S.emit[3 * ent + 1], S.emit[3 * ent + 2]};
    colour = colour + em * throughput;

    if (loops >= 2) {  // Russian roulette (trace.rs:103-111)
      double survival = tmax;
      if (rng.uniform() > survival) break;
      throughput = throughput * (1.0 / survival);
    }
    ray = new_ray;
  }
  return colour;
}

struct Cam {
  V3 loc;
  double rot[9];
  double f, v, aperture, sw, sh;
  int w, h;
};

static inline V3 rot_apply(const double* m, V3 p) {
  return {m[0] * p.x + m[1] * p.y + m[2] * p.z,
          m[3] * p.x + m[4] * p.y + m[5] * p.z,
          m[6] * p.x + m[7] * p.y + m[8] * p.z};
}

// Thin-lens primary ray (camera.rs:47-94 contract, SURVEY.md section 3.4).
static Ray camera_ray(const Cam& C, int x, int y, double jx, double jy,
                      double lx, double ly, double* weight) {
  x = C.w - x - 1;
  y = C.h - y - 1;
  double p = (C.f * C.v) / (C.v - C.f);
  double image_x = (double)x - C.w / 2.0 + jx;
  double image_y = C.h / 2.0 - (double)y - jy;
  V3 k{image_x * (C.sw / C.w), image_y * (C.sh / C.h), -C.v};
  double ar = C.f / C.aperture;
  V3 l{lx * ar, ly * ar, 0.0};
  V3 dir = (k * (p / C.v) + l) * -1.0;
  V3 nd = normed(dir);
  *weight = nd.z;
  return make_ray(rot_apply(C.rot, l) + C.loc, rot_apply(C.rot, nd));
}

}  // namespace

extern "C" {

// Renders width*height*spp paths; out (H*W*3, f64) receives per-pixel MEAN
// radiance (weighted by the sensor cosine, pixels.rs:6-31 semantics).
// Returns 0, or 1 if an entity uses an unsupported material type.
int paths_cpu_render(
    int width, int height, int spp, uint64_t seed, int n_threads,
    int max_bounces, const double* cam17,
    int n_sph, const double* sph_c, const double* sph_r, const int32_t* sph_ent,
    int n_tri, const double* v0, const double* v1, const double* v2,
    const double* fn, const double* vn, const double* vc,
    const int32_t* tri_ent, const uint8_t* tri_smooth,
    int n_ent, const int32_t* mtype, const double* albedo,
    const uint8_t* albedo_vertex, const double* emit, const double* r0,
    const double* metalness, const uint8_t* ent_is_light,
    const double* ent_emission,
    int n_lights, const int32_t* ltype, const double* lpos, const double* lrad,
    const double* lcol, const double* lint, const int32_t* lent,
    int sky_type, const double* sky_a, const double* sky_b,
    int sky_w, int sky_h, const float* sky_img,
    double* out) {
  for (int e = 0; e < n_ent; e++) {
    if (!ent_is_light[e] && mtype[e] > 2) return 1;  // material.rs:81-88
  }
  Scene S;
  S.n_sph = n_sph; S.n_tri = n_tri; S.n_ent = n_ent; S.n_lights = n_lights;
  S.sph_c = sph_c; S.sph_r = sph_r; S.sph_ent = sph_ent;
  S.v0 = v0; S.v1 = v1; S.v2 = v2; S.fn = fn; S.vn = vn; S.vc = vc;
  S.tri_ent = tri_ent; S.tri_smooth = tri_smooth;
  S.mtype = mtype; S.albedo = albedo; S.albedo_vertex = albedo_vertex;
  S.emit = emit; S.r0 = r0; S.metal = metalness;
  S.ent_is_light = ent_is_light; S.ent_emission = ent_emission;
  S.ltype = ltype; S.lpos = lpos; S.lrad = lrad; S.lcol = lcol; S.lint = lint;
  S.lent = lent;
  S.sky_type = sky_type;
  S.sky_a = {sky_a[0], sky_a[1], sky_a[2]};
  S.sky_b = {sky_b[0], sky_b[1], sky_b[2]};
  S.sky_w = sky_w; S.sky_h = sky_h; S.sky_img = sky_img;

  Bvh bvh = bvh_build(S);

  Cam C;
  C.loc = {cam17[0], cam17[1], cam17[2]};
  std::memcpy(C.rot, cam17 + 3, 9 * sizeof(double));
  C.f = cam17[12]; C.v = cam17[13]; C.aperture = cam17[14];
  C.sw = cam17[15]; C.sh = cam17[16];
  C.w = width; C.h = height;

  // Dynamic row pull (the reference's pull-based work queue,
  // renderer.rs:166-192, minus the interactivity).
  std::atomic<int> next_row{0};
  auto work = [&]() {
    for (;;) {
      int y = next_row.fetch_add(1);
      if (y >= height) break;
      Rng rng(seed * 0x9e3779b97f4a7c15ull + (uint64_t)y * 0x100000001b3ull + 1);
      for (int x = 0; x < width; x++) {
        V3 acc{0, 0, 0};
        for (int s = 0; s < spp; s++) {
          double jx = rng.uniform(), jy = rng.uniform();
          double lr = std::sqrt(rng.uniform());
          double lt = 2.0 * PI * rng.uniform();
          double weight;
          Ray r = camera_ray(C, x, y, jx, jy, lr * std::cos(lt),
                             lr * std::sin(lt), &weight);
          acc = acc + trace_ray(S, bvh, r, rng, max_bounces) * weight;
        }
        double inv = 1.0 / spp;
        out[3 * (y * width + x) + 0] = acc.x * inv;
        out[3 * (y * width + x) + 1] = acc.y * inv;
        out[3 * (y * width + x) + 2] = acc.z * inv;
      }
    }
  };
  std::vector<std::thread> pool;
  for (int i = 1; i < n_threads; i++) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  return 0;
}

}  // extern "C"
