// The front-to-back stack walk of a box hierarchy, shared by the port's walk
// kernels: K1 and K2 (csrc/sphere_traverse.cu, over the sphere table's
// slot ranges), K3 and K4 (csrc/tri_traverse.cu, over the triangle table's
// rows) and K6 (csrc/packet_bvh.cu, over the BVH table's leaf rows).  Each
// kernel gives it a leaf test; the walk, the box rule, the stack and the
// tie rule are written once, here.
//
// Nodes, two float4 per node, in preorder with the root at 0: [lo.xyz ref |
// hi.xyz aux].  An inner node has ref = its left child and aux = its right
// child; a leaf has ref < 0, and the leaf test reads ref and aux its own
// way (K1/K2: first slot -1 - ref and slot count aux; K3/K4: row -1 - ref and
// its chunk aux; K6: leaf row -1 - ref and triangle count aux).  A leaf's
// box is its primitives' f32 box padded by row_tests.cuh's kBoxPad rule, an
// inner node's the union of its children's, so f32 rounding of a box can
// only keep a leaf, never drop one.  Indices as f32 (exact below 2^24).
//
// The walk, one thread per lane: slab-test the root; at an inner node
// slab-test both children against the running t_best, descend into the
// nearer (the left one on a tie) and push the farther with its entry
// distance; at a leaf run the leaf test; then pop, discarding entries whose
// entry distance is greater than t_best.  A box entered at exactly t_best
// is kept (tmin <= t_best), and so is a popped entry at exactly t_best, so a
// tie in another leaf is always reached.  The closest-hit answer is the
// lexicographic minimum of (t, table position) over the slots that qualify:
// out of table order a strict t < t_best no longer gives the first slot of a
// tie, so a slot replaces the best when t < t_best || (t == t_best && pos <
// pos_best), with pos_best = -1 until a hit: a slot at exactly t_init never
// enters (Best::offer).  The any-hit form ends the walk when the leaf test
// reports an occluder.  A stack entry is pushed once per inner level on the
// current path, so the stack holds at most the tree's depth in inner nodes;
// the packers refuse a tree deeper than kStack = 64.  A lane with o.x > 1e29
// is dead and walks nothing, and so does an any-hit lane seeded with
// t_max == 0 (reported occluded by its collapsed t).

#pragma once

#include <cuda_runtime.h>

#include "row_tests.cuh"

namespace paths_rt {

constexpr int kStack = 64;  // walk stack entries (inner levels of the tree)

// The running answer of a lane: t_best (seeded with t_init or t_max), the
// winning slot's gid and ent, and its table position (-1 for none).
struct Best {
  float t;
  int gid;
  int ent;
  int pos;

  // Offer a qualifying slot at t and table position pos: it wins on a
  // smaller t, or on the same t at an earlier position.
  __device__ __forceinline__ void offer(float t_slot, int pos_slot, int gid_slot,
                                        int ent_slot) {
    if (t_slot < t || (t_slot == t && pos_slot < pos)) {
      t = t_slot;
      gid = gid_slot;
      ent = ent_slot;
      pos = pos_slot;
    }
  }
};

// The slab test of row_tests.cuh::crosses_padded_box on a node's padded
// box (a = [lo.xyz ref], b = [hi.xyz aux]), returning the entry distance
// and keeping a box entered at exactly t_best.  An axis whose slab distance
// is NaN (d == 0 with the origin on a plane of the box) does not constrain.
__device__ __forceinline__ bool enters(const float4 a, const float4 b,
                                       const float o[3], const float inv[3],
                                       float t_best, float& t_entry) {
  const float lo[3] = {a.x, a.y, a.z};
  const float hi[3] = {b.x, b.y, b.z};
  float tmin = -kBig;
  float tmax = kBig;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float t0 = (lo[ax] - o[ax]) * inv[ax];
    const float t1 = (hi[ax] - o[ax]) * inv[ax];
    if (isnan(t0) || isnan(t1)) continue;
    tmin = fmaxf(tmin, fminf(t0, t1));
    tmax = fminf(tmax, fmaxf(t0, t1));
  }
  t_entry = tmin;
  return tmin < tmax && tmin <= t_best && tmax > 0.0f;
}

// Walk the hierarchy for one lane.  leaf(ref, aux, best) tests the leaf's
// slots: the closest-hit form offers each qualifying slot to best (and
// returns false); the any-hit form returns true at the first occluder,
// which ends the walk with best.t = 0.  Returns the lane's answer; best.t
// equals t_seed when no slot qualified.
template <bool AnyHit, class Leaf>
__device__ __forceinline__ Best walk(const float4* __restrict__ nodes,
                                     const float o[3], const float d[3],
                                     float t_seed, const Leaf& leaf) {
  Best best{t_seed, 0, 0, -1};
  if (o[0] > kDead || (AnyHit && t_seed == 0.0f)) return best;
  const float inv[3] = {1.0f / d[0], 1.0f / d[1], 1.0f / d[2]};
  float t_entry;
  const float4 ra = __ldg(nodes);
  const float4 rb = __ldg(nodes + 1);
  if (!enters(ra, rb, o, inv, best.t, t_entry)) return best;
  int ref = static_cast<int>(ra.w);  // the current node, its box entered
  int aux = static_cast<int>(rb.w);
  int stack_ref[kStack];
  int stack_aux[kStack];
  float stack_t[kStack];
  int sp = 0;
  while (true) {
    if (ref >= 0) {  // inner node: both children against t_best
      const float4 la = __ldg(nodes + 2 * ref);
      const float4 lb = __ldg(nodes + 2 * ref + 1);
      const float4 ka = __ldg(nodes + 2 * aux);
      const float4 kb = __ldg(nodes + 2 * aux + 1);
      float tl;
      float tr;
      const bool hl = enters(la, lb, o, inv, best.t, tl);
      const bool hr = enters(ka, kb, o, inv, best.t, tr);
      if (hl && hr) {
        const bool right_first = tr < tl;
        stack_ref[sp] = static_cast<int>(right_first ? la.w : ka.w);
        stack_aux[sp] = static_cast<int>(right_first ? lb.w : kb.w);
        stack_t[sp] = right_first ? tl : tr;
        ++sp;
        ref = static_cast<int>(right_first ? ka.w : la.w);
        aux = static_cast<int>(right_first ? kb.w : lb.w);
        continue;
      }
      if (hl || hr) {
        ref = static_cast<int>(hl ? la.w : ka.w);
        aux = static_cast<int>(hl ? lb.w : kb.w);
        continue;
      }
    } else if (leaf(ref, aux, best)) {  // any-hit: an occluder ends the walk
      best.t = 0.0f;
      return best;
    }
    // Pop the nearest pending subtree that can still hold the answer.
    while (sp > 0 && stack_t[sp - 1] > best.t) --sp;
    if (sp == 0) break;
    --sp;
    ref = stack_ref[sp];
    aux = stack_aux[sp];
  }
  return best;
}

}  // namespace paths_rt
