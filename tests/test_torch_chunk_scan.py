"""Port parity: the flat sphere kernel (K5) and the linear chunk-scan kernels
(K7, K8, K9) of ``paths_tpu_torch/ops/chunk_scan.py`` on the CPU (their plain
versions: flat brute force in the kernels' arithmetic), held against the
reference package's Pallas kernels in interpret mode, and the tables they
read against the reference's packers.

Packing is bit-exact (spheres at 2 and 16 rows per chunk, triangles at 4 and
32).  The reference's scans skip a chunk only when no lane of a 1,024-lane
block crosses its box, so on these lanes every reference answer equals brute
force: t, gid, ent and the occluded flag must be equal exactly.  The lanes
carry exclusions, dead lanes, a band of finite t_init, random excl_ent and
t_max == 0 lanes.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from paths_tpu.bvh.build import build_bvh
from paths_tpu.ops import pallas_traverse as JP

from paths_tpu_torch import native
from paths_tpu_torch.ops import chunk_scan as CS
from paths_tpu_torch.ops import sphere_traverse as ST
from paths_tpu_torch.ops import tri_traverse as TT
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.stress import generate_stress_scene
from tri_walk_cases import sphere_ties_case

torch.set_num_threads(2)

BIG = 3.4e38
N = 1200


def _lanes(rng, targets, lo, hi, n_prims, n_ent):
    """N rays from the box [lo, hi] (widened by half): most aimed at a
    target point, every seventh incoherent; 60 dead lanes, 200 exclusions, a
    band of finite t_init, random excl_ent and t_max (every 17th 0)."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    span = hi - lo
    o = rng.uniform(lo - span / 2, hi + span / 2, (N, 3))
    d = targets[rng.integers(0, len(targets), N)] - o
    d[1::7] = rng.normal(size=d[1::7].shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    o[300:360] = 1e30  # dead lanes
    excl = np.full(N, -1, np.int32)
    excl[:200] = rng.integers(0, n_prims, 200)
    diag = float(np.linalg.norm(span)) * 2
    t_init = np.full(N, BIG, np.float32)
    t_init[500:700] = rng.uniform(0.05, 1.0, 200) * diag
    excl_ent = rng.integers(-1, n_ent, N).astype(np.int32)
    t_max = (rng.uniform(0.0, 1.0, N) * diag).astype(np.float32)
    t_max[::17] = 0.0  # the collapsed-t quirk: reported occluded
    return o, d, excl, t_init, excl_ent, t_max


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_equal(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------- spheres

S = 200
N_SPH_ENT = 9


@pytest.fixture(scope="module")
def spheres():
    rng = np.random.default_rng(21)
    centers = rng.uniform(-2, 2, (S, 3))
    radii = rng.uniform(0.05, 0.3, S)
    ents = (np.arange(S) % N_SPH_ENT).astype(np.int64)
    lanes = _lanes(rng, centers, (-2, -2, -2), (2, 2, 2), S + 5, N_SPH_ENT)
    return (centers, radii, ents), lanes


def _sphere_tables(spheres, rows):
    centers, radii, ents = spheres[0]
    jcs, jn, jorder = JP.pack_spheres_chunked(centers, radii, ent=ents, gid0=5,
                                              rows_per_chunk=rows)
    ps, n, order = ST.pack_spheres_chunked(centers, radii, ent=ents, gid0=5,
                                           rows_per_chunk=rows)
    return (jcs, jn, jorder), (ps, n, order)


@pytest.mark.parametrize("rows", [ST.SPH_ROWS_PER_CHUNK, CS.SPH_ROWS_PER_CHUNK])
def test_sphere_pack_bit_exact(spheres, rows):
    (jcs, jn, jorder), (ps, n, order) = _sphere_tables(spheres, rows)
    assert n == jn == -(-(-(-S // 16)) // rows)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(ps.tris.numpy(), np.asarray(jcs.tris))
    np.testing.assert_array_equal(ps.chunk_meta.numpy(), np.asarray(jcs.chunk_meta))


@pytest.mark.parametrize("rows", [ST.SPH_ROWS_PER_CHUNK, CS.SPH_ROWS_PER_CHUNK])
def test_closest_hit_spheres_matches_reference_kernel(spheres, rows):
    """K8."""
    (jcs, jn, _), (ps, n, _) = _sphere_tables(spheres, rows)
    o, d, excl, t_init, _, _ = spheres[1]
    want = JP.closest_hit_spheres(jcs, jn, *map(jnp.asarray, (o, d, excl, t_init)),
                                  interpret=True)
    got = CS.closest_hit_spheres(ps, n, *_torch(o, d, excl, t_init))
    _assert_equal(got, want)
    t = got[0].numpy()
    assert (t < 1e38).sum() > N // 4  # the rays really hit spheres
    assert (t[300:360] >= 1e38).all()  # dead lanes miss


@pytest.mark.parametrize("rows", [ST.SPH_ROWS_PER_CHUNK, CS.SPH_ROWS_PER_CHUNK])
def test_occludes_spheres_matches_reference_kernel(spheres, rows):
    """K9, sphere form."""
    (jcs, jn, _), (ps, n, _) = _sphere_tables(spheres, rows)
    o, d, excl, _, excl_ent, t_max = spheres[1]
    want = JP.occludes_spheres(jcs, jn, *map(jnp.asarray, (o, d, excl, excl_ent, t_max)),
                               interpret=True)
    got = CS.occludes_spheres(ps, n, *_torch(o, d, excl, excl_ent, t_max))
    _assert_equal(got, want)
    live = o[:, 0] < 1e29
    assert got.numpy()[live & (t_max > 0)].sum() > N // 8
    assert got.numpy()[t_max == 0].all()


# ---------------------------------------------------------------- triangles

T = 300
N_TRI_ENT = 13


@pytest.fixture(scope="module")
def soup():
    """T small triangles in [-1, 1]^3, 24 of them axis-aligned, BVH-ordered
    by the reference's Python builder; lanes aimed inside them."""
    rng = np.random.default_rng(7)
    c = rng.uniform(-1, 1, (T, 3))
    v0, v1, v2 = (c + rng.uniform(-0.15, 0.15, (T, 3)) for _ in range(3))
    v1[:12, 2] = v2[:12, 2] = v0[:12, 2]
    v1[12:24, 1] = v2[12:24, 1] = v0[12:24, 1]
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    flat = build_bvh(np.minimum(np.minimum(v0, v1), v2),
                     np.maximum(np.maximum(v0, v1), v2),
                     leaf_size=JP.PACK_LEAF, use_native=False)
    o = flat.order
    w = rng.dirichlet((1, 1, 1), T)
    inside = w[:, :1] * v0 + w[:, 1:2] * v1 + w[:, 2:] * v2
    mesh = (v0[o], v1[o], v2[o], n[o], (np.arange(T) % N_TRI_ENT).astype(np.int64))
    return flat, mesh, _lanes(rng, inside, (-1, -1, -1), (1, 1, 1), T, N_TRI_ENT)


def _tri_tables(soup, rows):
    flat, (v0, v1, v2, n, ents), _ = soup
    ct, jn = JP.pack_chunked(flat, v0, v1, v2, n, ent=ents, rows_per_chunk=rows)
    pt, n_chunks = TT.pack_chunked(flat, v0, v1, v2, n, ent=ents, rows_per_chunk=rows)
    assert n_chunks == jn
    return ct, pt, n_chunks


@pytest.mark.parametrize("rows", [4, CS.TRI_ROWS_PER_CHUNK])
def test_tri_pack_bit_exact(soup, rows):
    ct, pt, _ = _tri_tables(soup, rows)
    for f in TT.REFERENCE_FIELDS:
        g, w = getattr(pt, f).numpy(), np.asarray(getattr(ct, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    if rows > 15:  # no per-row boxes past 15 rows: meta columns 8+ are zero
        assert not pt.chunk_meta[:, 8:].any()


@pytest.mark.parametrize("rows", [4, CS.TRI_ROWS_PER_CHUNK])
def test_closest_hit_chunked_matches_reference_kernel(soup, rows):
    """K7."""
    ct, pt, nc = _tri_tables(soup, rows)
    o, d, excl, t_init, _, _ = soup[2]
    want = JP.closest_hit_chunked(ct, nc, *map(jnp.asarray, (o, d, excl, t_init)),
                                  interpret=True)
    got = CS.closest_hit_chunked(pt, nc, *_torch(o, d, excl, t_init))
    _assert_equal(got, want)
    t = got[0].numpy()
    assert (t < 1e38).sum() > N // 3
    assert (t[300:360] >= 1e38).all()


@pytest.mark.parametrize("rows", [4, CS.TRI_ROWS_PER_CHUNK])
def test_occludes_chunked_matches_reference_kernel(soup, rows):
    """K9, triangle form (recentred on each chunk)."""
    ct, pt, nc = _tri_tables(soup, rows)
    o, d, excl, _, excl_ent, t_max = soup[2]
    want = JP.occludes_chunked(ct, nc, *map(jnp.asarray, (o, d, excl, excl_ent, t_max)),
                               interpret=True)
    got = CS.occludes_chunked(pt, nc, *_torch(o, d, excl, excl_ent, t_max))
    _assert_equal(got, want)
    live = o[:, 0] < 1e29
    assert got.numpy()[live & (t_max > 0)].sum() > N // 8
    assert got.numpy()[t_max == 0].all()


# ---------------------------------------------------------------- K5

@pytest.fixture(scope="module")
def stress_table():
    """The stress-500 scene's sphere table (32 rows, as the scene build packs
    it) and lanes over the scene's box."""
    static, scene, _ = build_scene(generate_stress_scene(500), device="cpu")
    assert scene.psph.tris.shape[0] == 32 <= CS.SPH_FLAT_MAX_ROWS
    centers = scene.sph_center.numpy().astype(np.float64)
    lanes = _lanes(np.random.default_rng(5), centers, (-50, -50, 0), (50, 50, 100),
                   static.n_spheres, static.n_entities)
    return scene.psph.tris, lanes


# The reference's flat kernel unrolls every slot of its table, and its XLA
# compile time grows faster than linearly with the rows (about 7 s at 4
# rows, 26 s at 8, minutes at 32 on a CPU), so it runs here on 4-row windows
# of the stress-500 table (one compile, jitted), chained as one pass over the
# whole table: each closest-hit window is seeded with the best so far (a
# later window wins only with a strictly smaller t, as a later slot does),
# and the any-hit windows are or-ed.
FLAT_WINDOW = 4
_jax_flat = jax.jit(JP._launch_flat_spheres, static_argnames=("anyhit", "interpret"))


@pytest.mark.parametrize("anyhit", [False, True], ids=["closest", "any"])
def test_flat_spheres_matches_reference_kernel(stress_table, anyhit):
    """K5 (both forms) on the stress-500 table."""
    table, (o, d, excl, t_init, excl_ent, t_max) = stress_table
    seed = t_max if anyhit else t_init
    jo, jd, jex, jee = map(jnp.asarray, (o, d, excl, excl_ent))
    t = seed.copy()
    gid = np.zeros(N, np.int32)
    ent = np.zeros(N, np.int32)
    occ = np.zeros(N, bool)
    for r in range(0, table.shape[0], FLAT_WINDOW):
        window = jnp.asarray(table[r:r + FLAT_WINDOW].numpy())
        if anyhit:
            occ |= np.asarray(_jax_flat(window, jo, jd, jex, jnp.asarray(seed),
                                        anyhit=True, excl_ent=jee, interpret=True))
            continue
        wt, wg, we = (np.asarray(x) for x in _jax_flat(
            window, jo, jd, jex, jnp.asarray(t), anyhit=False, interpret=True))
        better = wt < t
        t, gid, ent = (np.where(better, a, b) for a, b in ((wt, t), (wg, gid), (we, ent)))
    o_, d_, ex_, seed_, ee_ = _torch(o, d, excl, seed, excl_ent)
    got = (CS.flat_occludes(table, o_, d_, ex_, ee_, seed_) if anyhit
           else CS.flat_closest_hit(table, o_, d_, ex_, seed_))
    if anyhit:
        _assert_equal(got, occ)
        assert got.numpy()[(o[:, 0] < 1e29) & (t_max > 0)].sum() > N // 8
    else:
        _assert_equal(got, (np.where(t < seed, t, np.float32(BIG)), gid, ent))
        assert (got[0].numpy() < 1e38).sum() > N // 4


def test_flat_spheres_equals_walk(stress_table):
    """K5 computes K1's and K2's function: the flat wrapper and the walk's
    wrappers agree on the same table (the walk reads its 2-row chunks)."""
    table, (o, d, excl, t_init, excl_ent, t_max) = stress_table
    static, scene, _ = build_scene(generate_stress_scene(500), device="cpu")
    ps, nc = scene.psph, static.sph_chunks
    o_, d_, ex_, ti_, ee_, tm_ = _torch(o, d, excl, t_init, excl_ent, t_max)
    for g, w in zip(CS.flat_closest_hit(table, o_, d_, ex_, ti_),
                    ST.closest_hit_spheres(ps, nc, o_, d_, ex_, ti_)):
        assert torch.equal(g, w)
    assert torch.equal(CS.flat_occludes(table, o_, d_, ex_, ee_, tm_),
                       ST.occludes_spheres(ps, nc, o_, d_, ex_, ee_, tm_))


# K5's design (csrc/flat_spheres.cu): G threads share a lane (the kernel's
# G is FLAT_GROUP; the rule is held here at G = 1, 2, 4 as well), thread j
# tests slots j, j + G, ... of the table padded with empty slots to whole
# batches of FLAT_BATCH a thread, in ascending order, keeping its best by
# strict t < t_best, and the group takes the least (t, slot index) by an
# xor butterfly of shuffles; the any-hit form votes after every batch and
# stops at the first vote that finds an occluder.  Emulated here in numpy,
# in f32, from the plain version's per-slot row test.

def _flat_split(table, o, d, excl, seed, group, excl_ent=None):
    """K5 on these lanes with `group` threads a lane, emulated.  Returns the
    closest-hit (t, gid, ent) and the number of (lane, shuffle step) pairs
    whose two threads held hits at the same t at different slots, or, with
    excl_ent, the occluded flags and the number of lanes whose group
    stopped before its last vote."""
    fields = ST._slot_fields(table)
    ok, t = ST._row_test(fields, o, d, excl, torch.full_like(seed, float("inf")))
    ok, t, seed = ok.numpy(), t.numpy(), seed.numpy()
    gid, ent = fields[4].numpy(), fields[5].numpy()
    pad = -ok.shape[1] % (group * CS.FLAT_BATCH)  # empty slots: never qualify
    ok = np.pad(ok, ((0, 0), (0, pad)))
    t = np.pad(t, ((0, 0), (0, pad)), constant_values=np.inf)
    ent = np.pad(ent, (0, pad), constant_values=-1)
    per = ok.shape[1] // group
    j = np.arange(group)[:, None]
    if excl_ent is not None:
        ok &= (t < seed[:, None]) & (ent[None] != excl_ent.numpy()[:, None])
        found = np.zeros(len(seed), bool)
        early = np.zeros(len(seed), bool)
        for i in range(0, per, CS.FLAT_BATCH):
            ks = (j + group * np.arange(i, i + CS.FLAT_BATCH)).ravel()
            vote = ok[:, ks].any(1) & ~found  # the group's vote, while it runs
            early |= vote & (i + CS.FLAT_BATCH < per)
            found |= vote
        return torch.from_numpy(found | (seed == 0)), int(early.sum())
    best_t = np.repeat(seed[None], group, 0)  # (thread, lane)
    best_pos = np.full(best_t.shape, -1)
    for i in range(per):
        k = (j + group * i)[:, 0]
        take = ok[:, k].T & (t[:, k].T < best_t)
        best_t = np.where(take, t[:, k].T, best_t)
        best_pos = np.where(take, k[:, None], best_pos)
    cross_ties, off = 0, group // 2
    while off:
        t_o, p_o = best_t[j[:, 0] ^ off], best_pos[j[:, 0] ^ off]
        cross_ties += int(((t_o == best_t) & (p_o >= 0) & (best_pos >= 0)
                           & (p_o != best_pos)).sum()) // 2
        take = (t_o < best_t) | ((t_o == best_t) & (p_o < best_pos))
        best_t, best_pos = np.where(take, t_o, best_t), np.where(take, p_o, best_pos)
        off //= 2
    assert (best_t == best_t[0]).all() and (best_pos == best_pos[0]).all()
    hit = best_pos[0] >= 0
    out = (np.where(best_t[0] < seed, best_t[0], np.float32(BIG)).astype(np.float32),
           np.where(hit, gid[best_pos[0]], 0).astype(np.int32),
           np.where(hit, ent[best_pos[0]], 0).astype(np.int32))
    return tuple(torch.from_numpy(a) for a in out), cross_ties


def _pole_pairs():
    """The pole-pair spheres (exact ties between slots) packed as the scene
    build packs them, and their lanes."""
    (c, r, ent), lanes = sphere_ties_case()
    ps, _, _ = ST.pack_spheres_chunked(c, r, ent=ent)
    return ps.tris, lanes


@pytest.mark.parametrize("group", [1, 2, 4, CS.FLAT_GROUP])
@pytest.mark.parametrize("case", ["stress500", "pole_pairs"])
@pytest.mark.parametrize("anyhit", [False, True], ids=["closest", "any"])
def test_flat_split_emulation_equals_plain(stress_table, case, group, anyhit):
    """K5's slot split and group reduction, emulated, equal the plain
    versions bit for bit at each group size, on the stress-500 lanes and
    on the pole pairs with t_init at the exact nearest hit on every third
    lane.  On the pole pairs (group > 1) some shuffle step must have met a
    tie between two threads, decided by slot index; the any-hit groups
    must stop early."""
    table, lanes = stress_table if case == "stress500" else _pole_pairs()
    o, d, excl, t_init, excl_ent, t_max = (torch.from_numpy(np.array(a)) for a in lanes)
    if anyhit:
        got, early = _flat_split(table, o, d, excl, t_max, group, excl_ent)
        want = ST.occludes_spheres_plain(table, o, d, excl, excl_ent, t_max)
        assert torch.equal(got, want)
        assert int(want.sum()) > len(o) // 10 and early > 0
        return
    first = ST.closest_hit_spheres_plain(table, o, d, excl, torch.full_like(t_init, BIG))[0]
    lane = torch.arange(len(o))
    t_init = torch.where((lane % 3 == 0) & (first < BIG), first, t_init)
    got, cross_ties = _flat_split(table, o, d, excl, t_init, group)
    for g, w in zip(got, ST.closest_hit_spheres_plain(table, o, d, excl, t_init)):
        assert torch.equal(g, w)
    assert int((got[0] < BIG).sum()) > len(o) // 8
    if case == "pole_pairs" and group > 1:
        assert cross_ties > 10


def test_launch_checks_reject_bad_inputs(spheres, stress_table):
    """The checks a CUDA launch runs first, all through native.check:
    device, dtype, shape, contiguity and alignment of each tensor, the
    lanes (native.check_rays), the chunk count and the tree (K8's launch of
    K1's walk: sphere_traverse's checks) and the row count (flat)."""
    _, (ps, n, _) = _sphere_tables(spheres, CS.SPH_ROWS_PER_CHUNK)
    o, d, excl, t_init, excl_ent, _ = _torch(*spheres[1])
    seed = [("t_init", t_init, torch.float32)]
    native.check("o", o, torch.float32, (len(o), 3), o.device)  # well-formed: no raise
    with pytest.raises(ValueError, match="o is on meta"):
        native.check("o", o.to("meta"), torch.float32, (len(o), 3), o.device)
    with pytest.raises(TypeError, match="o has dtype torch.float64"):
        native.check("o", o.double(), torch.float32, (len(o), 3), o.device)
    with pytest.raises(ValueError, match=r"o has shape \(\d+, 2\)"):
        native.check("o", o[:, :2], torch.float32, (len(o), 3), o.device)
    with pytest.raises(ValueError, match="o must be contiguous"):
        native.check("o", o.t().contiguous().t(), torch.float32, (len(o), 3), o.device)
    misaligned = torch.zeros(ps.tris.numel() + 1)[1:].view(-1, 128)
    native.check("table", misaligned, torch.float32, misaligned.shape, o.device)
    with pytest.raises(ValueError, match="table must be 16-byte aligned"):
        native.check("table", misaligned, torch.float32, misaligned.shape, o.device,
                     align16=True)
    assert native.check_rays(o, d, excl, seed) == len(o)
    with pytest.raises(TypeError, match="excl_idx"):
        native.check_rays(o, d, excl.long(), seed)
    with pytest.raises(ValueError, match="t_init"):
        native.check_rays(o, d, excl, [("t_init", t_init[1:], torch.float32)])

    assert ST._check_launch(ps, n, o, d, excl, seed) == len(o)  # well-formed
    with pytest.raises(TypeError):
        ST._check_launch(ps, n, o, d, excl.long(), seed)
    with pytest.raises(ValueError):
        ST._check_launch(ps, ps.chunk_meta.shape[0] + 1, o, d, excl, seed)
    with pytest.raises(ValueError, match="aligned"):
        ST._check_launch(ps._replace(tris=misaligned), n, o, d, excl, seed)

    table = stress_table[0]
    ent = [("excl_ent", excl_ent, torch.int32)]
    assert CS._check_flat(table, o, d, excl, seed) == (table.shape[0], len(o))
    CS._check_flat(table, o, d, excl, ent + seed)
    with pytest.raises(ValueError, match="rows"):
        CS._check_flat(torch.zeros(72, 128), o, d, excl, seed)
    with pytest.raises(ValueError, match="aligned"):
        CS._check_flat(torch.zeros(table.numel() + 1)[1:].view(-1, 128), o, d, excl, seed)
    with pytest.raises(TypeError):
        CS._check_flat(table.double(), o, d, excl, seed)
    with pytest.raises(ValueError):
        CS._check_flat(table, o[:, :2], d, excl, seed)
    with pytest.raises(ValueError):
        CS._check_flat(table, o, d, excl, [("t_init", t_init[1:], torch.float32)])
    with pytest.raises(TypeError, match="excl_ent"):
        CS._check_flat(table, o, d, excl, [("excl_ent", excl_ent.long(), torch.int32)])
    with pytest.raises(ValueError, match="device"):
        CS.flat_closest_hit(table.to("meta"), o.to("meta"), d, excl, t_init)
