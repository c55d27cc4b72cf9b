"""The port's CUDA kernels on the card, held against their plain PyTorch
versions.  Every test here needs a CUDA device (marker ``cuda``) and skips
without one.  The file imports no JAX, so it runs on a machine that has only
PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts=""
"""

import numpy as np
import pytest
import torch

from paths_tpu_torch import profiling as P
from paths_tpu_torch.bvh.build import build_bvh
from paths_tpu_torch.ops import chunk_scan as CS
from paths_tpu_torch.ops import packet_traverse as PK
from paths_tpu_torch.ops import sphere_traverse as ST
from paths_tpu_torch.ops import tri_traverse as TT
from paths_tpu_torch.sampling import hashing as H
from tri_walk_cases import full_flat, sphere_ties_case, ties_case

torch.set_num_threads(2)

N = 4096
S = 300


def _added(before: dict) -> dict:
    """The kernels profiling.LAUNCHES counted since it read `before`, by
    key."""
    return {k: v - before[k] for k, v in P.LAUNCHES.items() if v != before[k]}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene_and_rays(dev, seed=0, rows=ST.SPH_ROWS_PER_CHUNK):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (S, 3))
    radii = rng.uniform(0.1, 1.5, S)
    ps, n_chunks, _ = ST.pack_spheres_chunked(
        centers, radii, ent=np.arange(S) % 17, gid0=2, rows_per_chunk=rows,
        device=dev)
    o = rng.uniform(-14, 14, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3))
    d[: N // 2] = rng.uniform(-8, 8, (N // 2, 3)) - o[: N // 2]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o[::23] = 1e30  # dead lanes
    excl = np.where(rng.uniform(size=N) < 0.2, rng.integers(2, S + 2, N), -1)
    t_init = np.where(rng.uniform(size=N) < 0.5, 3.4e38, rng.uniform(0, 30, N))
    excl_ent = rng.integers(-1, 17, N)
    t_max = np.where(rng.uniform(size=N) < 0.05, 0.0, rng.uniform(0, 30, N))
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=dev)
    return ps, n_chunks, (t(o, np.float32), t(d, np.float32),
                          t(excl, np.int32), t(t_init, np.float32),
                          t(excl_ent, np.int32), t(t_max, np.float32))


@pytest.mark.cuda
def test_closest_hit_kernel_matches_plain(dev):
    ps, nc, (o, d, excl, t_init, _, _) = _scene_and_rays(dev)
    before = P.LAUNCHES["sphere_closest_hit"]
    got = ST.closest_hit_spheres(ps, nc, o, d, excl, t_init)
    torch.cuda.synchronize()
    assert P.LAUNCHES["sphere_closest_hit"] == before + 1
    want = ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_init)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] < 3.4e38).sum()) > N // 8


@pytest.mark.cuda
def test_any_hit_kernel_matches_plain(dev):
    ps, nc, (o, d, excl, _, excl_ent, t_max) = _scene_and_rays(dev, seed=1)
    got = ST.occludes_spheres(ps, nc, o, d, excl, excl_ent, t_max)
    want = ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max)
    assert torch.equal(got, want)
    assert int(got.sum()) > N // 8


@pytest.mark.cuda
def test_closest_hit_kernel_holds_exact_ties(dev):
    """K1's walk on spheres that share a pole (tests/tri_walk_cases.py:
    exact t ties between slots of different leaves), with t_init set to
    the exact nearest hit on a third of the lanes: equal to the plain
    version bit for bit."""
    (c, r, ent), lanes = sphere_ties_case()
    ps, nc, _ = ST.pack_spheres_chunked(c, r, ent=ent, device=dev)
    o, d, excl, t_init, _, _ = (torch.as_tensor(np.array(a), device=dev) for a in lanes)
    first = ST.closest_hit_spheres_plain(ps.tris, o, d, excl, torch.full_like(t_init, 3.4e38))[0]
    lane = torch.arange(o.shape[0], device=dev)
    t_init = torch.where((lane % 3 == 0) & (first < 3.4e38), first, t_init).contiguous()
    got = ST.closest_hit_spheres(ps, nc, o, d, excl, t_init)
    for g, w in zip(got, ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_init)):
        assert torch.equal(g, w)
    assert int((got[0] < 3.4e38).sum()) > o.shape[0] // 4


@pytest.mark.cuda
def test_closest_hit_wrapper_refuses_a_table_without_tree(dev):
    ps, nc, (o, d, excl, t_init, _, _) = _scene_and_rays(dev)
    with pytest.raises(ValueError, match="tree"):
        ST.closest_hit_spheres(ps._replace(nodes=None), nc, o, d, excl, t_init)
    with pytest.raises(ValueError):
        ST.closest_hit_spheres(ps._replace(nodes=ps.nodes.cpu()), nc, o, d, excl, t_init)


def _sphere_case(dev, case, seed=6):
    """(PackedSpheres, n_chunks, (o, d, excl, excl_ent, t_max)) of one K2
    case: stress-500's table with incoherent rays from inside its box, or
    the pole pairs (exact ties); t_max at the exact nearest occluder on
    every fifth lane (not occluded), 0 on every seventh (occluded), dead
    lanes in both."""
    if case == "stress500":
        from paths_tpu_torch.scene.stress import generate_stress_scene

        sd = generate_stress_scene(500)
        c = np.array([ob.sphere.center.tolist() for ob in sd.objects])
        r = np.array([ob.sphere.radius for ob in sd.objects])
        ent = np.arange(len(r)) % 7
        rng = np.random.default_rng(seed)
        o = rng.uniform([-50, -50, 0], [50, 50, 100], (N, 3))
        d = rng.normal(size=(N, 3))
        d[: N // 2] = c[rng.integers(0, len(r), N // 2)] - o[: N // 2]
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o[::23] = 1e30
        excl = np.where(rng.uniform(size=N) < 0.2, rng.integers(0, len(r), N), -1)
        excl_ent = rng.integers(-1, 7, N)
        t_max = np.where(rng.uniform(size=N) < 0.5, 3.4e38, rng.uniform(0, 150, N))
        lanes = (o, d, excl, excl_ent, t_max)
    else:
        (c, r, ent), (o, d, excl, _, excl_ent, t_max) = sphere_ties_case()
        lanes = (o, d, excl, excl_ent, t_max)
    ps, nc, _ = ST.pack_spheres_chunked(c, r, ent=ent, device=dev)
    o, d, excl, excl_ent, t_max = (
        torch.as_tensor(np.asarray(a, dt), device=dev)
        for a, dt in zip(lanes, (np.float32, np.float32, np.int32, np.int32, np.float32)))
    fields = ST._slot_fields(ps.tris)
    met, t = ST._row_test(fields, o, d, excl, torch.full_like(t_max, float("inf")))
    met &= fields[5] != excl_ent[:, None]
    near = torch.where(met, t, float("inf")).amin(1)
    lane = torch.arange(o.shape[0], device=dev)
    zero = lane % 7 == 3
    t_max = torch.where((lane % 5 == 1) & (near < float("inf")) & ~zero, near, t_max)
    t_max = torch.where(zero, 0.0, t_max).contiguous()
    return ps, nc, (o, d, excl, excl_ent, t_max)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stress500", "pole_pairs"])
def test_any_hit_kernel_holds_edge_lanes(dev, case):
    """K2's walk on stress-500 and on the pole pairs, with t_max at the
    exact nearest occluder, t_max == 0 and dead lanes: equal to the plain
    version bit for bit."""
    ps, nc, (o, d, excl, excl_ent, t_max) = _sphere_case(dev, case)
    before = P.LAUNCHES["sphere_any_hit"]
    got = ST.occludes_spheres(ps, nc, o, d, excl, excl_ent, t_max)
    torch.cuda.synchronize()
    assert P.LAUNCHES["sphere_any_hit"] == before + 1
    assert torch.equal(got, ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max))
    dead = o[:, 0] > 1e29
    assert got[t_max == 0].all() and not got[dead & (t_max > 0)].any()
    assert int(got.sum()) > o.shape[0] // 8


@pytest.mark.cuda
def test_any_hit_wrapper_refuses_a_table_without_tree(dev):
    ps, nc, (o, d, excl, _, excl_ent, t_max) = _scene_and_rays(dev)
    with pytest.raises(ValueError, match="tree"):
        ST.occludes_spheres(ps._replace(nodes=None), nc, o, d, excl, excl_ent, t_max)
    with pytest.raises(ValueError):
        ST.occludes_spheres(ps._replace(nodes=ps.nodes.cpu()), nc, o, d, excl, excl_ent,
                            t_max)


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(dev):
    ps, nc, (o, d, excl, t_init, _, _) = _scene_and_rays(dev)
    with pytest.raises(TypeError):
        ST.closest_hit_spheres(ps, nc, o, d, excl.long(), t_init)
    with pytest.raises(ValueError):
        ST.closest_hit_spheres(ps, nc, o, d, excl, t_init.cpu())


def _mesh_and_rays(dev, n_tris, seed=0, rows=None, bvh=False):
    """A soup of n_tris small triangles in [-10, 10]^3 packed as the scene
    build packs it (at `rows` rows per chunk, or with bvh=True as the K6
    table, in place of PackedTris and its chunk count), and N rays: half
    aimed at the soup, a twentieth dead, exclusions, finite t_init, excl_ent
    and t_max (some 0)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n_tris, 3))
    v0, v1, v2 = (c + rng.uniform(-0.8, 0.8, (n_tris, 3)) for _ in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    flat = build_bvh(np.minimum(np.minimum(v0, v1), v2),
                     np.maximum(np.maximum(v0, v1), v2))
    v0, v1, v2, n = (a[flat.order] for a in (v0, v1, v2, n))
    if bvh:
        pt, n_chunks = PK.pack_bvh(flat, v0, v1, v2, n, ent=np.arange(n_tris) % 17,
                                   device=dev), None
    elif rows is None:
        pt, n_chunks, _ = TT.pack_tris(flat, v0, v1, v2, n,
                                       ent=np.arange(n_tris) % 17, device=dev)
    else:
        pt, n_chunks = TT.pack_chunked(flat, v0, v1, v2, n,
                                       ent=np.arange(n_tris) % 17, rows_per_chunk=rows)
        pt = TT.PackedTris(*(x.to(dev) for x in pt))
    o = rng.uniform(-14, 14, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3))
    d[: N // 2] = c[rng.integers(0, n_tris, N // 2)] - o[: N // 2]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o[::23] = 1e30  # dead lanes
    excl = np.where(rng.uniform(size=N) < 0.2, rng.integers(0, n_tris, N), -1)
    t_init = np.where(rng.uniform(size=N) < 0.5, 3.4e38, rng.uniform(0, 30, N))
    excl_ent = rng.integers(-1, 17, N)
    t_max = np.where(rng.uniform(size=N) < 0.05, 0.0, rng.uniform(0, 30, N))
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=dev)
    return pt, n_chunks, (t(o, np.float32), t(d, np.float32),
                          t(excl, np.int32), t(t_init, np.float32),
                          t(excl_ent, np.int32), t(t_max, np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris", [3000, 120000])  # 8 and 20 rows per chunk
def test_tri_closest_hit_kernel_matches_plain(dev, n_tris):
    pt, nc, (o, d, excl, t_init, _, _) = _mesh_and_rays(dev, n_tris)
    before = P.LAUNCHES["tri_closest_hit"]
    got = TT.closest_hit_tris(pt, nc, o, d, excl, t_init)
    torch.cuda.synchronize()
    assert P.LAUNCHES["tri_closest_hit"] == before + 1
    want = TT.closest_hit_tris_plain(pt, nc, o, d, excl, t_init)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] < 3.4e38).sum()) > N // 8


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris", [3000, 120000])
def test_tri_any_hit_kernel_matches_plain(dev, n_tris):
    pt, nc, (o, d, excl, _, excl_ent, t_max) = _mesh_and_rays(dev, n_tris, seed=1)
    got = TT.occludes_tris(pt, nc, o, d, excl, excl_ent, t_max)
    want = TT.occludes_tris_plain(pt, nc, o, d, excl, excl_ent, t_max)
    assert torch.equal(got, want)
    assert int(got.sum()) > N // 8


@pytest.mark.cuda
def test_tri_wrapper_raises_instead_of_falling_back(dev):
    pt, nc, (o, d, excl, t_init, _, _) = _mesh_and_rays(dev, 3000)
    with pytest.raises(TypeError):
        TT.closest_hit_tris(pt, nc, o, d, excl.long(), t_init)
    with pytest.raises(ValueError):
        TT.closest_hit_tris(pt, nc, o, d, excl, t_init.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [TT.ROWS_PER_CHUNK, TT.ROWS_PER_CHUNK_LARGE])
def test_tri_kernels_hold_exact_ties_and_bounds(dev, rows):
    """The walk kernels on a table of duplicated triangles whose ties are
    exact (tests/tri_walk_cases.py), with t_init and t_max set to exact hit
    distances on some lanes: equal to the plain versions bit for bit."""
    (flat, v0, v1, v2, n, ent), lanes = ties_case(rows, 13)
    pt, nc = TT.pack_chunked(flat, v0, v1, v2, n, ent=ent, rows_per_chunk=rows)
    pt = TT.PackedTris(*(x.to(dev) for x in pt))
    o, d, excl, t_init, excl_ent, t_max = (torch.as_tensor(np.array(a), device=dev)
                                           for a in lanes)
    first = TT.closest_hit_tris_plain(pt, nc, o, d, excl, torch.full_like(t_init, 3.4e38))[0]
    lane = torch.arange(o.shape[0], device=dev)
    t_init = torch.where((lane % 3 == 0) & (first < 3.4e38), first, t_init).contiguous()
    t_max = torch.where((lane % 3 == 1) & (first < 3.4e38), first, t_max).contiguous()
    got = TT.closest_hit_tris(pt, nc, o, d, excl, t_init)
    for g, w in zip(got, TT.closest_hit_tris_plain(pt, nc, o, d, excl, t_init)):
        assert torch.equal(g, w)
    occ = TT.occludes_tris(pt, nc, o, d, excl, excl_ent, t_max)
    assert torch.equal(occ, TT.occludes_tris_plain(pt, nc, o, d, excl, excl_ent, t_max))
    assert int((got[0] < 3.4e38).sum()) > o.shape[0] // 4 and int(occ.sum()) > 0


@pytest.mark.cuda
def test_tri_wrapper_refuses_a_table_without_hierarchy(dev):
    pt, nc, (o, d, excl, t_init, excl_ent, t_max) = _mesh_and_rays(dev, 3000)
    with pytest.raises(ValueError, match="hierarchy"):
        TT.closest_hit_tris(pt._replace(nodes=None), nc, o, d, excl, t_init)
    with pytest.raises(ValueError):
        TT.occludes_tris(pt._replace(nodes=pt.nodes.cpu()), nc, o, d, excl, excl_ent, t_max)


# ---- K5 (flat spheres), K7, K8 and K9 (walks of their own tables) ----

@pytest.mark.cuda
@pytest.mark.parametrize("anyhit", [False, True], ids=["closest", "any"])
def test_flat_kernel_matches_plain(dev, anyhit):
    ps, _, (o, d, excl, t_init, excl_ent, t_max) = _scene_and_rays(dev, seed=2)
    assert ps.tris.shape[0] <= CS.SPH_FLAT_MAX_ROWS
    name = "flat_sphere_any_hit" if anyhit else "flat_sphere_closest_hit"
    before = P.LAUNCHES[name]
    if anyhit:
        got = CS.flat_occludes(ps.tris, o, d, excl, excl_ent, t_max)
        want = ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max)
    else:
        got = CS.flat_closest_hit(ps.tris, o, d, excl, t_init)
        want = ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_init)
    torch.cuda.synchronize()
    assert P.LAUNCHES[name] == before + 1
    if anyhit:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 65537])
def test_flat_kernel_at_ragged_lane_counts(dev, n):
    """K5, both forms, at lane counts that are not a multiple of the group
    or of the block: equal to the plain versions bit for bit."""
    ps, _, lanes = _sphere_case(dev, "stress500")
    reps = -(-n // N)
    o, d, excl, excl_ent, t_max = (torch.cat([x] * reps)[:n].contiguous() for x in lanes)
    t_init = torch.where(t_max == 0, 3.4e38, t_max).contiguous()
    got = CS.flat_closest_hit(ps.tris, o, d, excl, t_init)
    for g, w in zip(got, ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_init)):
        assert torch.equal(g, w)
    occ = CS.flat_occludes(ps.tris, o, d, excl, excl_ent, t_max)
    assert torch.equal(occ, ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max))


@pytest.mark.cuda
def test_flat_kernel_holds_exact_ties(dev):
    """K5 on the pole pairs (exact t ties between slots, so between the
    threads of a group), with t_init at the exact nearest hit on a third of
    the lanes: equal to the plain versions bit for bit."""
    ps, _, (o, d, excl, excl_ent, t_max) = _sphere_case(dev, "pole_pairs")
    first = ST.closest_hit_spheres_plain(ps.tris, o, d, excl, torch.full_like(t_max, 3.4e38))[0]
    lane = torch.arange(o.shape[0], device=dev)
    t_init = torch.where((lane % 3 == 0) & (first < 3.4e38), first, 3.4e38).contiguous()
    got = CS.flat_closest_hit(ps.tris, o, d, excl, t_init)
    for g, w in zip(got, ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_init)):
        assert torch.equal(g, w)
    occ = CS.flat_occludes(ps.tris, o, d, excl, excl_ent, t_max)
    assert torch.equal(occ, ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max))
    assert int((got[0] < 3.4e38).sum()) > o.shape[0] // 4


@pytest.mark.cuda
def test_scan_sphere_kernels_match_plain(dev):
    """K8 and K9's sphere form on a 16-row table: equal to the plain
    versions; a K8 call adds one to chunk_scan's count and none to
    sphere_traverse's, although it launches K1's walk."""
    ps, nc, (o, d, excl, t_init, excl_ent, t_max) = _scene_and_rays(
        dev, seed=3, rows=CS.SPH_ROWS_PER_CHUNK)
    before = dict(P.LAUNCHES)
    got = CS.closest_hit_spheres(ps, nc, o, d, excl, t_init)
    torch.cuda.synchronize()
    assert _added(before) == {"scan_sphere_closest_hit": 1}
    for g, w in zip(got, ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_init)):
        assert torch.equal(g, w)
    occ = CS.occludes_spheres(ps, nc, o, d, excl, excl_ent, t_max)
    assert torch.equal(occ, ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max))
    assert int((got[0] < 3.4e38).sum()) > N // 8 and int(occ.sum()) > N // 8


@pytest.mark.cuda
def test_any_hit_environment_query_matches_plain(dev):
    """The environment NEE query's arguments: t_max BIG on every lane and no
    entity excluded (excl_ent -1).  K2 and K9's sphere form equal the plain
    versions, and a lane is occluded iff its ray meets any sphere other than
    its own."""
    for rows in (ST.SPH_ROWS_PER_CHUNK, CS.SPH_ROWS_PER_CHUNK):
        ps, nc, (o, d, excl, _, _, _) = _scene_and_rays(dev, seed=6, rows=rows)
        t_max = torch.full((N,), 3.4e38, device=dev)
        excl_ent = torch.full((N,), -1, dtype=torch.int32, device=dev)
        want = ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max)
        assert torch.equal(ST.occludes_spheres(ps, nc, o, d, excl, excl_ent, t_max), want)
        assert torch.equal(CS.occludes_spheres(ps, nc, o, d, excl, excl_ent, t_max), want)
        hit = ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_max)[0] < 3.4e38
        assert torch.equal(want, hit) and int(want.sum()) > N // 8


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris", [3000, 120000])
def test_scan_tri_kernels_match_plain(dev, n_tris):
    pt, nc, (o, d, excl, t_init, excl_ent, t_max) = _mesh_and_rays(
        dev, n_tris, seed=4, rows=CS.TRI_ROWS_PER_CHUNK)
    before = P.LAUNCHES["scan_tri_closest_hit"]
    got = CS.closest_hit_chunked(pt, nc, o, d, excl, t_init)
    torch.cuda.synchronize()
    assert P.LAUNCHES["scan_tri_closest_hit"] == before + 1
    for g, w in zip(got, TT.closest_hit_tris_plain(pt, nc, o, d, excl, t_init)):
        assert torch.equal(g, w)
    occ = CS.occludes_chunked(pt, nc, o, d, excl, excl_ent, t_max)
    assert torch.equal(occ, TT.occludes_tris_plain(pt, nc, o, d, excl, excl_ent, t_max))
    assert int((got[0] < 3.4e38).sum()) > N // 8 and int(occ.sum()) > N // 8


@pytest.mark.cuda
def test_new_wrappers_raise_instead_of_falling_back(dev):
    ps, nc, (o, d, excl, t_init, excl_ent, t_max) = _scene_and_rays(dev)
    with pytest.raises(TypeError):
        CS.flat_closest_hit(ps.tris, o, d, excl.long(), t_init)
    with pytest.raises(ValueError):
        CS.flat_closest_hit(ps.tris, o, d, excl, t_init.cpu())
    with pytest.raises(ValueError, match="rows"):
        CS.flat_closest_hit(torch.zeros(72, 128, device=dev), o, d, excl, t_init)
    with pytest.raises(ValueError):
        CS.flat_closest_hit(ps.tris, o[:, :2].contiguous(), d, excl, t_init)
    with pytest.raises(TypeError):
        CS.flat_occludes(ps.tris, o, d, excl, excl_ent.float(), t_max)
    with pytest.raises(TypeError):
        CS.occludes_spheres(ps, nc, o, d, excl, excl_ent.float(), t_max)
    with pytest.raises(ValueError):
        CS.closest_hit_spheres(ps, nc, o, d.cpu(), excl, t_init)
    with pytest.raises(ValueError):
        CS.closest_hit_spheres(ps, nc, o, d, excl[1:], t_init)
    pt, tc, (o, d, excl, t_init, excl_ent, t_max) = _mesh_and_rays(
        dev, 3000, rows=CS.TRI_ROWS_PER_CHUNK)
    with pytest.raises(TypeError):
        CS.closest_hit_chunked(pt, tc, o, d, excl.long(), t_init)
    with pytest.raises(ValueError):
        CS.occludes_chunked(pt, tc, o, d, excl, excl_ent, t_max.cpu())
    with pytest.raises(ValueError):
        CS.occludes_chunked(pt, pt.chunk_meta.shape[0] + 1, o, d, excl, excl_ent, t_max)


def _repeat(lanes, n):
    """The first n lanes of the case's lanes repeated end to end."""
    reps = -(-n // lanes[0].shape[0])
    return [torch.cat([x] * reps)[:n].contiguous() for x in lanes]


def _exact_seeds(first, t_init, t_max):
    """t_init at the lane's exact nearest hit on every third lane (the hit
    must not count) and t_max at it on the next (not occluded by it)."""
    lane = torch.arange(first.shape[0], device=first.device)
    hit = first < 3.4e38
    t_init = torch.where((lane % 3 == 0) & hit, first, t_init).contiguous()
    t_max = torch.where((lane % 3 == 1) & hit, first, t_max).contiguous()
    return t_init, t_max


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 65537])
def test_chunked_tri_walks_hold_exact_ties(dev, n):
    """K7 and K9's triangle form on the table of duplicated triangles whose
    ties are exact, packed at K7's 32 rows a chunk, at n lanes, with t_init
    and t_max at exact hit distances: equal to the plain versions bit for
    bit, each launch counted once under its scan key and not as K3/K4."""
    (flat, v0, v1, v2, nrm, ent), lanes = ties_case(CS.TRI_ROWS_PER_CHUNK, 13)
    pt, nc = TT.pack_chunked(flat, v0, v1, v2, nrm, ent=ent,
                             rows_per_chunk=CS.TRI_ROWS_PER_CHUNK)
    pt = TT.PackedTris(*(x.to(dev) for x in pt))
    o, d, excl, t_init, excl_ent, t_max = _repeat(
        [torch.as_tensor(np.array(a), device=dev) for a in lanes], n)
    first = TT.closest_hit_tris_plain(pt, nc, o, d, excl, torch.full_like(t_init, 3.4e38))[0]
    t_init, t_max = _exact_seeds(first, t_init, t_max)
    before = dict(P.LAUNCHES)
    got = CS.closest_hit_chunked(pt, nc, o, d, excl, t_init)
    for g, w in zip(got, TT.closest_hit_tris_plain(pt, nc, o, d, excl, t_init)):
        assert torch.equal(g, w)
    occ = CS.occludes_chunked(pt, nc, o, d, excl, excl_ent, t_max)
    assert torch.equal(occ, TT.occludes_tris_plain(pt, nc, o, d, excl, excl_ent, t_max))
    torch.cuda.synchronize()
    assert _added(before) == {"scan_tri_closest_hit": 1, "scan_tri_any_hit": 1}
    if n > 1000:
        assert int((got[0] < 3.4e38).sum()) > n // 4 and int(occ.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 65537])
def test_chunked_sphere_walk_holds_exact_ties(dev, n):
    """K8 and K9's sphere form on the pole pairs packed at 16 rows a chunk,
    at n lanes, with t_init and t_max at the exact nearest hit on some lanes
    and t_max 0 on others: equal to the plain versions bit for bit (K8's
    exact ties go to the first slot in table order), each launch counted
    once under its scan key and not as K1/K2."""
    (c, r, ent), lanes = sphere_ties_case()
    ps, nc, _ = ST.pack_spheres_chunked(c, r, ent=ent, rows_per_chunk=CS.SPH_ROWS_PER_CHUNK,
                                        device=dev)
    o, d, excl, t_init, excl_ent, t_max = _repeat(
        [torch.as_tensor(np.array(a), device=dev) for a in lanes], n)
    first = ST.closest_hit_spheres_plain(ps.tris, o, d, excl, torch.full_like(t_init, 3.4e38))[0]
    t_init, t_max = _exact_seeds(first, t_init, t_max)
    before = dict(P.LAUNCHES)
    got = CS.closest_hit_spheres(ps, nc, o, d, excl, t_init)
    for g, w in zip(got, ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_init)):
        assert torch.equal(g, w)
    occ = CS.occludes_spheres(ps, nc, o, d, excl, excl_ent, t_max)
    assert torch.equal(occ, ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max))
    torch.cuda.synchronize()
    assert _added(before) == {"scan_sphere_closest_hit": 1, "scan_sphere_any_hit": 1}
    if n > 1000:
        assert int(occ.sum()) > n // 8 and int((~occ).sum()) > n // 8
        assert int((got[0] < 3.4e38).sum()) > n // 8


@pytest.mark.cuda
def test_chunked_walks_on_one_row_tables(dev):
    """K7, K8 and K9 on the smallest tables the packers make: five
    triangles in one row (a one-node hierarchy) and one sphere: equal to the
    plain versions bit for bit."""
    rng = np.random.default_rng(9)
    c = rng.uniform(-1, 1, (5, 3))
    v0, v1, v2 = (c + rng.uniform(-0.5, 0.5, (5, 3)) for _ in range(3))
    nrm = np.cross(v1 - v0, v2 - v0)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    flat = build_bvh(np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2))
    v0, v1, v2, nrm = (a[flat.order] for a in (v0, v1, v2, nrm))
    pt, nc = TT.pack_chunked(flat, v0, v1, v2, nrm, ent=np.arange(5) % 2,
                             rows_per_chunk=CS.TRI_ROWS_PER_CHUNK)
    assert pt.nodes.shape[0] == 1
    pt = TT.PackedTris(*(x.to(dev) for x in pt))
    ps, sc, _ = ST.pack_spheres_chunked(np.zeros((1, 3)), np.ones(1),
                                        rows_per_chunk=CS.SPH_ROWS_PER_CHUNK, device=dev)
    m = 512
    o = torch.as_tensor(rng.uniform(-3, 3, (m, 3)), dtype=torch.float32, device=dev)
    d = -o + torch.as_tensor(rng.uniform(-0.5, 0.5, (m, 3)), dtype=torch.float32, device=dev)
    d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    excl = torch.as_tensor(rng.integers(-1, 5, m), dtype=torch.int32, device=dev)
    excl_ent = torch.as_tensor(rng.integers(-1, 2, m), dtype=torch.int32, device=dev)
    t_init = torch.full((m,), 3.4e38, device=dev)
    t_max = torch.as_tensor(rng.uniform(0, 6, m), dtype=torch.float32, device=dev)
    got = CS.closest_hit_chunked(pt, nc, o, d, excl, t_init)
    for g, w in zip(got, TT.closest_hit_tris_plain(pt, nc, o, d, excl, t_init)):
        assert torch.equal(g, w)
    assert torch.equal(CS.occludes_chunked(pt, nc, o, d, excl, excl_ent, t_max),
                       TT.occludes_tris_plain(pt, nc, o, d, excl, excl_ent, t_max))
    occ = CS.occludes_spheres(ps, sc, o, d, excl, excl_ent, t_max)
    assert torch.equal(occ, ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max))
    s_excl = torch.where(excl > 0, -1, excl).contiguous()  # the sphere's id is 0
    sph = CS.closest_hit_spheres(ps, sc, o, d, s_excl, t_init)
    for g, w in zip(sph, ST.closest_hit_spheres_plain(ps.tris, o, d, s_excl, t_init)):
        assert torch.equal(g, w)
    assert int((got[0] < 3.4e38).sum()) > 0 and int(occ.sum()) > 0
    assert int((sph[0] < 3.4e38).sum()) > 0


@pytest.mark.cuda
def test_chunked_wrappers_refuse_a_table_without_hierarchy(dev):
    """K7, K8 and K9 walk their tables' hierarchies: a table without one, or
    with it on another device, is refused, never scanned nor run plain."""
    pt, nc, (o, d, excl, t_init, excl_ent, t_max) = _mesh_and_rays(
        dev, 3000, rows=CS.TRI_ROWS_PER_CHUNK)
    before = dict(P.LAUNCHES)
    with pytest.raises(ValueError, match="hierarchy"):
        CS.closest_hit_chunked(pt._replace(nodes=None), nc, o, d, excl, t_init)
    with pytest.raises(ValueError, match="hierarchy"):
        CS.occludes_chunked(pt._replace(nodes=None), nc, o, d, excl, excl_ent, t_max)
    with pytest.raises(ValueError):
        CS.closest_hit_chunked(pt._replace(nodes=pt.nodes.cpu()), nc, o, d, excl, t_init)
    ps, sc, (o, d, excl, t_init, excl_ent, t_max) = _scene_and_rays(
        dev, rows=CS.SPH_ROWS_PER_CHUNK)
    with pytest.raises(ValueError, match="tree"):
        CS.closest_hit_spheres(ps._replace(nodes=None), sc, o, d, excl, t_init)
    with pytest.raises(ValueError):
        CS.closest_hit_spheres(ps._replace(nodes=ps.nodes.cpu()), sc, o, d, excl, t_init)
    with pytest.raises(ValueError, match="tree"):
        CS.occludes_spheres(ps._replace(nodes=None), sc, o, d, excl, excl_ent, t_max)
    with pytest.raises(ValueError):
        CS.occludes_spheres(ps._replace(nodes=ps.nodes.cpu()), sc, o, d, excl, excl_ent, t_max)
    assert P.LAUNCHES == before


# ---- K6 (the skip-link BVH walk) ----

@pytest.mark.cuda
@pytest.mark.parametrize("n_tris", [3000, 120000])
def test_packet_kernel_matches_plain(dev, n_tris):
    pt, _, (o, d, excl, t_init, _, _) = _mesh_and_rays(dev, n_tris, seed=5, bvh=True)
    d[:64, 0] = 0.0  # a zero direction component
    before = P.LAUNCHES["packet_closest_hit"]
    got = PK.closest_hit_packet(pt, o, d, excl, t_init)
    torch.cuda.synchronize()
    assert P.LAUNCHES["packet_closest_hit"] == before + 1
    for g, w in zip(got, PK.closest_hit_packet_plain(pt, o, d, excl, t_init)):
        assert torch.equal(g, w)
    assert int((got[0] < 3.4e38).sum()) > N // 8


@pytest.mark.cuda
def test_packet_wrapper_raises_instead_of_falling_back(dev):
    pt, _, (o, d, excl, t_init, _, _) = _mesh_and_rays(dev, 3000, bvh=True)
    with pytest.raises(TypeError):
        PK.closest_hit_packet(pt, o, d, excl.long(), t_init)
    with pytest.raises(TypeError):
        PK.closest_hit_packet(pt, o.double(), d, excl, t_init)
    with pytest.raises(ValueError):
        PK.closest_hit_packet(pt, o, d, excl, t_init.cpu())
    with pytest.raises(ValueError):
        PK.closest_hit_packet(pt, o[:, :2].contiguous(), d, excl, t_init)
    with pytest.raises(ValueError):
        PK.closest_hit_packet(pt, o, d.t().contiguous().t(), excl, t_init)
    with pytest.raises(ValueError):
        PK.closest_hit_packet(pt._replace(tree=pt.tree.cpu()), o, d, excl, t_init)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [TT.ROWS_PER_CHUNK, TT.ROWS_PER_CHUNK_LARGE])
def test_packet_kernel_holds_exact_ties(dev, rows):
    """K6's walk on the table of duplicated triangles whose ties are exact
    (tests/tri_walk_cases.py, one leaf a row), with t_init set to the exact
    nearest hit on a third of the lanes: equal to the plain version (the
    skip-link walk) bit for bit."""
    (flat, v0, v1, v2, n, ent), lanes = ties_case(rows, 13)
    pt = PK.pack_bvh(full_flat(flat, v0, v1, v2), v0, v1, v2, n, ent=ent, device=dev)
    o, d, excl, t_init, _, _ = (torch.as_tensor(np.array(a), device=dev) for a in lanes)
    first = PK.closest_hit_packet_plain(pt, o, d, excl, torch.full_like(t_init, 3.4e38))[0]
    lane = torch.arange(o.shape[0], device=dev)
    t_init = torch.where((lane % 3 == 0) & (first < 3.4e38), first, t_init).contiguous()
    got = PK.closest_hit_packet(pt, o, d, excl, t_init)
    for g, w in zip(got, PK.closest_hit_packet_plain(pt, o, d, excl, t_init)):
        assert torch.equal(g, w)
    assert int((got[0] < 3.4e38).sum()) > o.shape[0] // 4


# ---------------------------------------------------------------------------
# The lane RNG (ops/lane_rng.py, csrc/lane_rng.cu): one launch a draw, the
# plain hash's words bit for bit, against the plain functions on the CPU and
# the same eager ops on the card.

_EDGE_WORDS = [0, 1, 2**31, 2**32 - 1, 15, 16, 17, 31, 32]


def _rng_keys(dev, n=N, seed=0):
    """(pixel ids, sample ids) as int64 lane tensors on dev and on the CPU: random u32 words with the edge words in both, sample ids on both
    sides of a CMJ batch boundary (15, 16)."""
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, 2**32, n, dtype=np.int64)
    sid = rng.integers(0, 2**32, n, dtype=np.int64)
    k = len(_EDGE_WORDS)
    pix[:k] = _EDGE_WORDS
    sid[k:2 * k] = _EDGE_WORDS
    sid[2 * k:2 * k + 64] = rng.integers(0, 40, 64)
    cpu = torch.as_tensor(pix), torch.as_tensor(sid)
    return tuple(x.to(dev) for x in cpu), cpu


def _same_bits(got, want, name):
    got, want = got.cpu(), want.cpu()
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    assert bad == 0, f"{name}: {bad} of {got.numel()} lanes differ"


@pytest.mark.cuda
@pytest.mark.parametrize("bounce_kind", ["scalar", "lanes"])
def test_lane_rng_uniform_kernel_matches_plain(dev, bounce_kind):
    from paths_tpu_torch.ops import lane_rng as RNG

    (pix, sid), (pix_c, sid_c) = _rng_keys(dev)
    if bounce_kind == "scalar":
        bounces = [(b, b) for b in (0, 3, 10, 2**32 - 1)]
    else:
        b = np.random.default_rng(1).integers(0, 12, N)
        b[:3] = [2**31, 2**32 - 1, 429496729]  # ctr wraps mod 2^32
        b_c = torch.as_tensor(b)
        bounces = [(b_c.to(dev), b_c)]
    for seed in (0, 2**31, 2**32 - 1, 7300000001):
        for bounce, bounce_c in bounces:
            for dim in range(10):
                got = RNG.shading_uniform(seed, pix, sid, bounce, dim)
                assert got.device == pix.device and got.dtype == torch.float32
                want = RNG.shading_uniform_plain(seed, pix_c, sid_c, bounce_c, dim)
                _same_bits(got, want, f"uniform dim {dim} vs the CPU")
                eager = RNG.shading_uniform_plain(seed, pix, sid, bounce, dim)
                _same_bits(got, eager, f"uniform dim {dim} vs the card's eager ops")
                # The word: the top 24 bits of the hash, exact in f32.
                words = H.hash_u32(seed, pix_c, sid_c, H.as_u32(
                    (H.mul32(H.as_u32(bounce_c), 10) + dim) & H.MASK32)) >> 8
                assert torch.equal((got.cpu().double() * 2**24).to(torch.int64), words)


@pytest.mark.cuda
def test_lane_rng_camera_kernel_matches_plain(dev):
    from paths_tpu_torch import render as R
    from paths_tpu_torch.ops import lane_rng as RNG

    (pix, sid), (pix_c, sid_c) = _rng_keys(dev)
    args = (R.PAT_M, R.PAT_N, R._SQUARE_TAG, R._DISK_TAG)
    for seed in (0, 2**31, 2**32 - 1, 7300000001):
        got = RNG.camera_cmj(seed, pix, sid, *args)
        want = RNG.camera_cmj_plain(seed, pix_c, sid_c, *args)
        eager = RNG.camera_cmj_plain(seed, pix, sid, *args)
        names = ("square x", "square y", "disk x", "disk y")
        for name, g, w, e in zip(names, (*got[0], *got[1]), (*want[0], *want[1]),
                                 (*eager[0], *eager[1])):
            _same_bits(g, w, f"{name} vs the CPU")
            _same_bits(g, e, f"{name} vs the card's eager ops")


@pytest.mark.cuda
def test_lane_rng_counts_one_launch_a_draw(dev):
    from paths_tpu_torch import camera as C
    from paths_tpu_torch import integrator as I
    from paths_tpu_torch import render as R
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_stress_scene

    (pix, sid), _ = _rng_keys(dev)
    P.reset_launches()
    u = I.lane_uniforms(5, pix, sid)
    u(0, H.DIM_LOBE)
    u(torch.zeros_like(pix), H.DIM_RR)
    assert P.LAUNCHES["rng_uniform"] == 2 and sum(P.LAUNCHES.values()) == 2
    _, _, cam = build_scene(generate_stress_scene(8, seed=1), device=dev)
    cam = C.resize(cam, 64, 64)
    R.gen_camera_rays(cam, (pix % 64).to(torch.int32), (pix // 64 % 64).to(torch.int32),
                      pix, sid, 5)
    assert P.LAUNCHES["rng_camera"] == 1 and sum(P.LAUNCHES.values()) == 3


@pytest.mark.cuda
def test_lane_rng_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from paths_tpu_torch.ops import lane_rng as RNG

    (pix, sid), (pix_c, _) = _rng_keys(dev)
    with pytest.raises(TypeError):
        RNG.shading_uniform(torch.tensor(3, dtype=torch.int32, device=dev), pix, sid, 0, 0)
    with pytest.raises(ValueError):
        RNG.shading_uniform(torch.tensor(3), pix, sid, 0, 0)
    with pytest.raises(TypeError):
        RNG.shading_uniform(3, pix, sid.to(torch.float32), 0, 0)
    with pytest.raises(TypeError):
        RNG.shading_uniform(3, pix, sid, sid.to(torch.int32), 0)
    with pytest.raises(TypeError):
        RNG.camera_cmj(3, pix.to(torch.int32), sid, 4, 4, 1, 2)
    with pytest.raises(ValueError):
        RNG.shading_uniform(3, pix, pix_c, 0, 0)
    with pytest.raises(ValueError):
        RNG.shading_uniform(3, pix, sid[:-1], 0, 0)
    with pytest.raises(ValueError):
        RNG.camera_cmj(3, pix, sid, 3, 4, 1, 2)


@pytest.mark.cuda
def test_render_samples_with_the_lane_rng_kernel_equals_the_eager_hash(dev, monkeypatch):
    """A stress-500 tile's accumulated radiance at a fixed seed, byte for
    byte the same with the kernel as with the eager hash and CMJ on the
    card."""
    from paths_tpu_torch import camera as C
    from paths_tpu_torch import render as R
    from paths_tpu_torch import step_graphs as SG
    from paths_tpu_torch.ops import lane_rng as RNG
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_stress_scene

    static, scene, cam = build_scene(generate_stress_scene(500), device=dev)
    cam = C.resize(cam, 180, 120)
    pix = torch.as_tensor(R.tiled_pixel_order(180, 120).astype(np.int64), device=dev)
    px, py = (pix % 180).to(torch.int32), (pix // 180).to(torch.int32)

    def render():
        SG.clear()  # the step's graphs are captured with the RNG of the moment
        return R.render_samples(static, scene, cam, px, py, pix, 14, 4, 7300000001)

    P.reset_launches()
    kernel = render()
    assert P.LAUNCHES["rng_uniform"] > 0 and P.LAUNCHES["rng_camera"] > 0
    monkeypatch.setattr(RNG, "shading_uniform", RNG.shading_uniform_plain)
    monkeypatch.setattr(RNG, "camera_cmj", RNG.camera_cmj_plain)
    P.reset_launches()
    eager = render()
    assert P.LAUNCHES["rng_uniform"] == 0 and P.LAUNCHES["rng_camera"] == 0
    assert kernel.cpu().numpy().tobytes() == eager.cpu().numpy().tobytes()


# ---------------------------------------------------------------------------
# The double-single sphere test (ops/sphere_ds.py, csrc/sphere_ds.cu): one
# launch a query, the eager test's t, hits, indices and flags bit for bit,
# on random, dead (NaN discriminant), inside and grazing lanes, with and
# without the centres' low parts, ties between two equal spheres, excluded
# spheres and entities (sphere_ds_cases.py).

DS_KEYS = ("sphere_ds_closest", "sphere_ds_any_hit", "sphere_ds_intersect")
DS_W, DS_H = 48, 32  # the doom-like tile


def _ds_case(dev, n, with_lo=True, seed=0):
    from sphere_ds_cases import make_case

    return make_case(n, n_lanes=N, seed=seed, with_lo=with_lo).to(dev)


def _ds_added(before):
    return {k: v for k, v in _added(before).items() if k in DS_KEYS}


@pytest.mark.cuda
@pytest.mark.parametrize("with_lo", [True, False])
@pytest.mark.parametrize("n", [1, 2, 7, 32])
def test_sphere_ds_closest_kernel_matches_plain(dev, n, with_lo):
    from paths_tpu_torch.ops import sphere_ds as SD
    from sphere_ds_cases import same

    c = _ds_case(dev, n, with_lo, seed=n)
    for lo, hi in sorted({(0, n), (min(1, n), n), (n // 2, n)}):
        args = (c.o, c.d, c.center, c.radius, c.center_lo, lo, hi, c.excl, c.excl_idx,
                c.t_best, c.i_best)
        before = dict(P.LAUNCHES)
        got = SD.closest(*args)
        assert _ds_added(before) == ({"sphere_ds_closest": 1} if hi > lo else {})
        want = SD.closest_plain(*args)
        assert same(got[0], want[0]), f"t differs on {int((got[0] != want[0]).sum())} lanes"
        assert same(got[1], want[1]), f"index differs on {int((got[1] != want[1]).sum())} lanes"
        assert 0 < int((want[0] < SD.BIG).sum()) < N
        if n >= 3 and lo == 0:  # sphere 2 is sphere 1: the tie keeps the lower index
            scanned = want[0] != c.t_best
            assert int((scanned & (want[1] == 1)).sum()) > 0
            assert not bool((scanned & (want[1] == 2) & ~(c.excl & (c.excl_idx == 1))).any())


@pytest.mark.cuda
@pytest.mark.parametrize("with_lo", [True, False])
@pytest.mark.parametrize("n", [1, 2, 7, 32])
def test_sphere_ds_any_hit_kernel_matches_plain(dev, n, with_lo):
    from paths_tpu_torch.ops import sphere_ds as SD
    from sphere_ds_cases import same

    c = _ds_case(dev, n, with_lo, seed=100 + n)
    for n_scan in sorted({1, n}):
        args = (c.o, c.d, c.center, c.radius, c.center_lo, c.ent, n_scan, c.excl,
                c.excl_idx, c.t_max, c.excl_ent, c.occ)
        before = dict(P.LAUNCHES)
        got = SD.occludes(*args)
        assert _ds_added(before) == {"sphere_ds_any_hit": 1}
        want = SD.occludes_plain(*args)
        assert same(got, want), f"{int((got != want).sum())} lanes differ"
        assert int((want & ~c.occ).sum()) > 0


@pytest.mark.cuda
def test_sphere_ds_intersect_kernel_matches_plain(dev):
    from paths_tpu_torch.ops import sphere_ds as SD
    from sphere_ds_cases import same

    for seed, n in ((0, 7), (1, 32), (2, 1)):
        c = _ds_case(dev, n, seed=seed)
        before = dict(P.LAUNCHES)
        got = SD.intersect(c.o, c.d, c.lane_center, c.lane_radius)
        assert _ds_added(before) == {"sphere_ds_intersect": 1}
        want = SD.intersect_plain(c.o, c.d, c.lane_center, c.lane_radius)
        assert same(got[0], want[0]) and same(got[1], want[1])
        assert 0 < int(want[1].sum()) < N


@pytest.mark.cuda
def test_sphere_ds_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from paths_tpu_torch.ops import sphere_ds as SD

    c = _ds_case(dev, 7)
    with pytest.raises(TypeError):
        SD.closest(c.o, c.d, c.center, c.radius, c.center_lo, 0, 7, c.excl,
                   c.excl_idx.long(), c.t_best, c.i_best)
    with pytest.raises(ValueError):
        SD.closest(c.o, c.d, c.center.cpu(), c.radius, c.center_lo, 0, 7, c.excl,
                   c.excl_idx, c.t_best, c.i_best)
    with pytest.raises(ValueError):
        SD.occludes(c.o, c.d, c.center, c.radius, c.center_lo, c.ent, 8, c.excl,
                    c.excl_idx, c.t_max, c.excl_ent, c.occ)
    with pytest.raises(ValueError):
        SD.intersect(c.o, c.d, c.lane_center[:-1], c.lane_radius)


@pytest.mark.cuda
def test_sphere_ds_kernels_in_a_cuda_graph_replay_new_lanes(dev):
    """The three launches captured into one CUDA graph and replayed with new
    lane values: each replay equal to eager kernel calls and to the plain
    versions on the same lanes."""
    from paths_tpu_torch.ops import sphere_ds as SD
    from sphere_ds_cases import same

    c = _ds_case(dev, 7, seed=5)

    def lanes_of(k):
        return [x.roll(211 * k, 0).contiguous() for x in (
            c.o, c.d, c.excl, c.excl_idx, c.t_best, c.i_best, c.t_max, c.excl_ent, c.occ,
            c.lane_center, c.lane_radius)]

    def calls(o, d, excl, excl_idx, t_best, i_best, t_max, excl_ent, occ, lc, lr, plain=False):
        f = (SD.closest_plain, SD.occludes_plain, SD.intersect_plain) if plain else (
            SD.closest, SD.occludes, SD.intersect)
        return (*f[0](o, d, c.center, c.radius, c.center_lo, 0, 7, excl, excl_idx, t_best,
                      i_best),
                f[1](o, d, c.center, c.radius, c.center_lo, c.ent, 7, excl, excl_idx, t_max,
                     excl_ent, occ),
                *f[2](o, d, lc, lr))

    static = lanes_of(0)
    calls(*static)  # builds and binds the library outside the capture
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = calls(*static)
    for k in (1, 2, 3):
        new = lanes_of(k)
        for s, x in zip(static, new):
            s.copy_(x)
        before = dict(P.LAUNCHES)
        g.replay()
        assert _ds_added(before) == {}  # a bare graph's replay is not counted here
        eager = calls(*new)
        plain = calls(*new, plain=True)
        for name, a, b, p in zip(("t", "index", "occluded", "light t", "light hit"),
                                 out, eager, plain):
            assert same(a, b) and same(a, p), f"replay {k}: {name} differs"


def _doom_like(dev, asset_dir, hdri=False):
    """The mixed scene (a 128-triangle mesh, three spheres and a sphere
    light) on a radius-1e6 ground whose float64 centre has a low part, as
    doom's; with hdri, the environment cell's shape instead: the HDRI sky
    with environment NEE and no light."""
    import dataclasses
    import os

    from paths_tpu_torch import camera as C
    from paths_tpu_torch.scene import desc as D
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_mixed_scene

    sd = generate_mixed_scene(asset_dir, n_spheres=3)
    sd.objects.append(D.ObjectD(
        shape_kind="sphere",
        sphere=D.SphereD(center=D.Vec3D(0.0, -1000002.8, 0.0), radius=1e6),
        material=D.MaterialD(kind="lambertian",
                             albedo=D.MaterialColourD(colour=D.ColourD(0.5, 0.5, 0.5)))))
    if hdri:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        sd.skybox = D.SkyboxD(kind="hdri",
                              filename=os.path.join(repo, "scenes", "assets", "sunrise.hdr"))
        sd.lights = []
    static, scene, cam = build_scene(sd, device=dev)
    if hdri:
        static = dataclasses.replace(static, env_nee=True)
    assert static.tri_chunks > 0 and static.sph_chunks == 0 and static.sph_lo
    assert static.n_lights == (0 if hdri else 1)
    return static, scene, C.resize(cam, DS_W, DS_H)


@pytest.mark.cuda
def test_render_samples_with_the_sphere_ds_kernel_equals_the_eager_test(dev, monkeypatch,
                                                                        tmp_path):
    """A doom-like tile's accumulated radiance at a fixed seed, byte for
    byte the same with the kernel as with the eager double-single test on
    the card."""
    from paths_tpu_torch import render as R
    from paths_tpu_torch import step_graphs as SG
    from paths_tpu_torch.ops import sphere_ds as SD

    static, scene, cam = _doom_like(dev, str(tmp_path))
    w, h = DS_W, DS_H
    pix = torch.as_tensor(R.tiled_pixel_order(w, h).astype(np.int64), device=dev)
    px, py = (pix % w).to(torch.int32), (pix // w).to(torch.int32)

    def render():
        SG.clear()  # the step's graphs are captured with the test of the moment
        return R.render_samples(static, scene, cam, px, py, pix, 3, 4, 7300000001)

    before = dict(P.LAUNCHES)
    kernel = render()
    assert set(_ds_added(before)) == set(DS_KEYS)
    for name in ("closest", "occludes", "intersect"):
        monkeypatch.setattr(SD, name, getattr(SD, f"{name}_plain"))
    before = dict(P.LAUNCHES)
    eager = render()
    assert _ds_added(before) == {}
    assert float(kernel.max()) > 0
    assert kernel.cpu().numpy().tobytes() == eager.cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["doom_like", "environment_like", "stress"])
def test_sphere_ds_launches_of_one_iteration(dev, tmp_path, kind):
    """One bounce iteration launches the closest-hit kernel once, the any-hit
    kernel once a shadow query over the scanned spheres and the per-lane
    kernel once for the light, eagerly and under replay; a scene with no
    big sphere and no light launches none."""
    from paths_tpu_torch import camera as C
    from paths_tpu_torch import integrator as I
    from paths_tpu_torch import render as R
    from paths_tpu_torch import step_graphs as SG
    from paths_tpu_torch.ops import lane_rng as RNG
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_stress_scene

    if kind == "stress":
        static, scene, cam = build_scene(generate_stress_scene(40, seed=2), device=dev)
        cam = C.resize(cam, DS_W, DS_H)
        want = {}
    else:
        static, scene, cam = _doom_like(dev, str(tmp_path), hdri=kind == "environment_like")
        want = ({"sphere_ds_closest": 1, "sphere_ds_any_hit": 1, "sphere_ds_intersect": 1}
                if kind == "doom_like" else {"sphere_ds_closest": 1, "sphere_ds_any_hit": 1})
    w, h = DS_W, DS_H
    pix = torch.arange(w * h, device=dev)
    sid = torch.zeros_like(pix)
    o, d, _ = R.gen_camera_rays(cam, (pix % w).to(torch.int32), (pix // w).to(torch.int32),
                                pix, sid, 11)
    state = I.fresh_path_state(o, d)
    plain_u = lambda bounce, dim: RNG.shading_uniform(11, pix, sid, bounce, dim)
    before = dict(P.LAUNCHES)
    I.path_step(static, scene, 0, state, plain_u)  # eager
    assert _ds_added(before) == want
    seed = torch.full((), 11, dtype=torch.int64, device=dev)
    u = I.lane_uniforms(seed, pix, sid)
    bounce = torch.zeros_like(pix)
    SG.clear()
    I.path_step(static, scene, bounce, state, u)  # the warm-up and the capture
    before = dict(P.LAUNCHES)
    I.path_step(static, scene, bounce, state, u)  # a replay
    assert _ds_added(before) == want


@pytest.mark.cuda
def test_sphere_ds_under_grad_launches_every_query(dev):
    """With inputs that require grad every query launches its kernel.  The
    closest hit's t is then recomputed at the chosen sphere, counted as
    sphere_ds_eager: bit for bit the no-grad kernel's t, with the plain
    scan's gradient.  The shadow test and the light's bound are uncounted
    and carry no gradient."""
    from paths_tpu_torch.ops import sphere_ds as SD
    from sphere_ds_cases import same

    c = _ds_case(dev, 7, seed=9)
    with torch.no_grad():
        t_k, i_k = SD.closest(c.o, c.d, c.center, c.radius, c.center_lo, 0, 7, c.excl,
                              c.excl_idx, c.t_best, c.i_best)
    leaves = [x.clone().requires_grad_() for x in (c.o, c.d, c.center)]
    before = dict(P.LAUNCHES)
    with P.record() as rec:
        t, i = SD.closest(*leaves[:2], leaves[2], c.radius, c.center_lo, 0, 7, c.excl,
                          c.excl_idx, c.t_best, c.i_best)
        occ = SD.occludes(*leaves, c.radius, c.center_lo, c.ent, 7, c.excl, c.excl_idx,
                          c.t_max, c.excl_ent, c.occ)
        tl, hl = SD.intersect(*leaves[:2], c.lane_center, c.lane_radius)
    assert _ds_added(before) == dict.fromkeys(DS_KEYS, 1)
    assert rec.counts == {"sphere_ds_eager": 1}
    assert same(t.detach(), t_k) and same(i, i_k) and t.requires_grad
    assert not tl.requires_grad
    assert same(occ, SD.occludes_plain(c.o, c.d, c.center, c.radius, c.center_lo, c.ent, 7,
                                       c.excl, c.excl_idx, c.t_max, c.excl_ent, c.occ))
    want = SD.intersect_plain(c.o, c.d, c.lane_center, c.lane_radius)
    assert same(tl, want[0]) and same(hl, want[1])
    grads = torch.autograd.grad(torch.where(t < SD.BIG, t, 0.0).sum(), leaves)
    plain = [x.clone().requires_grad_() for x in (c.o, c.d, c.center)]
    t_p, _ = SD.closest_plain(*plain[:2], plain[2], c.radius, c.center_lo, 0, 7, c.excl,
                              c.excl_idx, c.t_best, c.i_best)
    grads_p = torch.autograd.grad(torch.where(t_p < SD.BIG, t_p, 0.0).sum(), plain)
    for g, g_p in zip(grads, grads_p):
        torch.testing.assert_close(g, g_p, rtol=1e-6, atol=1e-6 * float(g_p.abs().max()))
        assert float(g.abs().sum()) > 0


@pytest.mark.cuda
def test_sphere_ds_kernels_keep_a_doom_like_gradient(dev, monkeypatch, tmp_path):
    """loss_and_grad on a doom-like tile: the same loss, bit for bit, and
    the same gradients with the kernels as with the eager double-single test
    on the card (up to the order in which a parameter's lanes are summed)."""
    from paths_tpu_torch import grad as G
    from paths_tpu_torch import render as R
    from paths_tpu_torch.ops import sphere_ds as SD

    static, scene, cam = _doom_like(dev, str(tmp_path))
    w, h = DS_W, DS_H
    pix = torch.as_tensor(R.tiled_pixel_order(w, h).astype(np.int64), device=dev)
    px, py = (pix % w).to(torch.int32), (pix // w).to(torch.int32)
    target = torch.full((pix.shape[0], 3), 0.25, device=dev)

    def run():
        return G.loss_and_grad(static, scene, cam, px, py, pix, torch.zeros_like(pix),
                               7300000001, target)

    before = dict(P.LAUNCHES)
    with P.record() as rec:
        loss, grads = run()
    assert set(_ds_added(before)) == set(DS_KEYS) and rec.counts["sphere_ds_eager"] > 0
    for name in ("closest", "occludes", "intersect"):
        monkeypatch.setattr(SD, name, getattr(SD, f"{name}_plain"))
    before = dict(P.LAUNCHES)
    loss_p, grads_p = run()
    assert _ds_added(before) == {}
    assert loss.item() == loss_p.item() and loss.item() > 0
    for g, g_p in zip(G.flatten_params(grads), G.flatten_params(grads_p)):
        if g is None or g_p is None:
            assert g is None and g_p is None
            continue
        torch.testing.assert_close(g, g_p, rtol=1e-5,
                                   atol=1e-6 * max(float(g_p.abs().max()), 1e-30))
