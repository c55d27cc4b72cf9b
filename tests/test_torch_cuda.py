"""The port's CUDA kernels on the card, held against their plain PyTorch
versions.  Every test here needs a CUDA device (marker ``cuda``) and skips
without one.  The file imports no JAX, so it runs on a machine that has only
PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts=""
"""

import numpy as np
import pytest
import torch

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
    before = ST.LAUNCHES["sphere_closest_hit"]
    got = ST.closest_hit_spheres(ps, nc, o, d, excl, t_init)
    torch.cuda.synchronize()
    assert ST.LAUNCHES["sphere_closest_hit"] == before + 1
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
    before = ST.LAUNCHES["sphere_any_hit"]
    got = ST.occludes_spheres(ps, nc, o, d, excl, excl_ent, t_max)
    torch.cuda.synchronize()
    assert ST.LAUNCHES["sphere_any_hit"] == before + 1
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
    before = TT.LAUNCHES["tri_closest_hit"]
    got = TT.closest_hit_tris(pt, nc, o, d, excl, t_init)
    torch.cuda.synchronize()
    assert TT.LAUNCHES["tri_closest_hit"] == before + 1
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
    before = CS.LAUNCHES[name]
    if anyhit:
        got = CS.flat_occludes(ps.tris, o, d, excl, excl_ent, t_max)
        want = ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max)
    else:
        got = CS.flat_closest_hit(ps.tris, o, d, excl, t_init)
        want = ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_init)
    torch.cuda.synchronize()
    assert CS.LAUNCHES[name] == before + 1
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
    before, walks = dict(CS.LAUNCHES), dict(ST.LAUNCHES)
    got = CS.closest_hit_spheres(ps, nc, o, d, excl, t_init)
    torch.cuda.synchronize()
    assert CS.LAUNCHES["scan_sphere_closest_hit"] == before["scan_sphere_closest_hit"] + 1
    assert ST.LAUNCHES == walks
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
    before = CS.LAUNCHES["scan_tri_closest_hit"]
    got = CS.closest_hit_chunked(pt, nc, o, d, excl, t_init)
    torch.cuda.synchronize()
    assert CS.LAUNCHES["scan_tri_closest_hit"] == before + 1
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
    bit, each launch counted once in chunk_scan.LAUNCHES and not as K3/K4."""
    (flat, v0, v1, v2, nrm, ent), lanes = ties_case(CS.TRI_ROWS_PER_CHUNK, 13)
    pt, nc = TT.pack_chunked(flat, v0, v1, v2, nrm, ent=ent,
                             rows_per_chunk=CS.TRI_ROWS_PER_CHUNK)
    pt = TT.PackedTris(*(x.to(dev) for x in pt))
    o, d, excl, t_init, excl_ent, t_max = _repeat(
        [torch.as_tensor(np.array(a), device=dev) for a in lanes], n)
    first = TT.closest_hit_tris_plain(pt, nc, o, d, excl, torch.full_like(t_init, 3.4e38))[0]
    t_init, t_max = _exact_seeds(first, t_init, t_max)
    before, walks = dict(CS.LAUNCHES), dict(TT.LAUNCHES)
    got = CS.closest_hit_chunked(pt, nc, o, d, excl, t_init)
    for g, w in zip(got, TT.closest_hit_tris_plain(pt, nc, o, d, excl, t_init)):
        assert torch.equal(g, w)
    occ = CS.occludes_chunked(pt, nc, o, d, excl, excl_ent, t_max)
    assert torch.equal(occ, TT.occludes_tris_plain(pt, nc, o, d, excl, excl_ent, t_max))
    torch.cuda.synchronize()
    assert CS.LAUNCHES["scan_tri_closest_hit"] == before["scan_tri_closest_hit"] + 1
    assert CS.LAUNCHES["scan_tri_any_hit"] == before["scan_tri_any_hit"] + 1
    assert TT.LAUNCHES == walks
    if n > 1000:
        assert int((got[0] < 3.4e38).sum()) > n // 4 and int(occ.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 65537])
def test_chunked_sphere_walk_holds_exact_ties(dev, n):
    """K8 and K9's sphere form on the pole pairs packed at 16 rows a chunk,
    at n lanes, with t_init and t_max at the exact nearest hit on some lanes
    and t_max 0 on others: equal to the plain versions bit for bit (K8's
    exact ties go to the first slot in table order), each launch counted
    once in chunk_scan.LAUNCHES and not as K1/K2."""
    (c, r, ent), lanes = sphere_ties_case()
    ps, nc, _ = ST.pack_spheres_chunked(c, r, ent=ent, rows_per_chunk=CS.SPH_ROWS_PER_CHUNK,
                                        device=dev)
    o, d, excl, t_init, excl_ent, t_max = _repeat(
        [torch.as_tensor(np.array(a), device=dev) for a in lanes], n)
    first = ST.closest_hit_spheres_plain(ps.tris, o, d, excl, torch.full_like(t_init, 3.4e38))[0]
    t_init, t_max = _exact_seeds(first, t_init, t_max)
    before, walks = dict(CS.LAUNCHES), dict(ST.LAUNCHES)
    got = CS.closest_hit_spheres(ps, nc, o, d, excl, t_init)
    for g, w in zip(got, ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_init)):
        assert torch.equal(g, w)
    occ = CS.occludes_spheres(ps, nc, o, d, excl, excl_ent, t_max)
    assert torch.equal(occ, ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max))
    torch.cuda.synchronize()
    assert CS.LAUNCHES["scan_sphere_closest_hit"] == before["scan_sphere_closest_hit"] + 1
    assert CS.LAUNCHES["scan_sphere_any_hit"] == before["scan_sphere_any_hit"] + 1
    assert ST.LAUNCHES == walks
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
    before = dict(CS.LAUNCHES)
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
    assert CS.LAUNCHES == before


# ---- K6 (the skip-link BVH walk) ----

@pytest.mark.cuda
@pytest.mark.parametrize("n_tris", [3000, 120000])
def test_packet_kernel_matches_plain(dev, n_tris):
    pt, _, (o, d, excl, t_init, _, _) = _mesh_and_rays(dev, n_tris, seed=5, bvh=True)
    d[:64, 0] = 0.0  # a zero direction component
    before = PK.LAUNCHES["packet_closest_hit"]
    got = PK.closest_hit_packet(pt, o, d, excl, t_init)
    torch.cuda.synchronize()
    assert PK.LAUNCHES["packet_closest_hit"] == before + 1
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
    from paths_tpu_torch.ops import lane_rng as RNG
    from paths_tpu_torch.scene.build import build_scene
    from paths_tpu_torch.scene.stress import generate_stress_scene

    (pix, sid), _ = _rng_keys(dev)
    RNG.reset_launch_counts()
    u = I.lane_uniforms(5, pix, sid)
    u(0, H.DIM_LOBE)
    u(torch.zeros_like(pix), H.DIM_RR)
    assert RNG.LAUNCHES == {"rng_uniform": 2, "rng_camera": 0}
    _, _, cam = build_scene(generate_stress_scene(8, seed=1), device=dev)
    cam = C.resize(cam, 64, 64)
    R.gen_camera_rays(cam, (pix % 64).to(torch.int32), (pix // 64 % 64).to(torch.int32),
                      pix, sid, 5)
    assert RNG.LAUNCHES == {"rng_uniform": 2, "rng_camera": 1}


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

    RNG.reset_launch_counts()
    kernel = render()
    assert RNG.LAUNCHES["rng_uniform"] > 0 and RNG.LAUNCHES["rng_camera"] > 0
    monkeypatch.setattr(RNG, "shading_uniform", RNG.shading_uniform_plain)
    monkeypatch.setattr(RNG, "camera_cmj", RNG.camera_cmj_plain)
    RNG.reset_launch_counts()
    eager = render()
    assert RNG.LAUNCHES == {"rng_uniform": 0, "rng_camera": 0}
    assert kernel.cpu().numpy().tobytes() == eager.cpu().numpy().tobytes()
