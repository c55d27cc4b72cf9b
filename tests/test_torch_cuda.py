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
from tri_walk_cases import ties_case

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


# ---- K5 (flat spheres) and K7-K9 (linear chunk scan) ----

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
def test_scan_sphere_kernels_match_plain(dev):
    ps, nc, (o, d, excl, t_init, excl_ent, t_max) = _scene_and_rays(
        dev, seed=3, rows=CS.SPH_ROWS_PER_CHUNK)
    got = CS.closest_hit_spheres(ps, nc, o, d, excl, t_init)
    for g, w in zip(got, ST.closest_hit_spheres_plain(ps.tris, o, d, excl, t_init)):
        assert torch.equal(g, w)
    occ = CS.occludes_spheres(ps, nc, o, d, excl, excl_ent, t_max)
    assert torch.equal(occ, ST.occludes_spheres_plain(ps.tris, o, d, excl, excl_ent, t_max))
    assert int((got[0] < 3.4e38).sum()) > N // 8 and int(occ.sum()) > N // 8


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
        PK.closest_hit_packet(pt._replace(walk=pt.walk.cpu()), o, d, excl, t_init)
