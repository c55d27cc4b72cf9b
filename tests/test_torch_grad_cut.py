"""The gradient cut at the traversal wrappers, on each device: every wrapper
of K1-K9 detaches its rays and seeds before it dispatches (the reference's
launchers ``stop_gradient`` theirs), so with inputs that require a gradient
no output does -- on the CPU, where the plain versions would otherwise
differentiate t through o and d, and on the card.  The double-single sphere
test stays differentiable, as the reference's XLA scans are.  The file
imports no JAX, so its card case runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_grad_cut.py -m cuda --noconftest -o addopts=""
"""

import numpy as np
import pytest
import torch

from paths_tpu_torch.geom import sphere as GS
from paths_tpu_torch.ops import chunk_scan as CS
from paths_tpu_torch.ops import packet_traverse as PK
from paths_tpu_torch.ops import sphere_traverse as ST
from paths_tpu_torch.ops import tri_traverse as TT
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.stress import generate_mixed_scene

torch.set_num_threads(2)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def dev(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


def _grad_lanes(dev, n=64, seed=0):
    rng = np.random.default_rng(seed)
    o = torch.tensor(rng.uniform(-3, 3, (n, 3)) + [0, 2, -6], dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(n, 3)) * 0.3 + [0, -0.3, 1], dtype=torch.float32)
    d = d / d.norm(dim=1, keepdim=True)
    t = torch.full((n,), 100.0)
    excl = torch.full((n,), -1, dtype=torch.int32, device=dev)
    return [x.to(dev).requires_grad_() for x in (o, d, t)], excl


def test_traversal_wrappers_carry_no_gradient(tmp_path, dev):
    static, scene, _ = build_scene(generate_mixed_scene(str(tmp_path), n_spheres=40),
                                   device=dev)
    bvh = build_scene(generate_mixed_scene(str(tmp_path), n_spheres=3), device=dev,
                      bvh_threshold=64)[1].pbvh
    assert static.sph_chunks > 0 and static.tri_chunks > 0 and bvh is not None
    (o, d, t), excl = _grad_lanes(dev)
    ent = torch.zeros_like(excl)
    ps, pt, ns, nt = scene.psph, scene.ptris, static.sph_chunks, static.tri_chunks
    calls = {
        "K1": lambda: ST.closest_hit_spheres(ps, ns, o, d, excl, t),
        "K2": lambda: ST.occludes_spheres(ps, ns, o, d, excl, ent, t),
        "K3": lambda: TT.closest_hit_tris(pt, nt, o, d, excl, t),
        "K4": lambda: TT.occludes_tris(pt, nt, o, d, excl, ent, t),
        "K5 closest": lambda: CS.flat_closest_hit(ps.tris, o, d, excl, t),
        "K5 any": lambda: CS.flat_occludes(ps.tris, o, d, excl, ent, t),
        "K6": lambda: PK.closest_hit_packet(bvh, o, d, excl, t),
        "K7": lambda: CS.closest_hit_chunked(pt, nt, o, d, excl, t),
        "K8": lambda: CS.closest_hit_spheres(ps, ns, o, d, excl, t),
        "K9 triangles": lambda: CS.occludes_chunked(pt, nt, o, d, excl, ent, t),
        "K9 spheres": lambda: CS.occludes_spheres(ps, ns, o, d, excl, ent, t),
    }
    hits = 0
    for name, call in calls.items():
        out = call()
        out = out if isinstance(out, tuple) else (out,)
        assert not any(x.requires_grad for x in out), name
        hits += int((out[0] < 1e30).sum()) if out[0].dtype == torch.float32 else 0
    assert hits > 0
    t_ds, _ = GS.intersect(o, d, scene.sph_center[0], scene.sph_radius[0])
    assert t_ds.requires_grad
