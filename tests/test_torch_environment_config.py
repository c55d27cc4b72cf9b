"""The benchmark's ``environment`` configuration on the CPU: the port against
the benchmark's plain reference for HDRI skies with environment NEE
(``portbench/reference/environment.py``) on the configuration cut small,
the reference's RGBE reader and sampler against the port's, and the
float32 CDF fault of the configuration's 4096x2048 map, pinned.

The small scene is the configuration's (camera, Gloss material, ground
sphere, no light) at 24x16 and 2 spp, with a 64x32 sunrise map (a sun of 4
texels across) and 2,000 triangles, five rings of the dragon stand-in's
tube, on the kernel route (its plain versions on the CPU).
"""

import copy
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from paths_tpu_torch import sky as TS
from paths_tpu_torch.render import render_image
from paths_tpu_torch.scene.build import build_scene
from paths_tpu_torch.scene.hdr_loader import load_hdr, write_hdr, write_hdr_rle
from paths_tpu_torch.scene.yaml_loader import parse_scene_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scenes"))

import make_assets as MA  # noqa: E402
from portbench import env_map  # noqa: E402
from portbench import harness  # noqa: E402
from portbench.reference import environment as RE  # noqa: E402
from portbench.reference import scene as RS  # noqa: E402
from portbench.reference.precision import lower_precision  # noqa: E402

torch.set_num_threads(2)

W, H, SPP = 24, 16, 2
CONFIG_DIR = os.path.join(REPO, "portbench", "configs")
MAP_4K = os.path.join(CONFIG_DIR, "environment", "sunrise_4k.hdr")
# Five rings of the tube: faces [0, 1000) and their quads' second halves.
RINGS = np.r_[0:1000, 100000:101000]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(config, port scene with env NEE, reference scene) at the small
    size."""
    tmp = str(tmp_path_factory.mktemp("env_config"))
    v, f, _ = RS.read_ply(os.path.join(CONFIG_DIR, "environment", "dragon_standin.ply"))
    used, inv = np.unique(f[RINGS], return_inverse=True)
    MA.write_ply_binary(os.path.join(tmp, "rings.ply"), v[used], inv.reshape(-1, 3))
    write_hdr_rle(os.path.join(tmp, "sun.hdr"), env_map.sunrise(32, 64))
    cfg = copy.deepcopy(harness.load_config("environment"))
    cfg["scene"]["models"] = {"dragon": {"file": "rings.ply"}}
    cfg["scene"]["skybox"] = {"type": "Hdri", "filename": "sun.hdr"}
    cfg["scene"]["camera"].update(image_width=W, image_height=H)
    cfg["base_dir"] = tmp
    static, scene, cam = build_scene(parse_scene_dict(cfg["scene"], base_dir=tmp), device="cpu")
    assert static.n_tris == 2000 and static.tri_chunks > 0  # the kernel route
    static = dataclasses.replace(static, env_nee=True)
    return cfg, (static, scene, cam), RE.build(cfg["scene"], tmp, "cpu")


def _port(small, seed):
    static, scene, cam = small[1]
    return render_image(static, scene, cam, W, H, spp=SPP, seed=seed, tile_pixels=256)


@pytest.mark.parametrize("seed", [1, 3, 2147483659])
def test_port_matches_environment_reference(small, seed):
    """Every pixel of a frame against the reference's.  Both put the ground
    where the configuration's float64 centre does (the port by its
    double-single test with the centre's low part, the reference by its
    float64 test), both round the same float32 shading operations in the
    same order here, and on these seeds every
    lane's triangle test agrees (K3/K4's recentred plane test rounds t
    otherwise than the reference's own, which parts a lane at a triangle's
    edge now and then: 0-20 pixels of a 720x480 frame on the card): the
    frames agree to the last bits of the float32 sums, hence relative MSE
    1e-10 and no pixel parted.  The bfloat16 reference fails both (below)."""
    img = _port(small, seed)
    ref = RE.frame_mean(small[2], W, H, SPP, seed)
    assert np.isfinite(img).all() and ref.mean() > 0.1
    assert harness.rel_mse(img, ref) < 1e-10
    assert harness.parted_pct(img, ref) == 0.0


def test_float32_ground_parts_the_frames(small):
    """The ground's centre (y -1000002.8) is -1000002.8125 in float32; the
    port's double-single test takes its low part too, and the reference
    tests the float64 centre.  Without the low part the ground lies 1.25
    cm low, paths that bounce off it start from other points, and seed 1's
    frame parts on one pixel of 384 (relative MSE 4.6e-7); on the card's
    720x480 frames, 3.1-3.2% of the pixels part."""
    static, scene, cam = small[1]
    assert static.sph_lo and float(small[2].scene.sph_c64[0, 1]) == -1000002.8
    img = render_image(dataclasses.replace(static, sph_lo=False), scene, cam, W, H, spp=SPP,
                       seed=1, tile_pixels=256)
    ref = RE.frame_mean(small[2], W, H, SPP, 1)
    assert round(harness.parted_pct(img, ref) * W * H / 100.0) == 1
    assert 1e-7 < harness.rel_mse(img, ref) < 1e-6


def test_bfloat16_reference_fails_the_limits(small):
    ref = RE.frame_mean(small[2], W, H, SPP, 1)
    with lower_precision():
        low = RE.frame_mean(small[2], W, H, SPP, 1)
    assert harness.rel_mse(low, ref) > 0.1 and harness.parted_pct(low, ref) > 50.0


@pytest.mark.parametrize("layout", ["rle", "flat"])
def test_rgbe_reader_matches_load_hdr(tmp_path, layout):
    """The reference's reader against the port's ``load_hdr``, bit for bit,
    on the sunrise map with a sun and on seeded noise with a black texel
    (exponent 0) and runs shorter and longer than 127, each written with
    RLE scanlines (``write_hdr_rle``) or flat ones (``write_hdr``)."""
    rng = np.random.default_rng(7)
    noise = rng.uniform(0.0, 50.0, (6, 300, 3)).astype(np.float32)
    noise[0, 0] = 0.0
    noise[1, 10:250] = 3.0
    noise[2, 5:8] = 9.0
    write = write_hdr_rle if layout == "rle" else write_hdr
    for name, img in (("sun", env_map.sunrise(32, 64)), ("noise", noise)):
        path = str(tmp_path / f"{name}.hdr")
        write(path, img)
        got = RE.read_rgbe(path)
        want = load_hdr(path)
        assert got.dtype == np.float32 and got.shape == img.shape
        np.testing.assert_array_equal(got, want)
    if layout == "rle":  # the runs made the file smaller than flat
        assert os.path.getsize(str(tmp_path / "noise.hdr")) < 6 * 300 * 4


def test_sample_env_and_tables_match_port():
    """The reference's tables equal ``sky.hdri``'s bit for bit, and its
    ``sample_env`` on seeded uniforms the port's: the same texel, radiance
    and inverse pdf on every lane, and the same direction; so does the
    lookup along the sampled directions."""
    img = env_map.sunrise(32, 64)
    _, tsky = TS.hdri(img, "cpu")
    env = RE.env_map(img, "cpu")
    assert torch.equal(env.cdf, tsky.env_cdf) and torch.equal(env.inv_pdf, tsky.env_inv_pdf)
    rng = np.random.default_rng(11)
    u = [torch.from_numpy(rng.uniform(0, 1, 4096).astype(np.float32)) for _ in range(3)]
    u[0][:3] = torch.tensor([0.0, 1.0 - 2.0 ** -24, float(env.cdf[100])])
    got, want = RE.sample_env(env, *u), TS.sample_env(tsky, *u)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(RE.lookup(env, -got[0]), TS.ambient_light(TS.HDRI, tsky, -want[0]))


def test_float32_cdf_fault_of_the_4k_map():
    """A recorded fault, pinned so that a fix updates these numbers
    knowingly: ``sky.hdri`` builds the flat CDF in float64 and keeps it in
    float32, while the weights come from the float64 probabilities.  On the
    configuration's 4096x2048 map (the sun a disc of 64 texels' radius) the
    texels' mean probability is 2^-23, and most lie near float32's spacing
    of the CDF near 1, 2^-24: 4,008,303 of the 8,388,608 texels get a CDF
    step of 0 (never sampled) and texels with 2.42% of the probability get
    a step more than 10% off it.  The 24-bit uniform resolves 2^24 points,
    and 6,025,732 texels (4.62% of the probability) hold none of them."""
    img = load_hdr(MAP_4K)
    assert img.shape == (2048, 4096, 3)
    _, sky = TS.hdri(img, "cpu")
    cdf = sky.env_cdf.numpy().astype(np.float64)
    lo = np.concatenate([[0.0], cdf[:-1]])
    step = cdf - lo
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    lat = np.pi * (1.0 - (np.arange(2048) + 0.5) / 2048)
    p = (lum.astype(np.float64) * np.sin(lat)[:, None]).reshape(-1)
    p /= p.sum()
    assert int((step == 0).sum()) == 4_008_303
    off = np.abs(step - p) > 0.1 * p
    assert round(float(p[off].sum()), 4) == 0.0242
    unreachable = np.ceil(lo * 2 ** 24) / 2 ** 24 >= cdf
    assert int(unreachable.sum()) == 6_025_732
    assert round(float(p[unreachable].sum()), 4) == 0.0462
