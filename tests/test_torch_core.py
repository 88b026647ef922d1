"""ignis_tpu_torch core modules against ignis_tpu: RNG, pixel samplers and
camera rays, on inputs made by numpy from a seed and given to both."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignis_tpu
from ignis_tpu.core import rng as jrng
from ignis_tpu.core import sampler as jsampler
from ignis_tpu.models import camera as jcamera
from ignis_tpu_torch.bridge import from_reference
from ignis_tpu_torch.core import rng as trng
from ignis_tpu_torch.core import sampler as tsampler
from ignis_tpu_torch.models import camera as tcamera

from __graft_entry__ import _SCENE

# The tensors here are small; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def _u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


@pytest.fixture(scope="module")
def seeds():
    rng = np.random.default_rng(123)
    return [_u32(rng, 4096) for _ in range(6)]


def test_seed_bit_equal(seeds):
    ref = np.asarray(jrng.seed(*[jnp.asarray(a) for a in seeds]))
    got = trng.seed(*[torch.from_numpy(a.astype(np.int64)) for a in seeds])
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)


def test_draws_bit_equal(seeds):
    """next_u32/next_f32 on random uint32 states: bit-equal streams."""
    js = jnp.asarray(seeds[0])
    ts = torch.from_numpy(seeds[0].astype(np.int64))
    for _ in range(4):
        js, jbits = jrng.next_u32(js)
        ts, tbits = trng.next_u32(ts)
        np.testing.assert_array_equal(tbits.numpy().astype(np.uint32),
                                      np.asarray(jbits))
    js, jf = jrng.next_f32_n(js, 3)
    ts, tf = trng.next_f32_n(ts, 3)
    for a, b in zip(tf, jf):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                  np.asarray(js))


@pytest.fixture(scope="module")
def s2():
    rt = ignis_tpu.loadFromString(json.dumps(_SCENE))
    scene, settings = from_reference(rt.scene, rt.settings, "cpu")
    return rt, scene, settings


@pytest.mark.parametrize("kind", ["uniform", "mjitt", "halton"])
def test_pixel_offsets(s2, kind):
    """Offsets agree within 1 ulp (rtol 1e-6): the halton digit loop is
    float arithmetic that the two libraries may round apart."""
    rt = s2[0]
    w, h = rt.settings.width, rt.settings.height
    rng = np.random.default_rng(9)
    x = rng.integers(0, w, 2048).astype(np.int32)
    y = rng.integers(0, h, 2048).astype(np.int32)
    sidx = rng.integers(0, 1 << 20, 2048).astype(np.uint32)
    st = _u32(rng, 2048)
    js, (jx, jy) = jsampler.sample_pixel_offsets(
        kind, jnp.asarray(st), jnp.asarray(sidx), jnp.asarray(x),
        jnp.asarray(y))
    ts, (tx, ty) = tsampler.sample_pixel_offsets(
        kind, torch.from_numpy(st.astype(np.int64)),
        torch.from_numpy(sidx.astype(np.int64)), torch.from_numpy(x),
        torch.from_numpy(y))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                  np.asarray(js))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("camera_type", ["perspective", "orthogonal",
                                         "fishlens"])
def test_generate_rays(s2, camera_type):
    """Camera rays of S2's camera within 1 ulp (rtol 1e-6; atol 1e-7 for
    direction components near zero). The fisheye goes through sin/cos,
    which torch and XLA round apart by a few ulps: atol 1e-6 there."""
    import dataclasses
    rt, scene, settings = s2
    jsettings = dataclasses.replace(rt.settings, camera_type=camera_type)
    settings = dataclasses.replace(settings, camera_type=camera_type)
    rng = np.random.default_rng(4)
    n = 4096
    x = rng.integers(0, settings.width, n).astype(np.int32)
    y = rng.integers(0, settings.height, n).astype(np.int32)
    sx = rng.uniform(size=n).astype(np.float32)
    sy = rng.uniform(size=n).astype(np.float32)
    st = _u32(rng, n)
    ref = jcamera.generate_rays(rt.scene.camera, jsettings, jnp.asarray(x),
                                jnp.asarray(y), jnp.asarray(sx),
                                jnp.asarray(sy), rng_state=jnp.asarray(st))
    got = tcamera.generate_rays(scene.camera, settings, torch.from_numpy(x),
                                torch.from_numpy(y), torch.from_numpy(sx),
                                torch.from_numpy(sy),
                                rng_state=torch.from_numpy(
                                    st.astype(np.int64)))
    for a, b in zip([*got.org, *got.dir, got.tmin, got.tmax],
                    [*ref.org, *ref.dir, ref.tmin, ref.tmax]):
        assert a.shape == (n,) and a.is_contiguous()
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=1e-6,
            atol=1e-6 if camera_type == "fishlens" else 1e-7)


# --- microfacet, warps and the normal-map fix-up (materials slice) ----------

def _dirs(rng, n, up=False):
    v = rng.normal(size=(n, 3))
    if up:
        v[:, 2] = np.abs(v[:, 2]) + 0.02
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


def _both3(a):
    from ignis_tpu.core.vec import Vec3 as JVec3
    from ignis_tpu_torch.core.vec import Vec3
    return (JVec3(*[jnp.asarray(a[:, i]) for i in range(3)]),
            Vec3(*[torch.from_numpy(a[:, i].copy()) for i in range(3)]))


def _close(got, ref, rtol=1e-5, atol=1e-6):
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


def test_microfacet_matches_jax():
    """core/microfacet.py against ignis_tpu.core.microfacet on random
    directions and anisotropic roughness: NDF, Smith G1 and its separable
    product, the visible-normal sample and its pdf, and both Jacobians,
    within rtol 1e-5 / atol 1e-6 (the NDF within rtol 1e-4: it divides by
    a fourth power)."""
    from ignis_tpu.core import microfacet as jmf
    from ignis_tpu_torch.core import microfacet as tmf
    rng = np.random.default_rng(41)
    n = 4096
    (jwo, two), (jwi, twi), (jm, tm) = (_both3(_dirs(rng, n, up=True))
                                         for _ in range(3))
    au, av, u0, u1, eta = [rng.uniform(lo, hi, n).astype(np.float32)
                           for lo, hi in ((0.05, 0.8), (0.05, 0.8), (0, 1),
                                          (0, 1), (0.6, 1.6))]
    J = [jnp.asarray(x) for x in (au, av, u0, u1, eta)]
    T = [torch.from_numpy(x) for x in (au, av, u0, u1, eta)]
    _close(tmf.ndf_ggx(tm, T[0], T[1]), jmf.ndf_ggx(jm, J[0], J[1]),
           rtol=1e-4)
    _close(tmf.g1_smith(two, T[0], T[1]), jmf.g1_smith(jwo, J[0], J[1]))
    _close(tmf.g_separable(twi, two, T[0], T[1]),
           jmf.g_separable(jwi, jwo, J[0], J[1]))
    th = tmf.sample_vndf_ggx(two, *T[:4])
    jh = jmf.sample_vndf_ggx(jwo, *J[:4])
    _close(tuple(th), tuple(jh), atol=1e-5)
    _close(tmf.pdf_vndf_ggx(two, th, T[0], T[1]),
           jmf.pdf_vndf_ggx(jwo, jh, J[0], J[1]), rtol=1e-4, atol=1e-5)
    _close(tmf.reflective_jacobian(T[3] - 0.5),
           jmf.reflective_jacobian(J[3] - 0.5), rtol=1e-5)
    _close(tmf.refractive_jacobian(T[4], T[2] - 0.5, T[3] - 0.5),
           jmf.refractive_jacobian(J[4], J[2] - 0.5, J[3] - 0.5), rtol=1e-4)


def test_warps_and_reflection_fixup_match_jax():
    """The cone and cosine-power warps and their pdfs, dir_from_spherical
    and ensure_valid_reflection (the normal-map clamp) against
    ignis_tpu.core on random inputs: within rtol 1e-5 / atol 1e-5."""
    from ignis_tpu.core import frame as jframe
    from ignis_tpu.core import warp as jwarp
    from ignis_tpu_torch.core import frame as tframe
    from ignis_tpu_torch.core import warp as twarp
    rng = np.random.default_rng(43)
    n = 4096
    u, v, cosa, k, theta, phi = [
        rng.uniform(lo, hi, n).astype(np.float32)
        for lo, hi in ((0, 1), (0, 1), (0.5, 0.9999), (1, 80), (0, 3.1),
                       (-3.1, 3.1))]
    J = [jnp.asarray(x) for x in (u, v, cosa, k, theta, phi)]
    T = [torch.from_numpy(x) for x in (u, v, cosa, k, theta, phi)]
    jd, jp = jwarp.sample_uniform_cone(J[0], J[1], J[2])
    td, tp = twarp.sample_uniform_cone(T[0], T[1], T[2])
    _close(tuple(td) + (tp,), tuple(jd) + (jp,), atol=1e-5)
    jd, jp = jwarp.sample_cosine_power_hemisphere(J[3], J[0], J[1])
    td, tp = twarp.sample_cosine_power_hemisphere(T[3], T[0], T[1])
    _close(tuple(td) + (tp,), tuple(jd) + (jp,), atol=1e-5)
    _close(twarp.cosine_power_hemisphere_pdf(T[1], T[3]),
           jwarp.cosine_power_hemisphere_pdf(J[1], J[3]), atol=1e-5)
    _close(tuple(twarp.dir_from_spherical(T[4], T[5])),
           tuple(jwarp.dir_from_spherical(J[4], J[5])), atol=1e-5)
    (jng, tng), (ji, ti), (jn, tn) = (_both3(_dirs(rng, n)) for _ in range(3))
    _close(tuple(tframe.ensure_valid_reflection(tng, ti, tn)),
           tuple(jframe.ensure_valid_reflection(jng, ji, jn)), atol=1e-5)
