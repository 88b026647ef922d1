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
