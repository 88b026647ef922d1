"""Measured BSDFs in ignis_tpu_torch against ignis_tpu, on the CPU.

The loaders (scene/klems.py, tensortree.py, djmeasured.py, copies of the
JAX package's) give the same arrays on synthesized files: the 9-patch
Klems window of tests/test_components.py:165 and chip_smoke's full
145-patch one, TensorTree3 trees of depth 0 and 4 and a TensorTree4 of
depth 2, isotropic and anisotropic Dupuy-Jakob files. The models' eval,
pdf and sample against the JAX ones on 4,096 random frames and
directions, per kind and through the BSDF dispatch of mixed rows, within
rtol 1e-5 (a sample's outputs on 99.9% of the lanes, all within 1e-3;
Klems and TensorTree read their tables by plain indexing,
Dupuy-Jakob through K3's plain version here); the sample/pdf consistency
of tests/test_components.py:598; the furnace closures of the Klems and
TensorTree uniform transmitters and Dupuy-Jakob against Lambert on the
port; renders at spi 1, 32x32, one measured kind a scene, by the render
bar of tests/test_torch_render.py; an albedo gradient through a
Dupuy-Jakob tint against jax.grad and the port's central differences."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import ignis_tpu
import ignis_tpu_torch
from ignis_tpu.core.vec import Color as JColor, Vec3 as JVec3
from ignis_tpu.models import bsdf as JB
from ignis_tpu.models import djmeasured as JDJ
from ignis_tpu.models import klems as JK
from ignis_tpu.models import tensortree as JTT
from ignis_tpu.core.frame import make_frame as jmake_frame
from ignis_tpu.parallel.mesh import loss_fn as jax_loss_fn
from ignis_tpu.scene import djmeasured as jdjl
from ignis_tpu.scene import klems as jkl
from ignis_tpu.scene import tensortree as jttl
from ignis_tpu_torch import loss_fn
from ignis_tpu_torch.bridge import from_reference, param_from_reference, \
    to_numpy
from ignis_tpu_torch.core.frame import make_frame
from ignis_tpu_torch.core.vec import Color, Vec3
from ignis_tpu_torch.models import bsdf as B
from ignis_tpu_torch.models import djmeasured as DJ
from ignis_tpu_torch.models import klems as K
from ignis_tpu_torch.models import tensortree as TT
from ignis_tpu_torch.scene import djmeasured as djl
from ignis_tpu_torch.scene import klems as kl
from ignis_tpu_torch.scene import tensortree as ttl

from test_components import BASE, _klems_xml
from test_torch_grad import _port_fd_check
from test_torch_pexpr import render_bar, render_both

# The tensors here are small; one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

N = 4096


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("measured")
    out = {}
    _klems_xml(d / "k9.xml", 1.0 / np.pi)
    out["klems9"] = d / "k9.xml"
    chip_smoke.write_klems_xml(d / "k145.xml")
    out["klems145"] = d / "k145.xml"
    for name, depth, ndim in (("tt3_d0", 0, 3), ("tt3_d4", 4, 3),
                              ("tt4_d2", 2, 4)):
        chip_smoke.write_tensortree_xml(d / f"{name}.xml", depth, ndim)
        out[name] = d / f"{name}.xml"
    chip_smoke.write_dj_file(d / "dj_iso.bsdf", T=8, R=16)
    out["dj_iso"] = d / "dj_iso.bsdf"
    chip_smoke.write_dj_file(d / "dj_aniso.bsdf", T=6, R=16, phis=4)
    out["dj_aniso"] = d / "dj_aniso.bsdf"
    return out


def _loader(name):
    if name.startswith("klems"):
        return kl.load_klems, jkl.load_klems
    if name.startswith("tt"):
        return ttl.load_tensortree, jttl.load_tensortree
    return djl.load_djmeasured, jdjl.load_djmeasured


def _np_leaves(obj, prefix=""):
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for f in obj._fields:
            yield from _np_leaves(getattr(obj, f), f"{prefix}.{f}")
    else:
        yield prefix, np.asarray(obj)


@pytest.mark.parametrize("name", ["klems9", "klems145", "tt3_d0", "tt3_d4",
                                  "tt4_d2", "dj_iso", "dj_aniso"])
def test_loaders_match_jax(files, name):
    mine, ref = _loader(name)
    a, b = mine(files[name]), ref(files[name])
    la, lb = dict(_np_leaves(a)), dict(_np_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


# --- the models, pointwise ---------------------------------------------------------

def _unit(rs, n=N):
    v = rs.normal(size=(3, n)).astype(np.float32)
    return v / np.linalg.norm(v, axis=0)


def _pair(a):
    """(jnp array, torch tensor) of one numpy array."""
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _vecs(a):
    j, t = zip(*[_pair(c) for c in a])
    return JVec3(*j), Vec3(*t)


def _close(got, want, what, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _close_sampled(got, want, what):
    """A sample's outputs: 99.9% of the lanes within rtol 1e-5, all
    within rtol 1e-3 (a sampled half vector near the pole divides by
    u_wm.x sin(theta_m), which magnifies an ulp of XLA's and torch's
    asin / atan2)."""
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    ok = np.isclose(a, b, rtol=1e-5, atol=1e-6, equal_nan=True)
    assert ok.mean() >= 0.999, (what, ok.mean())
    _close(a, b, what, rtol=1e-3)


def _frames(seed):
    rs = np.random.RandomState(seed)
    n, up, wi, wo = (_vecs(_unit(rs)) for _ in range(4))
    ent = rs.rand(N) < 0.7
    us = [_pair(rs.rand(N).astype(np.float32)) for _ in range(3)]
    base = _vecs(rs.uniform(0.2, 1.0, (3, N)).astype(np.float32))
    return n, up, _pair(ent), wi, wo, us, base


def _tables(files, name):
    mine, ref = _loader(name)
    raw = ref(files[name])
    if name.startswith("klems"):
        return K.from_numpy(raw), JK.from_numpy(raw)
    if name.startswith("tt"):
        return TT.from_numpy(raw), JTT.from_numpy(raw)
    return DJ.from_numpy(raw), JDJ.from_numpy(raw)


@pytest.mark.parametrize("name", ["klems9", "klems145", "tt3_d0", "tt3_d4",
                                  "tt4_d2"])
def test_klems_and_tensortree_models_match_jax(files, name):
    """eval, pdf and sample in the Klems frame of random normals, up
    vectors and sides, on random directions (the depth-0 tree runs the
    peak-extraction probes)."""
    tdata, jdata = _tables(files, name)
    (jn, tn), (jup, tup), (jent, tent), (jwi, twi), (jwo, two), us, \
        (jb, tb) = _frames(1)
    jf = JK.make_klems_frame(jn, jent, jup)
    tf = K.make_klems_frame(tn, tent, tup)
    for a, b in zip(tf, jf):
        for x, y in zip(a, b):
            _close(x, y, "frame")
    jlib, tlib = (JK, K) if name.startswith("klems") else (JTT, TT)
    ev = "klems_eval" if name.startswith("klems") else "tt_eval"
    pd = "klems_pdf" if name.startswith("klems") else "tt_pdf"
    sm = "klems_sample" if name.startswith("klems") else "tt_sample"
    jbase, tbase = JColor(*jb), Color(*tb)
    for x, y in zip(getattr(tlib, ev)(tdata, tbase, tf, twi, two),
                    getattr(jlib, ev)(jdata, jbase, jf, jwi, jwo)):
        _close(x, y, f"{name} eval")
    _close(getattr(tlib, pd)(tdata, tf, twi, two),
           getattr(jlib, pd)(jdata, jf, jwi, jwo), f"{name} pdf")
    got = getattr(tlib, sm)(tdata, tbase, tf, two, *[u[1] for u in us])
    want = getattr(jlib, sm)(jdata, jbase, jf, jwo, *[u[0] for u in us])
    for what, x, y in zip(("dir", "pdf", "weight", "valid", "peak"),
                          got, want):
        for a, b in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            _close_sampled(a, b, f"{name} sample {what}")


@pytest.mark.parametrize("name", ["dj_iso", "dj_aniso"])
def test_dupuy_jakob_model_matches_jax(files, name):
    """eval, pdf and sample on random local directions (both sides), the
    corner values through K3's plain version."""
    tdata, jdata = _tables(files, name)
    _, _, _, (jwi, twi), (jwo, two), us, (jb, tb) = _frames(2)
    jt, tt = JColor(*jb), Color(*tb)
    for x, y in zip(DJ.dj_eval(tdata, tt, twi, two),
                    JDJ.dj_eval(jdata, jt, jwi, jwo)):
        _close(x, y, f"{name} eval")
    _close(DJ.dj_pdf(tdata, twi, two), JDJ.dj_pdf(jdata, jwi, jwo),
           f"{name} pdf")
    got = DJ.dj_sample(tdata, tt, two, *[u[1] for u in us])
    want = JDJ.dj_sample(jdata, jt, jwo, *[u[0] for u in us])
    for what, x, y in zip(("dir", "pdf", "weight", "valid"), got, want):
        for a, b in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            _close_sampled(a, b, f"{name} sample {what}")


def test_dispatch_of_mixed_rows_matches_jax(files):
    """eval_bsdf, pdf_bsdf and sample_bsdf over lanes of five rows (a
    diffuse, a Klems, a TensorTree, a Dupuy-Jakob and a second Klems
    table) against the JAX dispatch (_measured_dispatch by q6)."""
    tabs = [_tables(files, n) for n in ("klems145", "tt3_d4", "dj_iso",
                                        "klems9")]
    tmeas = tuple(t for t, _ in tabs)
    jmeas = tuple(j for _, j in tabs)
    rs = np.random.RandomState(3)
    rows = rs.randint(0, 5, N)
    kind = np.array([0, 11, 12, 13, 11], np.int32)[rows]
    q6 = np.array([0, 0, 1, 2, 3], np.float32)[rows]
    zero = np.zeros(N, np.float32)
    cols = {"kind": kind, "q6": q6}
    base = rs.uniform(0.2, 1.0, (3, N)).astype(np.float32)
    extra2 = _unit(rs)
    jm = JB.MatParams(**{
        f: (jnp.asarray(cols[f]) if f in cols else
            JColor(*[jnp.asarray(c) for c in base]) if f == "base" else
            JColor(*[jnp.asarray(c) for c in extra2]) if f == "extra2" else
            JColor(*[jnp.asarray(zero)] * 3) if f == "extra" else
            jnp.asarray(zero)) for f in JB.MatParams._fields})
    tm = B.MatParams(**{
        f: (torch.from_numpy(cols[f]) if f in cols else
            Color(*[torch.from_numpy(c) for c in base]) if f == "base" else
            Color(*[torch.from_numpy(c) for c in extra2]) if f == "extra2"
            else Color(*[torch.from_numpy(zero)] * 3) if f == "extra" else
            torch.from_numpy(zero)) for f in B.MatParams._fields})
    (jn, tn), _, (jent, tent), (jwi, twi), (jwo, two), us, _ = _frames(4)
    jfr, tfr = jmake_frame(jn), make_frame(tn)
    present = (0, 11, 12, 13)
    for x, y in zip(B.eval_bsdf(tm, tfr, tent, twi, two, present, tmeas),
                    JB.eval_bsdf(jm, jfr, jent, jwi, jwo, present, jmeas)):
        _close(x, y, "eval")
    _close(B.pdf_bsdf(tm, tfr, tent, twi, two, present, tmeas),
           JB.pdf_bsdf(jm, jfr, jent, jwi, jwo, present, jmeas), "pdf")
    got = B.sample_bsdf(tm, tfr, tent, two, *[u[1] for u in us], present,
                        False, tmeas)
    want = JB.sample_bsdf(jm, jfr, jent, jwo, *[u[0] for u in us], present,
                          False, jmeas)
    for f, x, y in zip(B.BsdfSample._fields, got, want):
        for a, b in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            _close_sampled(a, b, f"sample {f}")


def test_klems_sample_pdf_consistency(files):
    """tests/test_components.py:598 on the port: sample()'s pdf equals
    pdf() at the sampled direction, and E[f cos / pdf] recovers the
    1/pi transmitter's albedo of 1."""
    kd = K.from_numpy(kl.load_klems(files["klems9"]))
    rs = np.random.RandomState(7)
    z = torch.ones(N)
    kf = K.make_klems_frame(Vec3(0 * z, 0 * z, z), z > 0, Vec3(0, 1, 0))
    wo = Vec3(0 * z + 0.3, 0 * z, 0 * z + 0.954)
    u0, u1, u2 = (torch.from_numpy(rs.rand(N).astype(np.float32))
                  for _ in range(3))
    wi, pdf, w, valid = K.klems_sample(kd, Color(z, z, z), kf, wo, u0, u1,
                                       u2)
    pdf2 = K.klems_pdf(kd, kf, wi, wo)
    assert torch.allclose(pdf, pdf2, rtol=1e-4)
    assert bool(valid.all())
    assert abs(float(w.r.mean()) - 1.0) < 0.05


# --- renders ---------------------------------------------------------------------

def _furnace(bsdf):
    sc = json.loads(json.dumps(BASE))
    sc["camera"]["fov"] = 40
    sc["shapes"][0]["width"] = 6
    sc["shapes"][0]["height"] = 6
    sc["bsdfs"] = [bsdf]
    sc["lights"] = [{"type": "env", "name": "E", "radiance": [1, 1, 1]}]
    return sc


def _port_mean(sc, spi):
    rt = ignis_tpu_torch.loadFromString(json.dumps(sc), device="cpu",
                                        spi=spi)
    assert rt.warnings == []
    img = rt.step().framebuffer(normalized=True).numpy()
    assert np.isfinite(img).all()
    return img.mean()


def test_furnace_closures_on_the_port(files, tmp_path):
    """tests/test_components.py:191 and :207 on the port: a constant-BTDF
    (1/pi) Klems and TensorTree3 window in a unit environment transmits
    1; and :392: a Dupuy-Jakob file that encodes a Lambertian renders as
    the diffuse BSDF (means within 1%)."""
    assert abs(_port_mean(_furnace({"type": "klems", "name": "g",
                                    "filename": str(files["klems9"])}),
                          64) - 1.0) < 0.03
    tt = tmp_path / "tt.xml"
    data = "{ %.8f }" % (1.0 / np.pi)
    blk = ("<WavelengthData><Wavelength>Visible</Wavelength>"
           "<WavelengthDataBlock><WavelengthDataDirection>DIR"
           "</WavelengthDataDirection><AngleBasis>LBNL/Shirley-Chiu"
           "</AngleBasis><ScatteringData>" + data + "</ScatteringData>"
           "</WavelengthDataBlock></WavelengthData>")
    tt.write_text("<WindowElement><Optical><Layer><DataDefinition>"
                  "<IncidentDataStructure>TensorTree3</IncidentDataStructure>"
                  "</DataDefinition>"
                  + blk.replace("DIR", "Transmission Front")
                  + blk.replace("DIR", "Transmission Back")
                  + "</Layer></Optical></WindowElement>")
    assert abs(_port_mean(_furnace({"type": "tensortree", "name": "g",
                                    "filename": str(tt)}), 64) - 1.0) < 0.03
    T, R, rho = 8, 16, 0.8
    chip_smoke.write_tensor_file(tmp_path / "lambert.bsdf", {
        "theta_i": np.linspace(0, np.pi / 2 * 0.98, T).astype(np.float32),
        "phi_i": np.array([-np.pi, np.pi], np.float32),
        "ndf": np.ones((R, R), np.float32),
        "sigma": np.full((R, R), 0.25, np.float32),
        "vndf": np.ones((2, T, R, R), np.float32),
        "luminance": np.ones((2, T, R, R), np.float32),
        "rgb": np.full((2, T, 3, R, R), rho / np.pi, np.float32),
        "jacobian": np.zeros((1,), np.uint8)})
    sc = json.loads(json.dumps(BASE))
    sc["bsdfs"] = [{"type": "djmeasured", "name": "g",
                    "filename": str(tmp_path / "lambert.bsdf")}]
    ref = json.loads(json.dumps(BASE))
    ref["bsdfs"] = [{"type": "diffuse", "name": "g",
                     "reflectance": [rho] * 3}]
    a, b = _port_mean(sc, 32), _port_mean(ref, 32)
    assert abs(a - b) / b < 0.01


MEASURED_BSDFS = {
    "klems145": {"type": "klems", "up": [0, 1, 0]},
    "tt3_d4": {"type": "tensortree", "up": [0, 1, 0]},
    "dj_iso": {"type": "djmeasured", "tint": [1.0, 0.9, 0.8]},
}


def measured_scene(files, name):
    """BASE with a measured BSDF on a quad in front of the wall, under a
    point light and a constant env (max_depth 3)."""
    sc = json.loads(json.dumps(BASE))
    sc["bsdfs"].append({**MEASURED_BSDFS[name], "name": "m",
                        "filename": str(files[name])})
    sc["shapes"].append({"type": "rectangle", "name": "Q", "width": 1.2,
                         "height": 1.2, "flip_normals": True})
    sc["entities"].append({"name": "Q", "shape": "Q", "bsdf": "m",
                           "transform": [{"rotate": [0, 30, 0]},
                                         {"translate": [0.2, 0, -0.8]}]})
    sc["lights"].append({"type": "env", "name": "E",
                         "radiance": [0.3, 0.3, 0.4]})
    return sc


@pytest.mark.parametrize("name", sorted(MEASURED_BSDFS))
def test_measured_scene_renders_as_jax(files, name):
    got, ref, rt = render_both(measured_scene(files, name))
    render_bar(got, ref)
    assert len(rt.scene.measured) == 1 and got.mean() > 0.01


def test_bridge_carries_measured_tables(files):
    """from_reference converts a JAX scene with measured tables (Dupuy
    -Jakob's fr and g as the one gather table) equal to the port's own
    build of the same JSON."""
    sc = measured_scene(files, "dj_iso")
    sc["bsdfs"].append({**MEASURED_BSDFS["klems145"], "name": "k",
                        "filename": str(files["klems145"])})
    sc["bsdfs"].append({**MEASURED_BSDFS["tt3_d4"], "name": "t",
                        "filename": str(files["tt3_d4"])})
    text = json.dumps(sc)
    jrt = ignis_tpu.loadFromString(text, spi=1)
    own = ignis_tpu_torch.loadFromString(text, device="cpu", spi=1)
    bridged, _ = from_reference(jrt.scene, jrt.settings, "cpu",
                                closures=own.settings)
    assert len(bridged.measured) == len(own.scene.measured) == 3
    for a, b in zip(bridged.measured, own.scene.measured):
        assert type(a) is type(b)
        la = [x for x in torch.utils._pytree.tree_leaves(a)
              if isinstance(x, torch.Tensor)]
        lb = [x for x in torch.utils._pytree.tree_leaves(b)
              if isinstance(x, torch.Tensor)]
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            assert torch.equal(x, y)
    for f in ("kind", "q6", "p0"):
        assert torch.equal(getattr(bridged.materials, f),
                           getattr(own.scene.materials, f))


def test_dupuy_jakob_albedo_gradient_matches_jax(files):
    """The albedo (materials.base, the Dupuy-Jakob tint) gradient of
    loss_fn on the Dupuy-Jakob scene at 16x16, spi 1, against jax.grad of
    the JAX package's loss_fn: the top entry within rtol 2e-2; then the
    port's gradient against its own central differences."""
    sc = measured_scene(files, "dj_iso")
    sc["film"] = {"size": [16, 16]}
    text = json.dumps(sc)
    jrt = ignis_tpu.loadFromString(text, spi=1)
    target = np.zeros((16, 16, 3), np.float32)
    jbase = jrt.scene.materials.base
    jloss, jgrad = jax.value_and_grad(jax_loss_fn)(
        {"base": jbase}, jrt.scene, jrt.settings, jnp.asarray(target),
        jnp.uint32(0), jnp.uint32(0))
    ref_g = np.stack([np.asarray(c) for c in jgrad["base"]])
    rt = ignis_tpu_torch.loadFromString(text, device="cpu", spi=1)
    scene, settings = rt.scene, rt.settings
    base = param_from_reference(jbase, "cpu")
    tgt = torch.from_numpy(target)
    loss = loss_fn({"base": base}, scene, settings, tgt, 0, 0)
    got_g = np.stack(to_numpy(torch.autograd.grad(loss, list(base))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-2)
    row = int(np.asarray(scene.materials.kind).tolist().index(13))
    assert ref_g[:, row].any()
    np.testing.assert_allclose(got_g[:, row], ref_g[:, row], rtol=2e-2,
                               atol=1e-7)
    p0 = np.stack(to_numpy(scene.materials.base)).copy()

    def loss_of(p):
        b = Color(*[torch.from_numpy(p[i].copy()) for i in range(3)])
        with torch.no_grad():
            return float(loss_fn({"base": b}, scene, settings, tgt, 0, 0))
    _port_fd_check(loss_of, p0, got_g)
