"""The frontends of ignis_tpu_torch in-process on the CPU (`--target
cpu`) against ignis_tpu's on the same scene, seed and files: the igcli
(`cli.main`: the EXR, PNG and HDR outputs by the render-parity bar of
tests/test_torch_render.py, the summary line and JSON keys, --stats and
--denoise), igtrace (`trace_cli.main`: ray by ray), and igutil
(`util_cli.main`: info's statistics, convert's images and meshes, glare's
table, inspect's measured-BSDF slices)."""
import json
import re

import numpy as np
import pytest
import torch

import chip_smoke
from ignis_tpu import cli as jax_cli
from ignis_tpu import trace_cli as jax_trace_cli
from ignis_tpu import util_cli as jax_util_cli
from ignis_tpu.utils.exr import load_exr_rgb as jax_load_exr
from ignis_tpu_torch import cli, trace_cli, util_cli
from ignis_tpu_torch.utils.exr import load_exr_rgb, read_exr
from ignis_tpu_torch.utils.image import load_image, save_image

from test_glare import _scene_img
from test_runtime_api import SCENE

torch.set_num_threads(1)


@pytest.fixture
def scene_file(tmp_path):
    f = tmp_path / "scene.json"
    f.write_text(json.dumps(SCENE))
    return f


def _close_film(got, want):
    """tests/test_torch_render.py's bar: >= 99% of the pixels within rtol
    1e-3 / atol 1e-4, the means within 0.5%."""
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert close >= 0.99, close
    assert abs(got.mean() - want.mean()) <= 0.005 * abs(want.mean())


SUMMARY = re.compile(r"^# [\d.]+/[\d.]+/[\d.]+ \(([\d.]+)/([\d.]+)/([\d.]+) "
                     r"Msamples/s\)$", re.M)


def test_cli_matches_jax(scene_file, tmp_path, capsys):
    args = [str(scene_file), "--spp", "8", "--spi", "2", "--seed", "3",
            "--json"]
    assert jax_cli.main(args + ["-o", str(tmp_path / "j.exr"),
                                "--target", "cpu"]) == 0
    jax_out = capsys.readouterr().out
    assert cli.main(args + ["-o", str(tmp_path / "p.exr"),
                            "--target", "cpu"]) == 0
    out = capsys.readouterr().out
    assert SUMMARY.search(out) and SUMMARY.search(jax_out)
    got, want = (json.loads(o.strip().splitlines()[-1])
                 for o in (out, jax_out))
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    for k in ("scene", "spp", "iterations"):
        assert got[k] == want[k]
    _close_film(load_exr_rgb(tmp_path / "p.exr"),
                jax_load_exr(str(tmp_path / "j.exr")))


@pytest.mark.parametrize("suffix", [".png", ".hdr"])
def test_cli_ldr_and_hdr_outputs_match_jax(scene_file, tmp_path, suffix,
                                           capsys):
    args = [str(scene_file), "--spp", "4", "--spi", "2", "--target", "cpu",
            "--width", "24", "--height", "20"]
    assert jax_cli.main(args + ["-o", str(tmp_path / f"j{suffix}")]) == 0
    assert cli.main(args + ["-o", str(tmp_path / f"p{suffix}")]) == 0
    capsys.readouterr()
    import cv2
    got = cv2.imread(str(tmp_path / f"p{suffix}"), cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(tmp_path / f"j{suffix}"), cv2.IMREAD_UNCHANGED)
    assert got.shape == want.shape == (20, 24, 3)
    if suffix == ".png":   # 8-bit: a pixel may round one step apart
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        _close_film(got[..., ::-1].astype(np.float32),
                    want[..., ::-1].astype(np.float32))
    np.testing.assert_array_equal(load_image(tmp_path / f"p{suffix}",
                                             linear=True).shape, (20, 24, 3))


def test_cli_stats_denoise_and_parameters(scene_file, tmp_path, capsys):
    """--stats prints the instrumented quantities and the section table;
    --denoise writes the NLM-denoised film; --Pn sets a registry
    parameter (tint 0.2 -> 0.8: 4x the film)."""
    base = [str(scene_file), "--spp", "4", "--spi", "2", "--target", "cpu"]
    assert cli.main(base + ["-o", str(tmp_path / "a.exr"), "--stats"]) == 0
    out = capsys.readouterr().out
    assert "Quantities (one instrumented iteration): BounceRay=" in out
    assert "Iteration+Compile" in out and "CameraRays" in out
    assert cli.main(base + ["-o", str(tmp_path / "b.exr"),
                            "--Pn", "tint", "0.8"]) == 0
    a, b = load_exr_rgb(tmp_path / "a.exr"), load_exr_rgb(tmp_path / "b.exr")
    assert abs(b.mean() / a.mean() - 4.0) < 0.01
    assert cli.main(base + ["-o", str(tmp_path / "d.exr"), "--denoise"]) == 0
    d = load_exr_rgb(tmp_path / "d.exr")
    assert np.isfinite(d).all() and not np.array_equal(d, a)


def test_cli_without_a_card_exits_2(scene_file, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for target in ([], ["--target", "auto"], ["--target", "gpu"]):
        assert cli.main([str(scene_file), "-o", str(tmp_path / "x.exr")]
                        + target) == 2
        assert "needs a CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x.exr").exists()
    assert cli.main([str(scene_file), "--target", "cpu", "--device",
                     "1"]) == 2


def test_trace_cli_matches_jax(scene_file, tmp_path, capsys):
    rays = tmp_path / "rays.txt"
    rng = np.random.default_rng(2)
    lines = []
    for k in range(40):
        d = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), 1.0])
        d /= np.linalg.norm(d)
        extra = " 0 0" if k % 2 else ""
        lines.append(f"0 0 -2 {d[0]} {d[1]} {d[2]}{extra}")
    rays.write_text("\n".join(lines) + "\n")
    args = [str(scene_file), "--spp", "4", "--seed", "1", "-i", str(rays)]
    assert jax_trace_cli.main(args + ["-o", str(tmp_path / "j.txt")]) == 0
    assert trace_cli.main(args + ["-o", str(tmp_path / "p.txt"),
                                  "--target", "cpu"]) == 0
    got = np.loadtxt(tmp_path / "p.txt")
    want = np.loadtxt(tmp_path / "j.txt")
    assert got.shape == want.shape == (40, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert trace_cli.main(args + ["--target", "cpu"]) == 0
    stdout = np.array([[float(x) for x in line.split()]
                       for line in capsys.readouterr().out.splitlines()])
    np.testing.assert_array_equal(stdout, got)
    empty = tmp_path / "empty.txt"
    empty.write_text("1 2\n")
    assert trace_cli.main([str(scene_file), "-i", str(empty),
                           "--target", "cpu"]) == 1


def _numbers(text):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e[-+]?\d+)?", text)]


@pytest.fixture
def hdr_file(tmp_path):
    rng = np.random.default_rng(4)
    img = (rng.random((30, 40, 3)) ** 3 * 20).astype(np.float32)
    img[2, 3] = [-1.0, 0.5, 0.5]
    f = tmp_path / "img.exr"
    save_image(f, img)
    return f


def test_util_info_matches_jax(hdr_file, capsys):
    assert jax_util_cli.main(["info", str(hdr_file)]) == 0
    want = capsys.readouterr().out
    assert util_cli.main(["info", str(hdr_file), "--target", "cpu"]) == 0
    got = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in got.splitlines()] == \
        [ln.split(":")[0] for ln in want.splitlines()]
    np.testing.assert_allclose(_numbers(got), _numbers(want), rtol=1e-6)


def test_util_glare_matches_jax(tmp_path, capsys):
    f = tmp_path / "g.exr"
    save_image(f, _scene_img(bg=0.3, src=3000.0))
    assert jax_util_cli.main(["glare", str(f)]) == 0
    want = capsys.readouterr().out
    out_map = tmp_path / "map.exr"
    assert util_cli.main(["glare", str(f), "-o", str(out_map),
                          "--target", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "DGP" in got and "Ev" in got and out_map.exists()
    # the table prints 3 decimals: within one step of the last digit
    # beside the metrics' rtol 1e-3
    a, b = np.array(_numbers(got)), np.array(_numbers(want))
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= 1e-3 * np.abs(b) + 1.001e-3)


def test_util_convert_images(hdr_file, tmp_path, capsys):
    """EXR -> PNG (exposure, offset) as the JAX tool's bytes decode, and
    EXR -> HDR -> EXR within RGBE's precision; both tools' HDRs decode
    alike; EXR -> JPEG, which this test once held to NotImplementedError,
    within 0.5 dB PSNR of the JAX tool's (OpenCV's) JPEG against the
    exact 8-bit PNG."""
    import cv2
    for tool, tag in ((util_cli, "p"), (jax_util_cli, "j")):
        assert tool.main(["convert", str(hdr_file),
                          str(tmp_path / f"{tag}.png"), "--exposure", "-2",
                          "--offset", "0.01"]) == 0
        assert tool.main(["convert", str(hdr_file),
                          str(tmp_path / f"{tag}.hdr")]) == 0
    capsys.readouterr()
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "p.png")),
                                  cv2.imread(str(tmp_path / "j.png")))
    assert util_cli.main(["convert", str(tmp_path / "p.hdr"),
                          str(tmp_path / "back.exr")]) == 0
    src = load_exr_rgb(hdr_file)
    back = load_exr_rgb(tmp_path / "back.exr")
    pos = np.maximum(src, 0.0)
    assert np.all(np.abs(back - pos) <= 2.0 ** -7 * pos.max(-1,
                                                             keepdims=True))
    np.testing.assert_array_equal(load_image(tmp_path / "p.hdr")[3:],
                                  load_image(tmp_path / "j.hdr")[3:])
    for out in ("x.jpg", "x.png"):
        assert util_cli.main(["convert", str(hdr_file),
                              str(tmp_path / out)]) == 0
    assert jax_util_cli.main(["convert", str(hdr_file),
                              str(tmp_path / "jx.jpg")]) == 0
    ours = cv2.imread(str(tmp_path / "x.jpg")).astype(np.float64)
    theirs = cv2.imread(str(tmp_path / "jx.jpg")).astype(np.float64)
    exact = cv2.imread(str(tmp_path / "x.png")).astype(np.float64)
    mse = [np.mean((a - exact) ** 2) for a in (ours, theirs)]
    assert 10 * np.log10(mse[1] / max(mse[0], 1e-12)) >= -0.5, mse
    assert util_cli.main(["convert", str(tmp_path / "s.txt"),
                          str(tmp_path / "x.exr")]) == 1


def test_util_convert_meshes_and_mitsuba(tmp_path, capsys):
    from ignis_tpu_torch.scene import mesh as meshlib
    from test_torch_runtime_api import MITSUBA_XML
    m = meshlib.make_ico_sphere((0, 0, 0), 1.0, 1)
    m.ensure_attributes()
    meshlib.save_obj(tmp_path / "s.obj", m)
    assert util_cli.main(["convert", str(tmp_path / "s.obj"),
                          str(tmp_path / "s.ply")]) == 0
    assert jax_util_cli.main(["convert", str(tmp_path / "s.obj"),
                              str(tmp_path / "j.ply")]) == 0
    assert (tmp_path / "s.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    (tmp_path / "m.xml").write_text(MITSUBA_XML)
    for tool, tag in ((util_cli, "p"), (jax_util_cli, "j")):
        assert tool.main(["convert", str(tmp_path / "m.xml"),
                          str(tmp_path / f"{tag}.json")]) == 0
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    capsys.readouterr()


@pytest.fixture(scope="module")
def measured_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("measured")
    chip_smoke.write_klems_xml(d / "k145.xml")
    chip_smoke.write_tensortree_xml(d / "tt3.xml", 2, 3)
    chip_smoke.write_dj_file(d / "dj.bsdf", T=8, R=16)
    return d


@pytest.mark.parametrize("name", ["k145.xml", "tt3.xml"])
def test_util_inspect_matches_jax(measured_files, name, tmp_path, capsys):
    """Klems (the matrix raster, numpy in both) and TensorTree (the port's
    models/tensortree.py against the JAX one's jnp): every layer within
    rtol 1e-6, the totals printed alike."""
    f = measured_files / name
    args = ["inspect", str(f), "--theta", "35", "--phi", "40", "--res", "48"]
    assert jax_util_cli.main(args + ["-o", str(tmp_path / "j.exr")]) == 0
    want_out = capsys.readouterr().out
    assert util_cli.main(args + ["-o", str(tmp_path / "p.exr"),
                                 "--target", "cpu"]) == 0
    got_out = capsys.readouterr().out
    assert got_out.replace("p.exr", "j.exr") == want_out
    got, _ = read_exr(tmp_path / "p.exr")
    want, _ = read_exr(tmp_path / "j.exr")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)
    assert max(float(np.abs(v).max()) for v in got.values()) > 0


def test_util_inspect_dupuy_jakob(measured_files, tmp_path, capsys):
    """The JAX tool indexes the [P, T, H, W, 3] table as [T, H, W, 3] and
    fails; the port evaluates models/djmeasured.py: fr * cos theta_o over
    the hemisphere, zero outside the disk, finite and not all zero."""
    f = measured_files / "dj.bsdf"
    args = ["inspect", str(f), "--res", "32"]
    with pytest.raises((IndexError, ValueError)):
        jax_util_cli.main(args + ["-o", str(tmp_path / "j.exr")])
    assert util_cli.main(args + ["-o", str(tmp_path / "p.exr"),
                                 "--target", "cpu"]) == 0
    capsys.readouterr()
    img = load_exr_rgb(tmp_path / "p.exr")
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert img.max() > 0 and img[0, 0].max() == 0
