#!/usr/bin/env python3
"""Drive ignis_tpu_torch's main path once on one CUDA card and check it.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, each
printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: K1 (csrc/bvh_walk.cu), K2 (csrc/isect_dense.cu), K3
   (csrc/gather_cols.cu), the MT replay (csrc/mt_replay_bwd.cu) and the
   native BVH builder, from the sources in the checkout, all at once;
3. K2 against its plain torch version on the card: random soups, and
   S2's and S4's main-path sets (camera, secondary and shadow rays, as
   phase 4 makes them for K1), exact on every lane and timed beside its
   floor bound and the dense bound;
4. K1 against its plain version on S1's BVH, and against K2 brute force
   on a 20,480-triangle icosphere; kernel and plain times; then K1 on
   three 262,144-ray sets of S1 and S3 shaped like the main path's
   (camera rays in pixel order, cosine secondary rays from their hits,
   shadow rays from those hits to S1's point light): exact against the
   plain walk, timed beside its bound, the deepest stack counted; and on
   S6's secondary set and two sets of its transparent-shadow walk
   (`crossing_sets`: the first and second closest hits along the shadow
   segments to its point light);
5. render S1-S6 at 512x512 through `loadFromString` (its default device,
   the card) and `Runtime.step()`, with every kernel's launch count reset
   just before and read just after; no plain version may run; then one more
   step of each under torch.profiler (render/profile.py): device time,
   busy share and top device consumers of that step. S5 (`s5_scene`) is
   the materials-and-lights scene: every analytic BSDF kind of the slice,
   a textured blend, a bump map, five light kinds, the hierarchy selector
   and the 4096x2048 substitute env (written as EXR into build/ and read
   back by the port's own loader). S6 (`s6_scene`) is the
   volumes-and-meshes scene: volpath through a glass ball full of fog,
   its 327,680-triangle icosphere written into build/ as a binary PLY and
   loaded as a `ply` shape, a passthrough box of a second medium, a thin
   glass pane (every NEE ray takes the crossing walk), a cylinder written
   as OBJ and loaded as `obj`, a cone and a disk;
6. reference checks: the analytic point-light oracle on the card, and
   card-vs-CPU renders of small scenes (S2, S4, S1 at subdivisions 3, S5
   at subdivisions 1 with a 256x128 env, S6 with its ball at subdivisions
   2, under the BVH threshold);
7. gradients: K3's gather and scatter-add against their plain versions
   on S1's attribute table (random rows, S1's camera hits with zero
   cotangents on the misses, every lane on one row, cotangents holding
   NaN, -0.0 and inf) and the MT replay against its plain version, with
   times (K3 on the random rows, the replay on S1's contended rays and on
   a random soup); `train_step` (albedo) on S1-S6 at 512x512, a
   roughness gradient on S5 (max_depth 4) and a geometry gradient on S1
   and S2, counts
   reset before and read after; one profiled train step per scene, in
   which torch's indexing_backward_kernel must take under 1% of the
   device time, and one profiled S1 geometry-gradient step; K3 on S5's
   material table (the material fetch of S5's camera hits) against its
   plain version, timed beside index_select / index_put_; every K3
   launch of one S1 and one S2
   geometry-gradient step recorded, checked and timed beside
   index_select / index_add and its bound; the K3 scatter at the albedo
   backward's shape beside index_put_; the albedo gradient on the card
   against the CPU's; K3 on S6's medium table (the medium fetch after
   S6's camera hits) as on S5's material table; one sigma gradient step
   of S6 (media.sigma_a and sigma_s; the estimator's gradient, biased by
   Russian roulette, see phase_sigma), and the sigma gradient of the
   small S6 on the card against the CPU's;
8. instancing and the other techniques: S7 (`S7_SCENE`, 1,024 instances
   of one 5,120-triangle icosphere through loadFromString(instancing=
   True): the groups' bytes on the card, forward steps with launches and
   host syncs a step and a profiled step, one albedo train step), the
   instanced render against the flattened one on _grid_scene(8) with the
   local soup through K1 and through K2; ao, debug, wireframe,
   lightvisibility, camera_check and env_check on S1's arrays, aept on
   S1's scene under S5's substitute env, S8 (`S8_BOX`) under lt and ppm
   (1,000,000 photons), each with its launches, host syncs and a profiled
   step; and every technique and the instanced render on the card
   against the CPU at 64x64 (`technique_card_vs_cpu`);
9. the scene-language slice: S9 (`s9_scene`: S5's camera and floor, the
   floor a PExpr texture reading the registry parameter `tint`, five
   icospheres of a 145-patch Klems window, a depth-4 TensorTree3, a
   Dupuy-Jakob ball, a rough plastic with a per-lane PExpr colour (and a
   PExpr roughness that folds to a constant at load) and a transform
   BSDF with a PExpr normal, under a perez sky with its sun;
   the measured files written into build/): forward steps with launches,
   host syncs and a profiled step, the Dupuy-Jakob K3 gathers of one step
   against their plain version and timed, setParameter('tint') with no
   rebuild (and tests/test_runtime_api.py's 4x ratio), an albedo train
   step with its peak memory; card against CPU at 64x64 of S9 at
   subdivisions 1 (K2), of each CIE sky and the Hosek sky, of
   VOL_SCENE's fog with a PExpr sigma_s, and of bake_texture2d;
then the run's wall time, one JSON line of kernel results (each kernel's
time beside its bound and, where one PyTorch call computes the same
function, that call's time), the nvidia-smi line again, and as the last
line
{"ok": true, "device": {...}}.
Imports nothing of JAX. `--profile-json PATH` also writes the renders'
timings and the profiled steps to PATH.
"""
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# S1: tests/test_compaction.py:17 SCENE, icosphere at subdivisions 7
# (327,682 triangles), film 512x512.
S1_GLASS_ICO7 = {
    "technique": {"type": "path", "max_depth": 8},
    "camera": {
        "type": "perspective", "fov": 60,
        "transform": [-1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 3.85, 0, 0, 0, 1],
    },
    "film": {"size": [512, 512]},
    "bsdfs": [
        {"type": "diffuse", "name": "white", "reflectance": [0.7, 0.7, 0.7]},
        {"type": "dielectric", "name": "glass", "int_ior": 1.55},
    ],
    "shapes": [
        {"type": "rectangle", "name": "floor", "width": 6, "height": 6},
        {"type": "icosphere", "name": "ball", "radius": 0.8,
         "subdivisions": 7},
    ],
    "entities": [
        {"name": "floor", "shape": "floor", "bsdf": "white",
         "transform": [{"rotate": [-90, 0, 0]}, {"translate": [0, -1, 0]}]},
        {"name": "ball", "shape": "ball", "bsdf": "glass"},
    ],
    "lights": [
        {"type": "point", "name": "l", "position": [2, 3, 2], "power": 60},
        {"type": "env", "name": "e", "radiance": [0.2, 0.25, 0.3]},
    ],
}

# S2: __graft_entry__.py:8 _SCENE (2 triangles + an analytic sphere),
# film 512x512.
S2_GRAFT_ENTRY = {
    "technique": {"type": "path", "max_depth": 6},
    "camera": {
        "type": "perspective", "fov": 60, "near_clip": 0.1, "far_clip": 100,
        "transform": [-1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 3.85, 0, 0, 0, 1],
    },
    "film": {"size": [512, 512]},
    "bsdfs": [
        {"type": "diffuse", "name": "white", "reflectance": [0.8, 0.8, 0.8]},
        {"type": "dielectric", "name": "glass", "int_ior": 1.55},
    ],
    "shapes": [
        {"type": "rectangle", "name": "floor", "width": 4, "height": 4},
        {"type": "sphere", "name": "ball", "radius": 0.5},
    ],
    "entities": [
        {"name": "floor", "shape": "floor", "bsdf": "white",
         "transform": [{"rotate": [-90, 0, 0]}, {"translate": [0, -1, 0]}]},
        {"name": "ball", "shape": "ball", "bsdf": "glass"},
    ],
    "lights": [
        {"type": "point", "name": "l", "position": [0, 2, 2], "power": 50},
        {"type": "env", "name": "e", "radiance": [0.1, 0.1, 0.2]},
    ],
}

# S3: bench.py:331 BIG_SCENE, uvsphere 400x500 (400,000 triangles).
S3_BENCH_BIG = {
    "technique": {"type": "path", "max_depth": 4},
    "camera": {"type": "perspective", "fov": 60,
               "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -4,
                             0, 0, 0, 1]},
    "film": {"size": [512, 512]},
    "bsdfs": [{"type": "diffuse", "name": "w"}],
    "shapes": [{"type": "uvsphere", "name": "s", "radius": 1.2,
                "stacks": 400, "slices": 500}],
    "entities": [{"name": "s", "shape": "s", "bsdf": "w"}],
    "lights": [{"type": "env", "name": "e", "radiance": 1.0}],
}

# S4: S1's scene with the icosphere at subdivisions 2: 320 ball triangles
# and the floor's 2, below the BVH threshold, so K2 serves it.
S4_GLASS_ICO2 = json.loads(json.dumps(S1_GLASS_ICO7))
S4_GLASS_ICO2["shapes"][1]["subdivisions"] = 2

SCENES = (("S1_glass_ico7", S1_GLASS_ICO7, "K1"),
          ("S2_graft_entry", S2_GRAFT_ENTRY, "K2"),
          ("S3_bench_big", S3_BENCH_BIG, "K1"),
          ("S4_glass_ico2", S4_GLASS_ICO2, "K2"))
S5_NAME = "S5_materials_env4k"
KERNEL_OF = {name: kernel for name, _, kernel in SCENES} | {S5_NAME: "K1"}
S5_ENV = (4096, 2048)          # the substitute env's texels (utils/envgen)

# S5's nine balls, row by row: every analytic BSDF of the slice that needs
# no transparent shadows, and a blend whose weight is a texture
S5_BALLS = (
    {"type": "conductor", "material": "gold"},
    # anisotropic: roughness 0.3 as tests/test_parallel.py:204, stretched
    {"type": "roughconductor", "material": "copper", "roughness": 0.3,
     "anisotropic": 0.5},
    {"type": "plastic", "diffuse_reflectance": [0.1, 0.3, 0.7]},
    {"type": "roughplastic", "diffuse_reflectance": [0.7, 0.2, 0.1],
     "roughness": 0.2},
    {"type": "phong", "specular_reflectance": [0.6, 0.6, 0.5],
     "exponent": 40},
    {"type": "principled", "base_color": [0.8, 0.3, 0.3], "roughness": 0.4,
     "clearcoat": 1.0, "clearcoat_gloss": 0.8, "sheen": 1.0,
     "sheen_tint": 0.5},
    {"type": "principled", "base_color": [0.9, 0.9, 0.95], "roughness": 0.1,
     "specular_transmission": 0.9},
    {"type": "roughdielectric", "int_ior": 1.5, "roughness": 0.15},
    {"type": "blend", "first": "s5_diffuse", "second": "s5_rough_metal",
     "weight": "s5_checker"},
)


def s5_scene(env_file, subdivisions=5, size=512):
    """S5_materials_env4k, from in-repo sources only: S1's camera and floor
    (tests/test_compaction.py:17-40; the floor at y = -1), the floor a
    bumpmap (noise, strength
    0.5) over a diffuse with brick reflectance (tests/test_components.py
    :62-75), nine icospheres of radius 0.35 on a 3x3 grid (S5_BALLS), an
    env light with the image `env_file` as radiance, a spot
    (tests/test_analytic.py:55), a 0.4x0.4 area light
    (tests/test_components.py:472-477), a directional light and a sun;
    the hierarchy light selector. At subdivisions 5: 184,324 triangles."""
    balls, bsdfs, ents = [], [], []
    for i, b in enumerate(S5_BALLS):
        x, z = 0.9 * (i % 3 - 1), 0.9 * (i // 3 - 1)
        balls.append({"type": "icosphere", "name": f"ball{i}",
                      "radius": 0.35, "subdivisions": subdivisions})
        bsdfs.append({**b, "name": f"m{i}"})
        ents.append({"name": f"ball{i}", "shape": f"ball{i}",
                     "bsdf": f"m{i}",
                     "transform": [{"translate": [x, -0.65, z]}]})
    return {
        "technique": {"type": "path", "max_depth": 8,
                      "light_selector": "hierarchy"},
        "camera": S1_GLASS_ICO7["camera"],
        "film": {"size": [size, size]},
        "textures": [
            {"type": "brick", "name": "bricks", "color0": [0.2, 0.1, 0.1],
             "color1": [0.7, 0.3, 0.2]},
            {"type": "noise", "name": "bump_src", "scale": 8},
            {"type": "checkerboard", "name": "s5_checker", "scale_x": 8,
             "scale_y": 8},
            {"type": "image", "name": "env", "filename": str(env_file)},
        ],
        "bsdfs": [
            {"type": "diffuse", "name": "floor_inner",
             "reflectance": "bricks"},
            {"type": "bumpmap", "name": "floor", "bsdf": "floor_inner",
             "map": "bump_src", "strength": 0.5},
            {"type": "diffuse", "name": "s5_diffuse",
             "reflectance": [0.7, 0.7, 0.2]},
            {"type": "roughconductor", "name": "s5_rough_metal",
             "material": "aluminum", "roughness": 0.25},
            {"type": "diffuse", "name": "black", "reflectance": [0, 0, 0]},
        ] + bsdfs,
        "shapes": [
            {"type": "rectangle", "name": "floor", "width": 6, "height": 6},
            {"type": "rectangle", "name": "lamp", "width": 0.4,
             "height": 0.4},
        ] + balls,
        "entities": [
            # the last transform of a list applies first: the floor is
            # turned to face +y, then lowered to y = -1, where the balls
            # rest (S1's list, the other way round, leaves its floor in
            # the camera's plane, y = 0); the lamp faces down at y = 0.9
            {"name": "floor", "shape": "floor", "bsdf": "floor",
             "transform": [{"translate": [0, -1, 0]},
                           {"rotate": [-90, 0, 0]}]},
            {"name": "lamp", "shape": "lamp", "bsdf": "black",
             "transform": [{"translate": [0.4, 0.9, 0.3]},
                           {"rotate": [90, 0, 0]}]},
        ] + ents,
        "lights": [
            {"type": "env", "name": "sky", "radiance": "env",
             "scale": [0.05, 0.05, 0.05]},
            {"type": "spot", "name": "spot", "cutoff": 45, "falloff": 45,
             "position": [-1.0, 1.5, 1.5], "direction": [0.4, -1, -0.6],
             "power": 20},
            {"type": "area", "name": "lamp", "entity": "lamp",
             "radiance": [6, 6, 6]},
            {"type": "directional", "name": "dir",
             "direction": [0.3, -1, -0.2], "irradiance": [0.3, 0.3, 0.35]},
            {"type": "sun", "name": "sun", "direction": [-0.4, 0.8, 0.5],
             "irradiance": [0.8, 0.75, 0.7]},
        ],
    }
S6_NAME = "S6_volume_meshes"
KERNEL_OF[S6_NAME] = "K1"
S6_SECTIONS = 16    # the cylinder's, cone's and disk's: the small S6 of
#                     phase 6 (ball at subdivisions 2) stays under the BVH
#                     threshold of 512 triangles, so K2 serves it


def s6_files(build_dir, subdivisions=7):
    """S6's mesh files in `build_dir`, written on every call by the port's
    writers (one numpy pass each, so a run always exercises them): the
    ball, an icosphere of radius 0.8 at `subdivisions`, as a binary PLY
    (save_ply); a cylinder as an OBJ (save_obj). Returns their paths."""
    from ignis_tpu_torch.scene import mesh as meshlib
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    ball = build_dir / f"s6_ico{subdivisions}.ply"
    meshlib.save_ply(ball, meshlib.make_ico_sphere((0, 0, 0), 0.8,
                                                   subdivisions))
    cyl = build_dir / "s6_cylinder.obj"
    meshlib.save_obj(cyl, meshlib.make_cylinder(
        (0, 0, 0), 0.3, (0, 0.9, 0), 0.3, S6_SECTIONS, True))
    return ball, cyl


def s6_scene(build_dir, subdivisions=7, size=512):
    """S6_volume_meshes: tests/test_compaction.py:88 VOL_SCENE's camera,
    floor, fog (sigma_a 0.1, sigma_s 0.6, g 0.2) and lights, volpath at
    max_depth 8, holding a glass ball (int_ior 1.1) full of the fog, its
    icosphere (subdivisions 7: 327,680 triangles) loaded from a binary
    PLY; a passthrough box full of a second medium (sigma_a 0.05, sigma_s
    0.3, g -0.3); a thin glass pane above them, which makes the scene
    glassy, so that every NEE ray takes the crossing walk; a cylinder
    loaded from an OBJ, and a cone and a disk as shapes."""
    ball, cyl = s6_files(build_dir, subdivisions)
    return {
        "technique": {"type": "volpath", "max_depth": 8},
        "camera": S1_GLASS_ICO7["camera"],
        "film": {"size": [size, size]},
        "bsdfs": [
            {"type": "diffuse", "name": "w", "reflectance": [0.7, 0.7, 0.7]},
            {"type": "dielectric", "name": "glass", "int_ior": 1.1},
            {"type": "passthrough", "name": "clear"},
            {"type": "dielectric", "name": "pane", "thin": True,
             "specular_transmittance": [0.9, 0.9, 0.8]},
            {"type": "diffuse", "name": "red", "reflectance": [0.7, 0.2, 0.1]},
            {"type": "plastic", "name": "blue",
             "diffuse_reflectance": [0.1, 0.2, 0.7]},
        ],
        "media": [
            {"type": "homogeneous", "name": "fog", "sigma_a": [0.1, 0.1, 0.1],
             "sigma_s": [0.6, 0.6, 0.6], "g": 0.2},
            {"type": "homogeneous", "name": "smoke",
             "sigma_a": [0.05, 0.05, 0.05], "sigma_s": [0.3, 0.3, 0.3],
             "g": -0.3},
        ],
        "shapes": [
            {"type": "rectangle", "name": "floor", "width": 6, "height": 6},
            {"type": "ply", "name": "ball", "filename": str(ball)},
            {"type": "box", "name": "box", "width": 0.8, "height": 0.8,
             "depth": 0.8},
            {"type": "rectangle", "name": "pane", "width": 2.4,
             "height": 2.4},
            {"type": "obj", "name": "cylinder", "filename": str(cyl)},
            {"type": "cone", "name": "cone", "p0": [0, 0, 0],
             "p1": [0, 0.95, 0], "radius": 0.35, "sections": S6_SECTIONS},
            {"type": "disk", "name": "disk", "normal": [0, 0, 1],
             "radius": 0.4, "sections": S6_SECTIONS},
        ],
        "entities": [
            {"name": "floor", "shape": "floor", "bsdf": "w",
             "transform": [{"rotate": [-90, 0, 0]},
                           {"translate": [0, -1, 0]}]},
            {"name": "ball", "shape": "ball", "bsdf": "glass",
             "inner_medium": "fog"},
            {"name": "box", "shape": "box", "bsdf": "clear",
             "inner_medium": "smoke",
             "transform": [{"translate": [-1.5, 0.45, 0]}]},
            # the last transform of a list applies first: turned to face
            # down, then raised to y = 1.5, between the lights and the rest
            {"name": "pane", "shape": "pane", "bsdf": "pane",
             "transform": [{"translate": [0, 1.5, 0]},
                           {"rotate": [90, 0, 0]}]},
            {"name": "cylinder", "shape": "cylinder", "bsdf": "red",
             "transform": [{"translate": [1.5, 0.05, -0.3]}]},
            {"name": "cone", "shape": "cone", "bsdf": "blue",
             "transform": [{"translate": [-0.9, 0.05, -1.2]}]},
            {"name": "disk", "shape": "disk", "bsdf": "red",
             "transform": [{"translate": [0.9, 0.6, -1.2]}]},
        ],
        "lights": [
            {"type": "point", "name": "l", "position": [2, 3, 2],
             "power": 60},
            {"type": "env", "name": "e", "radiance": [0.2, 0.25, 0.3]},
        ],
    }



S9_NAME = "S9_scene_language"
KERNEL_OF[S9_NAME] = "K1"
# the floor's texture: tests/test_runtime_api.py:27's registry parameter
# times a checker and a noise
S9_FLOOR = "tint * checkerboard(uv*8) * (0.5 + 0.5*perlin(uv*16))"
S9_TINT = 0.8
# a number property: the build folds it to its value at uv = 0 (as the
# JAX build's _prop_number does), so the ball's per-lane PExpr is its
# diffuse colour
S9_ROUGHNESS = "0.05 + 0.3*perlin(uv*8)"
S9_ROUGH_DIFFUSE = "color(0.2, 0.5, 0.3) * (0.6 + 0.8*perlin(uv*8))"
# the Cycles exporter's normal chain (TransformBSDF's `normal`)
S9_NORMAL = ("ensure_valid_reflection(Ng, V, bump(N, Nx, Ny, 0.05, "
             "0.5*voronoi(uv*12), fbm(uv*6)))")
S9_SUN = [0.4, 0.75, 0.5]
# the full LBNL Klems basis: theta bands (degrees) and phis a band, 145
# patches
KLEMS_THETA = (0, 5, 15, 25, 35, 45, 55, 65, 75, 90)
KLEMS_PHIS = (1, 8, 16, 20, 24, 24, 24, 16, 12)


def _klems_centres():
    """Unit vectors of the 145 patch centres of the full basis."""
    out = []
    for lo, hi, n in zip(KLEMS_THETA[:-1], KLEMS_THETA[1:], KLEMS_PHIS):
        t = math.radians(0.0 if lo == 0 else 0.5 * (lo + hi))
        for j in range(n):
            p = 2 * math.pi * j / n
            out.append((math.sin(t) * math.cos(p), math.sin(t) * math.sin(p),
                        math.cos(t)))
    return np.asarray(out)


def write_klems_xml(path, diffuse=0.15, peak=2.0, width=4.0, refl=0.4):
    """A Klems window of the full 145-patch basis filled from an analytic
    lobe (the format of tests/test_components.py:165 _klems_xml): entry
    (out, in) = (diffuse + peak * exp(-width * (1 - cos gamma))) / pi,
    gamma the angle between the patch centres (transmission peaks
    straight through), reflection scaled by `refl`."""
    c = _klems_centres()
    lobe = (diffuse + peak * np.exp(-width * (1.0 - c @ c.T))) / math.pi
    blocks = "".join(
        "<AngleBasisBlock><ThetaBounds>"
        f"<LowerTheta>{lo}</LowerTheta><UpperTheta>{hi}</UpperTheta>"
        f"</ThetaBounds><nPhis>{n}</nPhis></AngleBasisBlock>"
        for lo, hi, n in zip(KLEMS_THETA[:-1], KLEMS_THETA[1:], KLEMS_PHIS))
    basis = ("<AngleBasis><AngleBasisName>LBNL/Klems Full</AngleBasisName>"
             + blocks + "</AngleBasis>")

    def block(direction, m):
        data = " ".join("%.7g" % v for v in m.reshape(-1))
        return ("<WavelengthData><Wavelength>Visible</Wavelength>"
                "<WavelengthDataBlock>"
                f"<WavelengthDataDirection>{direction}"
                "</WavelengthDataDirection>"
                "<ColumnAngleBasis>LBNL/Klems Full</ColumnAngleBasis>"
                "<RowAngleBasis>LBNL/Klems Full</RowAngleBasis>"
                f"<ScatteringData>{data}</ScatteringData>"
                "</WavelengthDataBlock></WavelengthData>")
    Path(path).write_text(
        "<WindowElement><Optical><Layer><DataDefinition>"
        "<IncidentDataStructure>Columns</IncidentDataStructure>"
        + basis + "</DataDefinition>"
        + block("Transmission Front", lobe)
        + block("Transmission Back", lobe)
        + block("Reflection Front", refl * lobe)
        + block("Reflection Back", refl * lobe)
        + "</Layer></Optical></WindowElement>")


def _tt_lobe(p):
    """The TensorTree lobe at a cell centre p of [0, 1]^n: a peak at the
    first square's centre, fading along the other axes."""
    r2 = (p[0] - 0.5) ** 2 + (p[1] - 0.5) ** 2
    fade = 1.0 - sum(p[2:]) / max(len(p) - 2, 1)
    return (0.2 + 1.5 * math.exp(-r2 / 0.05) * fade) / math.pi


def _tt_tree(lo, size, depth):
    """The {}-nested TensorTree text of _tt_lobe over [0, 1]^len(lo):
    2^n children a node, child bit j the upper half of axis j
    (scene/tensortree.py _bake)."""
    n = len(lo)
    if depth == 0:
        return "{ %.7g }" % _tt_lobe([x + 0.5 * size for x in lo])
    half = 0.5 * size
    kids = [_tt_tree([lo[j] + half * ((k >> j) & 1) for j in range(n)],
                     half, depth - 1) for k in range(1 << n)]
    return "{ " + " ".join(kids) + " }"


def write_tensortree_xml(path, depth=4, ndim=3):
    """A TensorTree3 (or 4) window of the given depth (2^(ndim*depth)
    leaves) from an analytic lobe, in the format of
    tests/test_components.py:207, for the front and back transmission and
    reflection."""
    tree = _tt_tree([0.0] * ndim, 1.0, depth)

    def blk(d):
        return ("<WavelengthData><Wavelength>Visible</Wavelength>"
                "<WavelengthDataBlock>"
                f"<WavelengthDataDirection>{d}</WavelengthDataDirection>"
                "<AngleBasis>LBNL/Shirley-Chiu</AngleBasis>"
                f"<ScatteringData>{tree}</ScatteringData>"
                "</WavelengthDataBlock></WavelengthData>")
    Path(path).write_text(
        "<WindowElement><Optical><Layer><DataDefinition>"
        f"<IncidentDataStructure>TensorTree{ndim}</IncidentDataStructure>"
        "</DataDefinition>" + blk("Transmission Front")
        + blk("Transmission Back") + blk("Reflection Front")
        + blk("Reflection Back") + "</Layer></Optical></WindowElement>")


def write_tensor_file(path, fields):
    """A powitacq tensor file (tests/test_components.py:368
    _write_tensor_file)."""
    import struct
    names = list(fields)
    header = (b"tensor_file\x00" + bytes([1, 0])
              + struct.pack("<I", len(names)))
    pos = len(header)
    for n in names:
        pos += 2 + len(n) + 2 + 1 + 8 + 8 * fields[n].ndim
    metas = []
    for n in names:
        a = fields[n]
        dt = {np.dtype(np.uint8): 1, np.dtype(np.float32): 10}[a.dtype]
        metas.append((n, a, dt, pos))
        pos += a.nbytes
    out = bytearray(header)
    for n, a, dt, off in metas:
        out += struct.pack("<H", len(n)) + n.encode()
        out += struct.pack("<HB", a.ndim, dt) + struct.pack("<Q", off)
        for sz in a.shape:
            out += struct.pack("<Q", sz)
    for n, a, dt, off in metas:
        out += a.tobytes()
    Path(path).write_bytes(bytes(out))


def write_dj_file(path, T=16, R=32, phis=2, colour=(0.8, 0.5, 0.3)):
    """A Dupuy-Jakob (powitacq) tensor file of T theta_i nodes and an RxR
    grid: a glossy analytic lobe in u_wm.x over a uniform sampling
    density; `phis` phi_i nodes (2: isotropic)."""
    u = (np.arange(R) + 0.5) / R
    lobe = 0.1 + 0.9 * np.exp(-(u[None, :] ** 2) / 0.05) \
        * np.ones((R, 1))
    rgb = np.stack([c * lobe / math.pi for c in colour])
    write_tensor_file(path, {
        "theta_i": np.linspace(0, math.pi / 2 * 0.98, T).astype(np.float32),
        "phi_i": np.linspace(-math.pi, math.pi, phis).astype(np.float32),
        "ndf": np.ones((R, R), np.float32),
        "sigma": np.full((R, R), 0.25, np.float32),
        "vndf": np.ones((phis, T, R, R), np.float32),
        "luminance": np.ones((phis, T, R, R), np.float32),
        "rgb": np.broadcast_to(rgb, (phis, T, 3, R, R)).astype(np.float32),
        "jacobian": np.zeros((1,), np.uint8)})


def s9_files(build_dir):
    """S9's measured BSDF files in `build_dir`, written on every call: the
    145-patch Klems window, the depth-4 TensorTree3 and the Dupuy-Jakob
    file (T 16, R 32). Returns their paths."""
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    klems, tt, dj = (build_dir / "s9_klems145.xml",
                     build_dir / "s9_tensortree3_d4.xml",
                     build_dir / "s9_dj_t16_r32.bsdf")
    write_klems_xml(klems)
    write_tensortree_xml(tt)
    write_dj_file(dj)
    return klems, tt, dj


def s9_scene(build_dir, subdivisions=5, size=512):
    """S9_scene_language: S5's camera and floor layout (s5_scene), the
    floor a diffuse whose reflectance is the PExpr S9_FLOOR reading the
    number parameter `tint`; five icospheres of radius 0.35 (subdivisions
    5: 20,480 triangles each) on a row: a Klems window of the full
    145-patch basis, a depth-4 TensorTree3, a Dupuy-Jakob ball (T 16,
    R 32), a rough plastic whose diffuse colour is the PExpr
    S9_ROUGH_DIFFUSE (evaluated per lane) and whose roughness is the PExpr
    S9_ROUGHNESS (folded at load), and a transform BSDF whose `normal` is
    S9_NORMAL over a plastic; lit by a perez sky with its sun (clearness
    6, a clear sky: perez gives no sun at clearness 1). At subdivisions 5: 102,402 triangles."""
    klems, tt, dj = s9_files(build_dir)
    bsdfs = [
        {"type": "klems", "name": "window", "filename": str(klems),
         "up": [0, 1, 0]},
        {"type": "tensortree", "name": "tree", "filename": str(tt),
         "up": [0, 1, 0]},
        {"type": "djmeasured", "name": "dj", "filename": str(dj),
         "tint": [1.0, 0.9, 0.8]},
        {"type": "roughplastic", "name": "rough",
         "diffuse_reflectance": S9_ROUGH_DIFFUSE,
         "roughness": S9_ROUGHNESS},
        {"type": "transform", "name": "bumped", "bsdf": "bumped_inner",
         "normal": S9_NORMAL},
    ]
    balls, ents = [], []
    for i, b in enumerate(bsdfs):
        balls.append({"type": "icosphere", "name": f"ball{i}",
                      "radius": 0.35, "subdivisions": subdivisions})
        ents.append({"name": f"ball{i}", "shape": f"ball{i}",
                     "bsdf": b["name"],
                     "transform": [{"translate": [0.85 * (i - 2), -0.65,
                                                  0.3 * (i % 2)]}]})
    return {
        "technique": {"type": "path", "max_depth": 8},
        "camera": S1_GLASS_ICO7["camera"],
        "film": {"size": [size, size]},
        "parameters": {"tint": S9_TINT},
        "textures": [{"type": "expr", "name": "s9_floor",
                      "expr": S9_FLOOR}],
        "bsdfs": [
            {"type": "diffuse", "name": "floor", "reflectance": "s9_floor"},
            {"type": "plastic", "name": "bumped_inner",
             "diffuse_reflectance": [0.7, 0.6, 0.2]},
        ] + bsdfs,
        "shapes": [{"type": "rectangle", "name": "floor", "width": 6,
                    "height": 6}] + balls,
        "entities": [
            {"name": "floor", "shape": "floor", "bsdf": "floor",
             "transform": [{"translate": [0, -1, 0]},
                           {"rotate": [-90, 0, 0]}]},
        ] + ents,
        "lights": [{"type": "perez", "name": "sky", "direction": S9_SUN,
                    "clearness": 6, "brightness": 0.2}],
    }

SPI = 4
S1_LIGHT = (2.0, 3.0, 2.0)   # S1's, S4's and S6's point light
S2_LIGHT = (0.0, 2.0, 2.0)   # S2's

# The least time of a kernel: the larger of its bytes (each input read once,
# each output written once) over the card's memory rate and its operations
# over the fp32 rate outside the tensor cores, both the H100 SXM's published
# peaks (NVIDIA's data sheet, dense rates).
H100_BYTES_PER_S = 3.35e12
H100_FP32_PER_S = 67e12
SLAB_OPS = 22    # one child's slab test: 6 subtractions, 6 products, 10 min/max
MT_OPS = 42      # one Moeller-Trumbore test, from the ray to t, u and v
REPLAY_OPS = 150  # one ray of the MT replay: forward and hand-written adjoint


def flat_scene(size=256):
    """tests/test_analytic.py:16 flat_scene: the canonical flat plane."""
    return {
        "technique": {"type": "path", "max_depth": 2},
        "camera": {"type": "perspective", "fov": 90, "near_clip": 0.01,
                   "far_clip": 100,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -1]},
        "film": {"size": [size, size]},
        "bsdfs": [{"type": "diffuse", "name": "ground",
                   "reflectance": [1, 1, 1]}],
        "shapes": [{"type": "rectangle", "name": "Bottom", "width": 2,
                    "height": 2, "flip_normals": True}],
        "entities": [{"name": "Bottom", "shape": "Bottom", "bsdf": "ground"}],
        "lights": [],
    }


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


SPIN_CYCLES_PER_MS = 2_000_000   # at least 1 ms of torch.cuda._sleep on a
#                                  card clocked at up to 2 GHz (H100: 1.98)


def cuda_ms(fn, reps=10, warmup=2):
    """Median of `reps` CUDA-event timings of fn() after warm-up, in ms.

    A spin kernel (`torch.cuda._sleep`) keeps the device busy while the
    host enqueues each timing's start event, fn()'s work and end event, so
    the events bracket device time rather than the host's launch overhead.
    The spin lasts at least 2 ms and at least twice the host time of the
    last warm-up call (up to 50 ms), so that a slow host still enqueues
    fn() within it. A plain version that waits on the device inside fn()
    is timed with its host time, as it runs."""
    import torch
    host_ms = 0.0
    for _ in range(warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
    spin = int(min(max(2.0, 2.0 * host_ms), 50.0) * SPIN_CYCLES_PER_MS)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def random_soup(rng, n_tris, device):
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.ops.intersect import TriSoup
    import torch
    v0 = rng.uniform(-3, 3, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-0.6, 0.6, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.6, 0.6, (n_tris, 3)).astype(np.float32)

    def soa(a):
        return Vec3(*[torch.from_numpy(a[:, i].copy()).to(device)
                      for i in range(3)])
    vis = torch.from_numpy(rng.uniform(size=n_tris) < 0.7).to(device)
    return TriSoup(soa(v0), soa(e1), soa(e2)), vis


def random_rays(rng, n, device, extent=4.0, dead_frac=0.05):
    """Rays with random origins and directions; `dead_frac` of them dead
    (tmax < tmin)."""
    import torch
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.ops.intersect import Rays
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 1e30, np.float32)
    tmax[rng.uniform(size=n) < dead_frac] = -1.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Rays(Vec3(*[t(o[:, i]) for i in range(3)]),
                Vec3(*[t(d[:, i]) for i in range(3)]),
                t(np.zeros(n, np.float32)), t(tmax))


def rays_at_triangle(rng, soup, k, n, device):
    """n rays from random origins to random points inside triangle k of
    `soup`, so that every ray's winner can be k."""
    import torch
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.ops.intersect import Rays
    tri = [np.array([float(c[k]) for c in v], np.float32)
           for v in (soup.v0, soup.e1, soup.e2)]
    u = rng.uniform(size=(n, 1)).astype(np.float32)
    v = rng.uniform(size=(n, 1)).astype(np.float32)
    flip = (u + v) > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    target = tri[0] + u * tri[1] + v * tri[2]
    o = target + rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Rays(Vec3(*[t(o[:, i]) for i in range(3)]),
                Vec3(*[t(d[:, i]) for i in range(3)]),
                t(np.zeros(n, np.float32)), t(np.full(n, 1e30, np.float32)))


def camera_rays(scene, settings, n, device):
    """n camera rays of the scene's camera through random pixels."""
    import torch
    from ignis_tpu_torch.models.camera import generate_rays
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randint(0, settings.width, (n,), generator=g).to(device)
    y = torch.randint(0, settings.height, (n,), generator=g).to(device)
    sx = torch.rand(n, generator=g).to(device)
    sy = torch.rand(n, generator=g).to(device)
    return generate_rays(scene.camera, settings, x, y, sx, sy)


def cat_rays(a, b):
    import torch
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.ops.intersect import Rays
    c = lambda p, q: torch.cat([p, q]).contiguous()  # noqa: E731
    return Rays(Vec3(*[c(p, q) for p, q in zip(a.org, b.org)]),
                Vec3(*[c(p, q) for p, q in zip(a.dir, b.dir)]),
                c(a.tmin, b.tmin), c(a.tmax, b.tmax))


def main_path_sets(rt, device, light=S1_LIGHT, seed=17):
    """Three ray sets of the main path on rt's scene, one ray per pixel of
    its film, from `seed`: "camera", camera rays in pixel order with a
    random offset in each pixel, as the first bounce traces them (closest
    hits through trace_scene, K1 or K2 as the scene has a BVH or not);
    "secondary", rays from their hits in cosine-distributed directions
    about the shading normal (lanes whose camera ray missed are dead:
    tmax < tmin); "shadow", rays from those hits to a point light at
    `light` (any hit). Returns {name: (rays, any_hit)}."""
    import torch
    from ignis_tpu_torch.core.frame import make_frame
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.core.warp import sample_cosine_hemisphere
    from ignis_tpu_torch.models.camera import generate_rays
    from ignis_tpu_torch.ops.intersect import FLT_MAX, Rays
    from ignis_tpu_torch.techniques.path import (OFFSET, compute_surface,
                                                 trace_scene)
    scene, s = rt.scene, rt.settings
    n = s.width * s.height
    g = torch.Generator(device="cpu").manual_seed(seed)
    pix = torch.arange(n)
    x, y = (pix % s.width).to(device), (pix // s.width).to(device)
    sx, sy, u0, u1 = [torch.rand(n, generator=g).to(device)
                      for _ in range(4)]
    cam = generate_rays(scene.camera, s, x, y, sx, sy)
    hit = trace_scene(scene, cam)
    surf = compute_surface(scene, cam, hit)
    found = hit.prim >= 0
    local, _ = sample_cosine_hemisphere(u0, u1)
    d = make_frame(surf.ns).to_world(local)
    org = Vec3(*[a.contiguous() for a in surf.point])
    tmin = torch.full_like(hit.t, OFFSET)
    sec = Rays(org, Vec3(*[a.contiguous() for a in d]), tmin,
               torch.where(found, FLT_MAX, -1.0))
    to_light = Vec3(*[(c - a).contiguous() for c, a in zip(light, org)])
    shadow = Rays(org, to_light, tmin, torch.where(found, 1.0 - OFFSET, -1.0))
    return {"camera": (cam, False), "secondary": (sec, False),
            "shadow": (shadow, True)}


def crossing_sets(rt, device, light=S1_LIGHT, seed=17):
    """main_path_sets' secondary set and two sets of the transparent-
    shadow walk (path.shadow_transmittance) on rt's scene: "crossing 1",
    closest hits along the shadow segments from the camera hits to a
    point light at `light` (unnormalised directions, t in [o, 1 - o]), as
    the walk's first step traces them; "crossing 2", the same segments
    from just past those hits on (lanes that crossed nothing are dead)."""
    import torch
    from ignis_tpu_torch.ops.intersect import Rays
    from ignis_tpu_torch.techniques.path import OFFSET, trace_scene
    sets = main_path_sets(rt, device, light, seed)
    shadow, _ = sets["shadow"]
    first = trace_scene(rt.scene, shadow)
    more = first.prim >= 0
    second = Rays(shadow.org, shadow.dir,
                  torch.where(more, first.t + OFFSET, OFFSET).contiguous(),
                  torch.where(more, shadow.tmax, -1.0).contiguous())
    return {"secondary": sets["secondary"], "crossing 1": (shadow, False),
            "crossing 2": (second, False)}


def compare_hits(got, ref, what, bar, hit_mask=False):
    """Hold a closest-hit result against a reference: prim agreement
    > bar (and, with `hit_mask`, hit-mask agreement >= bar); at least 100
    lanes where both hit the same primitive; there, t within rtol 1e-4
    and u, v within rtol 1e-5 / atol 1e-6 on every lane; t within rtol
    1e-4 on a share >= bar of the lanes where both hit at all. Returns the
    largest |difference| of t, u or v where both hit the same primitive."""
    gt, gp, gu, gv = [x.cpu().numpy() for x in got]
    rt, rp, ru, rv = [x.cpu().numpy() for x in ref]
    agree = (gp == rp).mean()
    check(agree > bar, f"{what}: prim agreement {agree:.6f} > {bar}")
    if hit_mask:
        agree = ((gp >= 0) == (rp >= 0)).mean()
        check(agree >= bar, f"{what}: hit-mask agreement {agree:.6f} "
              f">= {bar}")
    both = (gp >= 0) & (rp >= 0)
    same = both & (gp == rp)
    n_same = int(same.sum())
    check(n_same >= 100, f"{what}: {n_same} lanes where both hit the same "
          f"primitive (>= 100)")
    # A flipped edge hit sends a lane to another triangle at another t, so
    # t is held to rtol 1e-4 (np.allclose's atol 1e-8, as tests/test_bvh.py)
    # on every lane where both hit the same primitive, and by share where
    # both hit at all.
    ok_t = np.isclose(gt, rt, rtol=1e-4, atol=1e-8)
    check(ok_t[same].all(), f"{what}: t within rtol 1e-4 on all {n_same} "
          f"lanes where both hit the same primitive")
    share = ok_t[both].mean()
    check(share >= bar, f"{what}: t within rtol 1e-4 on {share:.6f} "
          f"of {both.sum()} lanes where both hit")
    # Same primitive, same Moeller-Trumbore: the barycentrics feed normal
    # and uv interpolation, so they are held as tightly as t.
    for name, a, b in (("u", gu, ru), ("v", gv, rv)):
        ok = np.isclose(a[same], b[same], rtol=1e-5, atol=1e-6)
        check(ok.all(), f"{what}: {name} within rtol 1e-5 / atol 1e-6 on "
              f"all {n_same} lanes where both hit the same primitive")
    return max(float(np.abs(a[same] - b[same]).max())
               for a, b in ((gt, rt), (gu, ru), (gv, rv)))


def bound(n_bytes, n_ops):
    """(least time in ms, "bytes" or "operations") of work that moves
    n_bytes and does n_ops fp32 operations."""
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = n_ops / H100_FP32_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                             "operations")


def bvh_paths(bvh, n_tris):
    """(parent of each node, node of each triangle's leaf, children of each
    node) of a BVHArrays, in numpy."""
    child = bvh.child.cpu().numpy().astype(np.int64)
    parent = np.full(child.shape[0], -1)
    node, slot = np.nonzero(child > 0)
    parent[child[node, slot]] = node
    node, slot = np.nonzero(child < 0)
    code = -child[node, slot] - 1
    start, count = code >> 4, code & 15
    offsets = np.cumsum(count) - count
    owner = np.full(n_tris, -1)
    owner[np.repeat(start - offsets, count) + np.arange(count.sum())] = \
        np.repeat(node, count)
    return parent, owner, (child != 0).sum(1)


def k1_bound(rays, result, paths, any_hit):
    """K1's least time on these rays: ray arrays in (8 f32), results out
    (t, prim, u, v; or one occlusion byte), the root's records, and for
    closest hit each distinct winner's triangle row and the records of
    every node on its path from the root; operations: the root's slab
    tests of every live ray and one triangle test of every hit. What else
    a ray must read to prove its answer depends on the walk and is not
    counted, so this is a floor."""
    parent, owner, kids = paths
    n = rays.tmin.numel()
    live = int((rays.tmax >= rays.tmin).sum())
    n_bytes = 32 * n + (1 if any_hit else 16) * n
    n_ops = live * int(kids[0]) * SLAB_OPS
    on_path = np.zeros(len(parent), bool)
    on_path[0] = True
    if not any_hit:
        prim = result.prim.cpu().numpy()
        winners = np.unique(prim[prim >= 0])
        nodes = np.unique(owner[winners])
        while len(nodes):
            on_path[nodes] = True
            nodes = np.unique(parent[nodes])
            nodes = nodes[nodes >= 0]
            nodes = nodes[~on_path[nodes]]
        n_bytes += 48 * len(winners)
        n_ops += int((prim >= 0).sum()) * MT_OPS
    n_bytes += 32 * int(kids[on_path].sum())
    return bound(n_bytes, n_ops)


def k2_bound(rays, result, n_tris, any_hit):
    """K2's floor on these rays, in K1's terms: ray arrays in (8 f32),
    results out (t, prim, u, v; or one occlusion byte), the soup's packed
    rows read once (48 B a triangle); operations: one slab test of every
    live ray against the soup's box and one triangle test of every hit
    (for any hit, every occluded ray). A kernel that culls does fewer than
    every pair's tests, so the dense count (dense_bound) is no floor."""
    n = rays.tmin.numel()
    live = int((rays.tmax >= rays.tmin).sum())
    hits = int(result.sum()) if any_hit else int((result.prim >= 0).sum())
    return bound((32 + (1 if any_hit else 16)) * n + 48 * n_tris,
                 live * SLAB_OPS + hits * MT_OPS)


def dense_bound(n, n_tris):
    """The least time of every ray's test against every triangle: 48 B a
    ray and 36 B a triangle moved, n * n_tris triangle tests."""
    return bound(48 * n + 36 * n_tris, n * n_tris * MT_OPS)


def replay_bound(prim, n_tris):
    """The MT replay's least time: per ray 6 ray floats, the prim and 3
    cotangents in, 6 ray gradients out; each distinct winner's 9 soup
    floats in; the 9 [T] soup gradients out."""
    n = prim.numel()
    p = prim.cpu().numpy()
    winners = len(np.unique(p[p >= 0]))
    return bound(n * (10 + 6) * 4 + winners * 36 + 9 * 4 * n_tris,
                 int((p >= 0).sum()) * REPLAY_OPS)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    """Every library at once: one compiler process per source."""
    from concurrent.futures import ThreadPoolExecutor
    from ignis_tpu_torch.native import get_lib
    from ignis_tpu_torch.ops import (bvh_cuda, cuda_build, gather,
                                     isect_cuda, mt_replay)
    t0 = time.perf_counter()
    builds = (isect_cuda.build, bvh_cuda.build, gather.build,
              mt_replay.build, get_lib)
    with ThreadPoolExecutor(len(builds)) as pool:
        for f in [pool.submit(b) for b in builds]:
            f.result()
    print(f"  build seconds: {time.perf_counter() - t0:.2f}")
    for name, (sec, log) in cuda_build.BUILD_LOG.items():
        print(f"  {name}: " + (f"compiled in {sec:.2f} s" if log != "cached"
                               else "cached"))
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")


def phase_k2(device, n_rays=262144, sizes=(2, 256, 4096)):
    """K2 against its plain version on random soups."""
    from ignis_tpu_torch.ops import isect_cuda
    rng = np.random.default_rng(7)
    rays = random_rays(rng, n_rays, device)
    err = 0.0
    for n_tris in sizes:
        soup, vis = random_soup(rng, n_tris, device)
        got = isect_cuda.intersect_tris(rays, soup)
        ref = isect_cuda.intersect_tris_plain(rays, soup)
        err = max(err, compare_hits(got, ref, f"K2 T={n_tris}", 0.999))
        occ = isect_cuda.intersect_tris(rays, soup, vis, any_hit=True)
        occ_ref = isect_cuda.intersect_tris_plain(rays, soup, vis,
                                                  any_hit=True)
        agree = (occ == occ_ref).float().mean().item()
        check(agree >= 0.999, f"K2 T={n_tris}: any-hit agreement "
              f"{agree:.6f} >= 0.999")
    return err


def phase_k2_sets(device, runtimes, check_only=False):
    """K2 on main_path_sets of each runtime ({name: (Runtime, light)}),
    the soup packed beforehand as the main path packs it: against the
    plain version, prims equal on every lane, t, u and v bit for bit, any
    hit equal on every lane; unless check_only, its median time beside the
    plain version's, its floor (k2_bound) and the dense bound
    (dense_bound). Returns {"<scene> <set>": {...}}."""
    import torch
    from ignis_tpu_torch.ops import isect_cuda
    out = {}
    for name, (rt, light) in runtimes.items():
        sc = rt.scene
        n_tris = sc.tris.v0.x.numel()
        check(sc.bvh is None, f"{name}: {n_tris} triangles, no BVH (K2)")
        pack = isect_cuda.pack_soup(sc.tris)
        vis = sc.tri_attr.shadow_visible
        for set_name, (rays, any_hit) in main_path_sets(rt, device,
                                                        light).items():
            what = f"K2 {name} {set_name}"
            live = int((rays.tmax >= rays.tmin).sum())
            kw = dict(any_hit=any_hit, shadow_visible=vis if any_hit else None)
            got = isect_cuda.intersect_tris(rays, sc.tris, packed=pack, **kw)
            ref = isect_cuda.intersect_tris_plain(rays, sc.tris, **kw)
            if any_hit:
                check(torch.equal(got, ref), f"{what}: any hit equal on every "
                      f"lane ({int(ref.sum())} of {live} live rays occluded)")
                err = 0.0
            else:
                check(torch.equal(got.prim, ref.prim), f"{what}: prims equal "
                      f"on every lane ({int((ref.prim >= 0).sum())} of {live}"
                      f" live rays hit)")
                pairs = [(got.t, ref.t), (got.u, ref.u), (got.v, ref.v)]
                err = max(max_err(a, b) for a, b in pairs)
                check(all(torch.equal(a, b) for a, b in pairs),
                      f"{what}: t, u, v bit for bit (max |difference| {err})")
            row = {"rays": rays.tmin.numel(), "live": live,
                   "any_hit": any_hit, "max_abs_err": err}
            if not check_only:
                ms = cuda_ms(lambda: isect_cuda.intersect_tris(
                    rays, sc.tris, packed=pack, **kw))
                plain = cuda_ms(lambda: isect_cuda.intersect_tris_plain(
                    rays, sc.tris, **kw))
                bms, by = k2_bound(rays, got, n_tris, any_hit)
                row.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                           dense_ms=dense_bound(rays.tmin.numel(),
                                                n_tris)[0])
                print(f"  {what}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                      f"floor {bms:.5f} ms ({by}), dense "
                      f"{row['dense_ms']:.4f} ms, {live} live rays")
            out[f"{name} {set_name}"] = row
    return out


def phase_k1(device, s1, n_rays=65536):
    """K1 against its plain version on the BVH of `s1` (S1's runtime),
    and against K2; no stack push may be dropped."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda, isect_cuda
    scene, settings = s1.scene, s1.settings
    bvh_cuda.reset_overflow(device)
    rng = np.random.default_rng(11)
    half = n_rays // 2
    rays = cat_rays(camera_rays(scene, settings, half, device),
                    random_rays(rng, n_rays - half, device, extent=1.5))
    vis = scene.tri_attr.shadow_visible
    got = bvh_cuda.intersect_bvh(rays, scene.tris, scene.bvh)
    ref = bvh_cuda.intersect_bvh_plain(rays, scene.tris, scene.bvh)
    err = compare_hits(got, ref, "K1 S1", 0.995, hit_mask=True)
    occ = bvh_cuda.intersect_bvh(rays, scene.tris, scene.bvh, any_hit=True,
                                 shadow_visible=vis)
    occ_ref = bvh_cuda.intersect_bvh_plain(rays, scene.tris, scene.bvh,
                                           any_hit=True, shadow_visible=vis)
    agree = (occ == occ_ref).float().mean().item()
    check(agree >= 0.995, f"K1 S1: any-hit agreement {agree:.6f} >= 0.995")

    # cross-check against K2 brute force on a 20,480-triangle icosphere
    import ignis_tpu_torch
    ico = {"technique": {"type": "path"},
           "camera": {"type": "perspective", "fov": 60,
                      "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -4,
                                    0, 0, 0, 1]},
           "film": {"size": [32, 32]},
           "bsdfs": [{"type": "diffuse", "name": "w"}],
           "shapes": [{"type": "icosphere", "name": "s", "radius": 1.2,
                       "subdivisions": 5}],
           "entities": [{"name": "s", "shape": "s", "bsdf": "w"}],
           "lights": [{"type": "env", "name": "e", "radiance": 1.0}]}
    rt = ignis_tpu_torch.loadFromString(json.dumps(ico), device=device)
    sc = rt.scene
    check(sc.tris.v0.x.numel() == 20480 and sc.bvh is not None,
          "icosphere: 20,480 triangles with a BVH")
    rays2 = random_rays(rng, n_rays, device, extent=3.0)
    h1 = bvh_cuda.intersect_bvh(rays2, sc.tris, sc.bvh)
    h2 = isect_cuda.intersect_tris(rays2, sc.tris)
    compare_hits(h1, h2, "K1 vs K2 icosphere", 0.995, hit_mask=True)
    o1 = bvh_cuda.intersect_bvh(rays2, sc.tris, sc.bvh, any_hit=True)
    o2 = isect_cuda.intersect_tris(rays2, sc.tris, any_hit=True)
    agree = (o1 == o2).float().mean().item()
    check(agree >= 0.995, f"K1 vs K2 icosphere: any-hit agreement "
          f"{agree:.6f} >= 0.995")
    torch.cuda.synchronize()
    ovf = bvh_cuda.overflow_count(device)
    check(ovf == 0, f"K1 stack overflow counter {ovf} == 0")
    return err, rays


def phase_times(device, s1, k1_rays):
    """Median CUDA-event times of each kernel and its plain version, with
    the kernel's bound: K2 at S2's shape (random rays, its floor
    k2_bound), K1 on the 65,536 rays of phase_k1 (closest and any hit),
    the soup packed beforehand as the main path packs it."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda, isect_cuda
    rng = np.random.default_rng(5)
    out = {}
    # K2 at S2's shape: its 2-triangle soup and 262,144 lanes
    import ignis_tpu_torch
    s2 = ignis_tpu_torch.loadFromString(json.dumps(S2_GRAFT_ENTRY),
                                        device=device)
    rays = random_rays(rng, 262144, device)
    n_tris = s2.scene.tris.v0.x.numel()
    n = rays.tmin.numel()
    pack = isect_cuda.pack_soup(s2.scene.tris)
    res = isect_cuda.intersect_tris(rays, s2.scene.tris, packed=pack)
    out["K2"] = (cuda_ms(lambda: isect_cuda.intersect_tris(
                     rays, s2.scene.tris, packed=pack)),
                 cuda_ms(lambda: isect_cuda.intersect_tris_plain(
                     rays, s2.scene.tris)),
                 *k2_bound(rays, res, n_tris, False))
    sc = s1.scene
    rows = bvh_cuda.pack_tris(sc.tris)
    paths = bvh_paths(sc.bvh, sc.tris.v0.x.numel())
    vis = sc.tri_attr.shadow_visible
    for name, any_hit in (("K1", False), ("K1_any", True)):
        kw = dict(any_hit=any_hit, shadow_visible=vis if any_hit else None)
        res = bvh_cuda.intersect_bvh(k1_rays, sc.tris, sc.bvh, **kw)
        out[name] = (
            cuda_ms(lambda: bvh_cuda.intersect_bvh(k1_rays, sc.tris, sc.bvh,
                                                   tri_rows=rows, **kw)),
            cuda_ms(lambda: bvh_cuda.intersect_bvh_plain(
                k1_rays, sc.tris, sc.bvh, **kw), reps=10, warmup=1),
            *k1_bound(k1_rays, res, paths, any_hit))
    for k, (ms, plain, bms, by) in out.items():
        print(f"  {k}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bms:.4f} ms ({by})")
    torch.cuda.synchronize()
    return out


def phase_k1_sets(device, runtimes, check_only=False, sets_of=None):
    """K1 on main_path_sets (or `sets_of`) of each runtime ({name:
    Runtime}): exact
    against the plain walk (t, u and v bit for bit where the prims agree,
    prim agreement > 0.995, any-hit agreement >= 0.995), and,
    unless check_only, its median time with the soup packed beforehand, as
    the main path packs it, beside its bound. No stack push may be
    dropped. Returns {"<scene> <set>": {...}}."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda
    bvh_cuda.reset_overflow(device)
    out = {}
    for name, rt in runtimes.items():
        sc = rt.scene
        rows = bvh_cuda.pack_tris(sc.tris)
        paths = bvh_paths(sc.bvh, sc.tris.v0.x.numel())
        nodes = bvh_cuda.scene_nodes(sc.bvh)
        print(f"  {name}: {sc.bvh.child.shape[0]} nodes, "
              f"{nodes.records.shape[0]} node records "
              f"({nodes.records.numel() * 4 / 1e6:.1f} MB), {nodes.dropped} "
              f"empty child slots dropped")
        vis = sc.tri_attr.shadow_visible
        for set_name, (rays, any_hit) in (sets_of or main_path_sets)(
                rt, device).items():
            what = f"K1 {name} {set_name}"
            live = int((rays.tmax >= rays.tmin).sum())
            if any_hit:
                got = bvh_cuda.intersect_bvh(rays, sc.tris, sc.bvh, True, vis,
                                             tri_rows=rows)
                ref = bvh_cuda.intersect_bvh_plain(rays, sc.tris, sc.bvh,
                                                   True, vis)
                agree = (got == ref).float().mean().item()
                check(agree >= 0.995, f"{what}: any-hit agreement "
                      f"{agree:.6f} >= 0.995 ({int(ref.sum())} of {live} live "
                      f"rays occluded)")
                err, prim_agree = 0.0, None
            else:
                got = bvh_cuda.intersect_bvh(rays, sc.tris, sc.bvh,
                                             tri_rows=rows)
                ref = bvh_cuda.intersect_bvh_plain(rays, sc.tris, sc.bvh)
                same = got.prim == ref.prim
                prim_agree = float(same.float().mean())
                check(prim_agree > 0.995, f"{what}: prim agreement "
                      f"{prim_agree:.6f} > 0.995 ({int((ref.prim >= 0).sum())}"
                      f" of {live} live rays hit)")
                err = max(max_err(a[same], b[same]) for a, b in
                          zip((got.t, got.u, got.v), (ref.t, ref.u, ref.v)))
                check(err == 0.0, f"{what}: t, u, v bit for bit where the "
                      f"prims agree (max |difference| {err})")
                agree = None
            row = {"rays": rays.tmin.numel(), "live": live,
                   "any_hit": any_hit, "max_abs_err": err,
                   "prim_agreement": prim_agree, "any_hit_agreement": agree}
            if not check_only:
                ms = cuda_ms(lambda: bvh_cuda.intersect_bvh(
                    rays, sc.tris, sc.bvh, any_hit, vis if any_hit else None,
                    tri_rows=rows))
                bms, by = k1_bound(rays, got, paths, any_hit)
                row.update(ms=ms, bound_ms=bms, bound_by=by)
                print(f"  {what}: kernel {ms:.4f} ms, bound {bms:.4f} ms "
                      f"({by}), {live} live rays")
            out[f"{name} {set_name}"] = row
    torch.cuda.synchronize()
    ovf = bvh_cuda.overflow_count(device)
    deepest = bvh_cuda.deepest_stack(device)
    print(f"  K1 deepest stack on these sets: {deepest} entries")
    check(ovf == 0, f"K1 stack overflow counter {ovf} == 0")
    return out, deepest


def all_counts():
    """Every kernel wrapper's counters, by kernel name."""
    from ignis_tpu_torch.ops import bvh_cuda, gather, isect_cuda, mt_replay
    return {"K1": bvh_cuda.counts, "K2": isect_cuda.counts,
            "K3_gather_rows": gather.gather_counts,
            "K3_scatter_add_rows": gather.scatter_counts,
            "MT_replay_bwd": mt_replay.counts}


def reset_all_counts():
    for c in all_counts().values():
        c.reset()


def launches():
    return {k: c["launches"] for k, c in all_counts().items()}


def plain_calls() -> int:
    return sum(c["plain_calls"] for c in all_counts().values())


def phase_render(device, runtimes):
    """Render S1-S5 on the card; launch counts reset just before."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda, gather, isect_cuda
    bvh_cuda.reset_overflow(device)
    reset_all_counts()
    per_scene = {}
    for name, rt in runtimes.items():
        kernel = KERNEL_OF[name]
        k1_0, k2_0 = bvh_cuda.counts["launches"], isect_cuda.counts["launches"]
        k3_0 = gather.gather_counts["launches"]
        rt.step()                               # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            rt.step()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        img = rt.framebuffer(normalized=True)
        s = rt.settings
        msps = 3 * s.width * s.height * s.spi / sec / 1e6
        mean = float(img.mean())
        k1 = bvh_cuda.counts["launches"] - k1_0
        k2 = isect_cuda.counts["launches"] - k2_0
        k3 = gather.gather_counts["launches"] - k3_0
        print(f"  {name}: {msps:.4f} Msamples/s ({sec:.3f} s for 3 steps), "
              f"image mean {mean:.6f}, K1 launches {k1}, K2 launches {k2}, "
              f"K3 gather launches {k3}")
        check(tuple(img.shape) == (s.height, s.width, 3),
              f"{name}: image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"{name}: image finite")
        check(mean > 1e-3, f"{name}: image not black")
        launched = k1 if kernel == "K1" else k2
        check(launched > 0 and k3 > 0, f"{name}: {kernel} launched "
              f"{launched} times, K3 gather {k3} times")
        per_scene[name] = {"msamples_per_s": msps, "seconds_3_steps": sec,
                           "mean": mean, "K1": k1, "K2": k2, "K3": k3}
    counts = launches()
    check(counts["K3_gather_rows"] > 0, f"K3 gather_rows launched "
          f"{counts['K3_gather_rows']} times")
    plain = plain_calls()
    check(plain == 0, f"no plain version called during the renders "
          f"({plain})")
    ovf = bvh_cuda.overflow_count(device)
    print(f"  K1 deepest stack in the renders: "
          f"{bvh_cuda.deepest_stack(device)} entries")
    check(ovf == 0, f"K1 stack overflow counter {ovf} == 0")
    return counts, per_scene


def phase_profile(runtimes):
    """One profiled step per scene: device time, busy share and the top
    device consumers of that same step (render/profile.py)."""
    from ignis_tpu_torch.render.profile import profile_step
    out = {}
    for name, rt in runtimes.items():
        p = profile_step(rt.step, {"K1": "bvh_walk_kernel",
                                   "K2": "isect_dense_kernel",
                                   "K3": "gather_rows_kernel"})
        check(p["device_ops"] > 0 and p[KERNEL_OF[name] + "_us"] > 0,
              f"{name}: the profile sees the step's device work")
        print(f"  {name}: profiled step {p['wall_s']:.4f} s, device ops "
              f"{p['device_ops']}, device busy {p['device_busy_us']:.1f} us "
              f"(share {p['busy_share']:.4f}), device sum "
              f"{p['device_sum_us']:.1f} us, K1 {p['K1_us']:.1f} us, "
              f"K2 {p['K2_us']:.1f} us, K3 {p['K3_us']:.1f} us")
        for kname, count, us in p["top"]:
            print(f"    {us:10.1f} us {count:6d}x {kname}")
        out[name] = p
    return out


def card_vs_cpu(device, name, scene, spi=4):
    """One step of `scene` on the card and on the CPU at its film size:
    >= 99% of the pixels within rtol 1e-3 / atol 1e-4 and the means within
    0.5% (phase 6's bar). Returns (close share, relative mean
    difference)."""
    import ignis_tpu_torch
    imgs = []
    for dev in (device, "cpu"):
        r = ignis_tpu_torch.loadFromString(json.dumps(scene), device=dev,
                                           spi=spi)
        imgs.append(r.step().framebuffer(normalized=True).cpu().numpy())
    gpu, cpu = imgs
    close = float(np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1).mean())
    rel = float(abs(gpu.mean() - cpu.mean()) / max(abs(cpu.mean()), 1e-9))
    check(np.isfinite(gpu).all() and close >= 0.99 and rel <= 0.005,
          f"{name}: card vs CPU pixels close {close:.4f} >= 0.99, means "
          f"{gpu.mean():.6f} / {cpu.mean():.6f} within 0.5%")
    print(f"  {name}: card vs CPU close {close:.4f}, mean {gpu.mean():.6f} "
          f"(rel diff {rel:.2e})")
    return close, rel


def phase_reference(device, s5_small, s6_small):
    """Analytic point-light oracle on the card, and card-vs-CPU renders
    (`s5_small` is S5 at 64x64, subdivisions 1, a 256x128 env; `s6_small`
    S6 at 64x64 with its ball at subdivisions 2: 448 triangles, K2)."""
    import torch
    import ignis_tpu_torch
    scene = flat_scene()
    scene["lights"].append({"type": "point", "name": "_l",
                            "position": [0, 0, -2], "power": 1})
    rt = ignis_tpu_torch.loadFromString(json.dumps(scene), device=device)
    for _ in range(8):
        rt.step()
    avg = float(rt.framebuffer(normalized=True).mean())
    check(abs(avg - 0.005100456) <= 1e-4,
          f"analytic point light: {avg:.9f} vs 0.005100456 (abs 1e-4)")
    r = ignis_tpu_torch.loadFromString(json.dumps(s6_small), device="cpu")
    check(r.scene.bvh is None and r.settings.transparent_shadows,
          "S6 at subdivisions 2: under the BVH threshold (K2), glassy")
    for name, sc in (("S2", S2_GRAFT_ENTRY), ("S4", S4_GLASS_ICO2),
                     ("S1 at subdivisions 3", _ico3(S1_GLASS_ICO7)),
                     ("S5 at subdivisions 1", s5_small),
                     ("S6 at subdivisions 2", s6_small)):
        card_vs_cpu(device, f"{name} 64x64", {**sc,
                                              "film": {"size": [64, 64]}})
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 7: gradients
# ---------------------------------------------------------------------------

def small_scene(size=64, max_depth=3):
    """tests/test_parallel.py:19 small_scene: floor, ball, point + env."""
    return {
        "technique": {"type": "path", "max_depth": max_depth},
        "camera": {"type": "perspective", "fov": 60, "near_clip": 0.1,
                   "far_clip": 100,
                   "transform": [-1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 3,
                                 0, 0, 0, 1]},
        "film": {"size": [size, size]},
        "bsdfs": [{"type": "diffuse", "name": "white",
                   "reflectance": [0.7, 0.5, 0.3]}],
        "shapes": [
            {"type": "rectangle", "name": "floor", "width": 4, "height": 4},
            {"type": "sphere", "name": "ball", "radius": 0.5},
        ],
        "entities": [
            {"name": "floor", "shape": "floor", "bsdf": "white",
             "transform": [{"rotate": [-90, 0, 0]},
                           {"translate": [0, -1, 0]}]},
            {"name": "ball", "shape": "ball", "bsdf": "white"},
        ],
        "lights": [
            {"type": "point", "name": "l", "position": [1, 2, 2],
             "power": 30},
            {"type": "env", "name": "e", "radiance": [0.2, 0.2, 0.3]},
        ],
    }


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def reorder_ratio(got, ref, idx, terms, rtol):
    """Largest |got - ref| / (1e-6 + rtol * sum|terms|) over the rows of
    two scatter-added sums (`terms` added at rows `idx`, in atomic order in
    one and index_add_ order in the other). Reordering a float32 sum moves
    it by a share of the sum of its terms' magnitudes, not of the result,
    which may cancel to near 0; a ratio <= 1 is within the bar."""
    import torch
    mag = torch.zeros_like(ref).index_add_(0, idx, terms.abs())
    return float(((got - ref).abs() / (1e-6 + rtol * mag)).max())


def compare_replay(what, rays, soup, prim, seed):
    """The MT replay kernel against mt_replay_bwd_plain at the winners
    `prim`, with random cotangents. Per-ray gradients bit for bit (both
    run the same operations in the same order, without FMA contraction).
    Soup gradients are
    sums over the rays that hit a triangle, in atomic order on the card and
    index_add_ order in the plain version: within 1e-6 + 1e-4 times the sum
    of their terms' magnitudes (reorder_ratio). Returns the largest
    |difference|."""
    import torch
    from ignis_tpu_torch.core.vec import Vec3
    from ignis_tpu_torch.ops import mt_replay
    n = prim.numel()
    g = torch.Generator(device="cpu").manual_seed(seed)
    cts = [torch.randn(n, generator=g).to(prim.device) for _ in range(3)]
    ray_arrays = [*rays.org, *rays.dir]
    soup_arrays = [*soup.v0, *soup.e1, *soup.e2]
    kr, ks = mt_replay.mt_replay_bwd(ray_arrays, soup_arrays, prim, *cts)
    pr, ps = mt_replay.mt_replay_bwd_plain(ray_arrays, soup_arrays, prim,
                                           *cts)
    hit = prim >= 0
    check(int(hit.sum()) >= 1000, f"{what}: {int(hit.sum())} of {n} rays "
          f"hit (>= 1000)")
    exact = all(torch.equal(a, b) for a, b in zip(kr, pr))
    check(exact, f"{what}: per-ray gradients bit for bit")
    # |terms| of every soup sum
    p = torch.clamp(prim, min=0).long()
    rows = [a[p] for a in soup_arrays]
    terms = mt_replay.mt_adjoint(Vec3(*ray_arrays[:3]),
                                 Vec3(*ray_arrays[3:]), Vec3(*rows[:3]),
                                 Vec3(*rows[3:6]), Vec3(*rows[6:]), *cts)[2:]
    worst = max(reorder_ratio(a, b, p, torch.where(hit, term, 0.0), 1e-4)
                for a, b, term in zip(ks, ps, [c for v in terms for c in v]))
    check(worst <= 1.0, f"{what}: soup gradients within 1e-6 + 1e-4 "
          f"sum|terms| (worst ratio {worst:.4f})")
    return max(max_err(a, b) for a, b in zip(kr + ks, pr + ps))


def k3_bound(idx, k, n_rows, scatter):
    """K3's least time at these indices: the index and the k columns of
    every lane, each distinct row's k floats read (gather), or the whole
    [n_rows, k] gradient written (scatter); the scatter's one addition per
    value as operations."""
    import torch
    n = idx.numel()
    if scatter:
        return bound((4 + 4 * k) * n + 4 * k * n_rows, n * k)
    return bound((4 + 4 * k) * n + 4 * k * torch.unique(idx).numel(), 0)


def k3_gather_result(idx, tab, k):
    """One K3 gather against its plain version: (the [k, N] block equal to
    tab[idx, :k].T, largest |difference|)."""
    import torch
    from ignis_tpu_torch.ops import gather
    got = gather.gather_rows(idx, tab, k)
    ref = gather.gather_rows_plain(idx, tab, k)
    return (tuple(got.shape) == (k, idx.numel()) and torch.equal(got, ref),
            max_err(got, ref))


def k3_scatter_result(idx, cot, n_rows, stride):
    """One K3 scatter of the [k, N] cotangent block against its plain
    version: (what differs beyond reordering, or ""; the worst ratio to
    the reorder bar, 1e-6 + 1e-5 times the sum of the terms' magnitudes
    of each entry (reorder_ratio), over the finite entries; the largest
    |difference| there). NaN and inf must land where index_add_ puts them,
    and the padding columns must stay zero."""
    import torch
    from ignis_tpu_torch.ops import gather
    k = cot.shape[0]
    got = gather.scatter_add_rows(idx, cot, n_rows, stride)
    ref = gather.scatter_add_rows_plain(idx, cot, n_rows, stride)
    faults = []
    if got[:, k:].any():
        faults.append("padding columns not zero")
    got, ref = got[:, :k], ref[:, :k]
    nan = ref.isnan()
    if not torch.equal(got.isnan(), nan):
        faults.append("NaN elsewhere than index_add_'s")
    inf = ref.isinf()
    if not torch.equal(got[inf], ref[inf]):
        faults.append("inf elsewhere than index_add_'s")
    fin = ~(nan | inf)
    terms = torch.where(torch.isfinite(cot), cot, 0.0).t()
    ratio = reorder_ratio(torch.where(fin, got, 0.0),
                          torch.where(fin, ref, 0.0), idx.long(), terms, 1e-5)
    return "; ".join(faults), ratio, max_err(got[fin], ref[fin])


def check_k3(what, idx, tab, k, cot):
    """K3's gather and scatter-add against their plain versions on one
    set (k3_gather_result, k3_scatter_result); returns the largest
    |difference| of each."""
    n_rows, stride = tab.shape
    equal, g_err = k3_gather_result(idx, tab, k)
    check(equal, f"K3 gather_rows {what} [{n_rows} x {stride}, {k} columns] "
          f"at {idx.numel()} indices: equal to tab[idx]")
    fault, ratio, s_err = k3_scatter_result(idx, cot, n_rows, stride)
    check(not fault and ratio <= 1.0, f"K3 scatter_add_rows {what}: within "
          f"1e-6 + 1e-5 sum|terms| of index_add_ (worst ratio {ratio:.4f})"
          f"{'; ' + fault if fault else ''}, NaN, inf and padding as it")
    return g_err, s_err


def k3_camera_set(rt, device, seed=23):
    """K3's inputs at the first bounce of rt's main path: the clamped
    prims of main_path_sets' camera hits (a miss on row 0) into rt's
    attr_table, and a random cotangent block that is zero on the misses,
    as the masked shading leaves it."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda
    from ignis_tpu_torch.techniques.path import ATTR_COLS, attr_table
    sc = rt.scene
    cam, _ = main_path_sets(rt, device)["camera"]
    prim = bvh_cuda.intersect_bvh(cam, sc.tris, sc.bvh).prim
    tab = attr_table(sc)
    idx = torch.clamp(prim, 0, tab.shape[0] - 1).to(torch.int32)
    g = torch.Generator(device="cpu").manual_seed(seed)
    cot = torch.randn(ATTR_COLS, idx.numel(), generator=g).to(device)
    return idx, tab, torch.where(prim >= 0, cot, 0.0)


def k3_sets(rt, device, n=262144, seed=3):
    """K3's check sets on rt's attr_table: "random", n random rows with
    random cotangents; "camera", k3_camera_set; "one row", n lanes on row 7;
    "special", random rows whose cotangents hold a NaN, a -0.0 and an inf.
    Returns {name: (idx, tab, k, cot)}."""
    import torch
    from ignis_tpu_torch.techniques.path import ATTR_COLS, attr_table
    tab = attr_table(rt.scene)
    n_rows, k = tab.shape[0], ATTR_COLS
    g = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.randint(0, n_rows, (n,), generator=g,
                        dtype=torch.int32).to(device)
    cot = torch.randn(k, n, generator=g).to(device)
    special = cot.clone()
    special[3, 10], special[5, 20], special[7, 30] = (
        float("nan"), -0.0, float("inf"))
    cam_idx, _, cam_cot = k3_camera_set(rt, device)
    return {"random": (idx, tab, k, cot),
            "camera": (cam_idx, tab, k, cam_cot),
            "one row": (torch.full_like(idx, 7), tab, k, cot),
            "special": (idx, tab, k, special)}


def phase_grad_kernels(device, s1, k1_rays):
    """K3's gather and scatter-add and the MT replay against their plain
    versions on the card, at the gradient path's shapes (S1's attribute
    table, 262,144 lanes: k3_sets), the replay also with 65,536 rays aimed
    at one triangle; median kernel, plain and library times and each
    kernel's bound: K3 on the random set, the replay on S1's contended rays
    (half camera rays through random pixels, half random rays about the
    ball, most of whose hits land on the floor's two triangles) and on
    random rays against a 4,096-triangle random soup, where winners rarely
    repeat."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda, gather, isect_cuda, mt_replay
    sc = s1.scene
    g = torch.Generator(device="cpu").manual_seed(3)
    sets = k3_sets(s1, device)
    errs = {"K3_gather_rows": 0.0, "K3_scatter_add_rows": 0.0}
    for name, (idx, tab, k, cot) in sets.items():
        ge, se = check_k3(name, idx, tab, k, cot)
        errs["K3_gather_rows"] = max(errs["K3_gather_rows"], ge)
        errs["K3_scatter_add_rows"] = max(errs["K3_scatter_add_rows"], se)
    idx, tab, k, cot = sets["random"]
    n_rows, stride = tab.shape
    n = idx.numel()

    hit = bvh_cuda.intersect_bvh(k1_rays, sc.tris, sc.bvh)
    e1 = compare_replay("MT replay, S1 rays at K1's winners", k1_rays,
                        sc.tris, hit.prim, 1)
    rng = np.random.default_rng(13)
    soup, _ = random_soup(rng, 4096, device)
    rays = random_rays(rng, 65536, device)
    e2 = compare_replay("MT replay, random soup at K2's winners", rays, soup,
                        isect_cuda.intersect_tris(rays, soup).prim, 2)
    at0 = rays_at_triangle(rng, soup, 0, 65536, device)
    e3 = compare_replay("MT replay, every ray on triangle 0", at0, soup,
                        torch.zeros_like(at0.tmin, dtype=torch.int32), 4)
    errs["MT_replay_bwd"] = max(e1, e2, e3)

    # times at the main path's shapes: 262,144 lanes
    contended = cat_rays(camera_rays(sc, s1.settings, n // 2, device),
                         random_rays(rng, n // 2, device, extent=1.5))
    spread = random_rays(rng, n, device)
    replay_sets = {
        "S1 contended": (contended, [*sc.tris.v0, *sc.tris.e1, *sc.tris.e2],
                         bvh_cuda.intersect_bvh(contended, sc.tris,
                                                sc.bvh).prim),
        "random soup": (spread, [*soup.v0, *soup.e1, *soup.e2],
                        isect_cuda.intersect_tris(spread, soup).prim)}
    cts = [torch.randn(n, generator=g).to(device) for _ in range(3)]
    zeros = torch.zeros(n_rows, k, device=device)
    rows = cot.t().contiguous()
    times = {
        "K3_gather_rows": dict(
            ms=cuda_ms(lambda: gather.gather_rows(idx, tab, k)),
            plain_ms=cuda_ms(lambda: gather.gather_rows_plain(idx, tab, k)),
            library_ms=cuda_ms(lambda: torch.index_select(tab, 0, idx))),
        "K3_scatter_add_rows": dict(
            ms=cuda_ms(lambda: gather.scatter_add_rows(idx, cot, n_rows,
                                                       stride)),
            plain_ms=cuda_ms(lambda: gather.scatter_add_rows_plain(
                idx, cot, n_rows, stride)),
            library_ms=cuda_ms(lambda: torch.index_add(zeros, 0, idx, rows)))}
    times["K3_gather_rows"].update(zip(("bound_ms", "bound_by"), k3_bound(
        idx, k, n_rows, False)))
    times["K3_scatter_add_rows"].update(zip(("bound_ms", "bound_by"),
                                            k3_bound(idx, k, n_rows, True)))
    for name in ("camera", "one row"):
        i, t, _, c = sets[name]
        times["K3_gather_rows"].setdefault("sets", {})[name] = dict(
            ms=cuda_ms(lambda: gather.gather_rows(i, t, k)),
            library_ms=cuda_ms(lambda: torch.index_select(t, 0, i)),
            bound_ms=k3_bound(i, k, n_rows, False)[0])
        r = c.t().contiguous()
        times["K3_scatter_add_rows"].setdefault("sets", {})[name] = dict(
            ms=cuda_ms(lambda: gather.scatter_add_rows(i, c, n_rows, stride)),
            library_ms=cuda_ms(lambda: torch.index_add(zeros, 0, i, r)),
            bound_ms=k3_bound(i, k, n_rows, True)[0])
    replay = {}
    for name, (r, soup_arrays, prim) in replay_sets.items():
        ra = [*r.org, *r.dir]
        row = dict(
            ms=cuda_ms(lambda: mt_replay.mt_replay_bwd(ra, soup_arrays, prim,
                                                       *cts)),
            plain_ms=cuda_ms(lambda: mt_replay.mt_replay_bwd_plain(
                ra, soup_arrays, prim, *cts)),
            library_ms=None, hits=int((prim >= 0).sum()),
            winners=int(torch.unique(prim[prim >= 0]).numel()))
        row.update(zip(("bound_ms", "bound_by"),
                       replay_bound(prim, soup_arrays[0].numel())))
        replay[name] = row
    times["MT_replay_bwd"] = dict(replay["S1 contended"], sets=replay)
    for name, t in [*times.items()] + [
            (f"{kernel} {k}", v) for kernel in times
            for k, v in times[kernel].get("sets", {}).items()]:
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        plain = (f", plain {t['plain_ms']:.4f} ms" if "plain_ms" in t
                 else "")
        print(f"  {name}: kernel {t['ms']:.4f} ms{plain}, library {lib}, "
              f"bound {t['bound_ms']:.4f} ms")
    return errs, times


def geometry_leaves(scene):
    """`scene` with tris.v0/e1/e2 replaced by fresh leaves that require
    grad, and the list of those leaves."""
    from ignis_tpu_torch.core.vec import Vec3
    vs = {f: Vec3(*[c.detach().clone().requires_grad_()
                    for c in getattr(scene.tris, f)])
          for f in ("v0", "e1", "e2")}
    return (scene._replace(tris=scene.tris._replace(**vs)),
            [c for v in vs.values() for c in v])


TRAIN_STEPS = 3     # a warm-up and two timed train steps a scene
S5_ROUGHNESS_DEPTH = 4


def phase_train(device, runtimes):
    """One-GPU train step (SGD on the albedo, target black) on S1-S5 at
    512x512, spi 4: TRAIN_STEPS steps, Msamples/s of the faster timed
    step (the first is a warm-up) beside both times, peak memory; counts
    reset before and read after; then the roughness gradient of the same
    loss on S5 (at S5_ROUGHNESS_DEPTH) and a geometry gradient on S1 and
    S2."""
    import torch
    from ignis_tpu_torch import loss_fn, train_step
    lr = 1e-2
    reset_all_counts()
    out = {}
    for name, rt in runtimes.items():
        kernel = KERNEL_OF[name]
        s = rt.settings
        target = torch.zeros((s.height, s.width, 3), device=device)
        before = launches()
        base = torch.stack(list(rt.scene.materials.base))
        secs, peaks = [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            loss, new_scene = train_step(rt.scene, s, target, 0, 0, lr)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated(device))
        sec = min(secs[1:])
        msps = s.width * s.height * s.spi / sec / 1e6
        grad = (base - torch.stack(list(new_scene.materials.base))) / lr
        after = launches()
        used = {k: after[k] - before[k] for k in after}
        print(f"  {name}: train step {msps:.4f} Msamples/s fwd+bwd (faster "
              f"{sec:.4f} s of {[round(x, 4) for x in secs[1:]]}), peak "
              f"memory {max(peaks) / 2**30:.3f} GiB, loss {float(loss):.6f},"
              f" launches {used}")
        check(bool(torch.isfinite(loss)), f"{name}: loss finite")
        check(bool(torch.isfinite(grad).all()) and bool((grad != 0).any()),
              f"{name}: albedo gradient finite and nonzero")
        check(used[kernel] > 0 and used["K3_gather_rows"] > 0
              and used["K3_scatter_add_rows"] > 0
              and used["MT_replay_bwd"] == 0,
              f"{name}: {kernel} and K3 launched in the train steps, the MT "
              f"replay not (the albedo moves no ray)")
        out[name] = {"msamples_per_s": msps, "step_s": secs,
                     "peak_gib": max(peaks) / 2**30, "loss": float(loss),
                     "launches": used}
    check(plain_calls() == 0, f"no plain version called in the train steps "
          f"({plain_calls()})")

    # the roughness (materials.p2) gradient of the same loss on S5, at
    # max_depth 4 (a shallower path keeps the script within its time)
    rt = runtimes[S5_NAME]
    s = dataclasses.replace(rt.settings, max_depth=S5_ROUGHNESS_DEPTH)
    target = torch.zeros((s.height, s.width, 3), device=device)
    p2 = rt.scene.materials.p2.detach().clone().requires_grad_()
    scene = rt.scene._replace(materials=rt.scene.materials._replace(p2=p2))
    t0 = time.perf_counter()
    loss = loss_fn({"base": scene.materials.base}, scene, s, target, 0, 0)
    g = torch.autograd.grad(loss, p2)[0]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    rough = [i for i, k in enumerate(scene.materials.kind.tolist())
             if k in (1, 2, 5, 6) and float(p2[i].detach()) > 1e-4]
    print(f"  {S5_NAME}: roughness gradient (max_depth {s.max_depth}) in "
          f"{sec:.4f} s: "
          f"{[round(float(x), 6) for x in g]} (rough rows {rough})")
    nonzero = int((g[rough] != 0).sum())
    check(bool(torch.isfinite(g).all()) and nonzero > 0,
          f"{S5_NAME}: roughness gradient finite, nonzero on {nonzero} of "
          f"{len(rough)} rough rows")
    out[S5_NAME]["roughness_grad"] = [float(x) for x in g]

    for name in ("S1_glass_ico7", "S2_graft_entry"):
        rt = runtimes[name]
        s = rt.settings
        target = torch.zeros((s.height, s.width, 3), device=device)
        scene, leaves = geometry_leaves(rt.scene)
        before = launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        loss = loss_fn({"base": scene.materials.base}, scene, s, target, 0, 0)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        after = launches()
        used = {k: after[k] - before[k] for k in after}
        g = torch.stack(grads)
        finite = float(torch.isfinite(g).float().mean())
        nonzero = int((g != 0).sum())
        print(f"  {name}: geometry gradient in {sec:.4f} s, peak memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB, "
              f"finite share {finite:.6f}, nonzero entries {nonzero} of "
              f"{g.numel()}, launches {used}")
        check(used["MT_replay_bwd"] > 0 and used["K3_scatter_add_rows"] > 0,
              f"{name}: MT replay and K3 scatter_add_rows launched")
        # S2's only triangles, the floor, lie in the camera's plane (y = 0)
        # and through the glass ball: its hits see the lights only through
        # glass, so its smooth gradient is 0 and only S1's must be nonzero.
        check(bool(torch.isfinite(loss))
              and (nonzero > 0 or name != "S1_glass_ico7"),
              f"{name}: loss finite" + (", geometry gradient nonzero"
                                        if name == "S1_glass_ico7" else ""))
        out[name]["geometry"] = {"seconds": sec, "finite_share": finite,
                                 "nonzero": nonzero, "launches": used}
    check(plain_calls() == 0, f"no plain version called in the train and "
          f"geometry steps ({plain_calls()})")
    return launches(), out


def phase_train_profile(device, runtimes):
    """One train step per scene under torch.profiler."""
    import torch
    from ignis_tpu_torch import train_step
    from ignis_tpu_torch.render.profile import profile_step
    names = {"K1": "bvh_walk_kernel", "K2": "isect_dense_kernel",
             "K3": "gather_rows_kernel", "K3s": "scatter_add_rows_kernel",
             "MT": "mt_replay_bwd_kernel",
             "index_put": "indexing_backward_kernel"}
    out = {}
    for name, rt in runtimes.items():
        s = rt.settings
        target = torch.zeros((s.height, s.width, 3), device=device)
        p = profile_step(lambda: train_step(rt.scene, s, target, 0, 0, 1e-2),
                         names)
        print(f"  {name}: profiled train step {p['wall_s']:.4f} s, device "
              f"ops {p['device_ops']}, device busy {p['device_busy_us']:.1f}"
              f" us (share {p['busy_share']:.4f}), "
              + ", ".join(f"{k} {p[k + '_us']:.1f} us" for k in names))
        for kname, count, us in p["top"]:
            print(f"    {us:10.1f} us {count:6d}x {kname}")
        share = p["index_put_us"] / max(p["device_sum_us"], 1e-9)
        check(share < 0.01, f"{name}: indexing_backward_kernel takes "
              f"{share:.4%} of the profiled train step's device time (< 1%)")
        out[name] = p
    return out


def phase_geometry_profile(device, rt):
    """One geometry-gradient step of `rt` (w.r.t. tris.v0/e1/e2, the loss
    of phase_train) under torch.profiler: the MT replay's summed device
    time in it, beside K1's and K3's."""
    import torch
    from ignis_tpu_torch import loss_fn
    from ignis_tpu_torch.render.profile import profile_step
    s = rt.settings
    target = torch.zeros((s.height, s.width, 3), device=device)
    names = {"MT": "mt_replay_bwd_kernel", "K1": "bvh_walk_kernel",
             "K3": "gather_rows_kernel", "K3s": "scatter_add_rows_kernel"}

    def step():
        scene, leaves = geometry_leaves(rt.scene)
        loss = loss_fn({"base": scene.materials.base}, scene, s, target, 0, 0)
        torch.autograd.grad(loss, leaves)
    p = profile_step(step, names)
    print(f"  profiled geometry-gradient step {p['wall_s']:.4f} s, device "
          f"ops {p['device_ops']}, device busy {p['device_busy_us']:.1f} us "
          f"(share {p['busy_share']:.4f}), "
          + ", ".join(f"{k} {p[k + '_us']:.1f} us" for k in names))
    check(p["MT_us"] > 0, "the MT replay ran in the profiled step")
    return p


def record_k3_calls(run):
    """The arguments of every K3 launch while run() runs, recorded by
    wrapping gather.gather_rows and gather.scatter_add_rows for that call
    alone: ([(idx, tab, k)], [(idx, cot, n_rows, stride)])."""
    from ignis_tpu_torch.ops import gather
    gathers, scatters = [], []
    gather_rows, scatter_add_rows = gather.gather_rows, gather.scatter_add_rows

    def rec_gather(idx, tab, k):
        gathers.append((idx.clone(), tab.detach(), k))
        return gather_rows(idx, tab, k)

    def rec_scatter(idx, cot, n_rows, stride):
        scatters.append((idx.clone(), cot.contiguous().clone(), n_rows,
                         stride))
        return scatter_add_rows(idx, cot, n_rows, stride)
    gather.gather_rows, gather.scatter_add_rows = rec_gather, rec_scatter
    try:
        run()
    finally:
        gather.gather_rows = gather_rows
        gather.scatter_add_rows = scatter_add_rows
    return gathers, scatters


def record_k3(rt, device):
    """record_k3_calls of one geometry-gradient step of rt (phase_train's
    loss w.r.t. tris.v0/e1/e2)."""
    import torch
    from ignis_tpu_torch import loss_fn
    s = rt.settings
    target = torch.zeros((s.height, s.width, 3), device=device)

    def step():
        scene, leaves = geometry_leaves(rt.scene)
        loss = loss_fn({"base": scene.materials.base}, scene, s, target, 0, 0)
        torch.autograd.grad(loss, leaves)
    return record_k3_calls(step)


def time_k3_launches(gathers, scatters, kernels=None, library=True):
    """Each K3 kernel's median time per recorded launch, summed over the
    launches; with `library`, beside the sum of torch.index_select
    (gather) and torch.index_add into zeros (scatter, the cotangent as
    [N, k] rows, made beforehand) on the same launches and the summed
    bound. `kernels` = (gather, scatter) replaces the wrappers timed."""
    import torch
    from ignis_tpu_torch.ops import gather
    g_fn, s_fn = kernels or (gather.gather_rows, gather.scatter_add_rows)
    out = {"gather": dict(
        launches=len(gathers), lanes=sum(i.numel() for i, _, _ in gathers),
        ms=sum(cuda_ms(lambda: g_fn(i, t, k)) for i, t, k in gathers))}
    out["scatter"] = dict(
        launches=len(scatters), lanes=sum(i.numel() for i, *_ in scatters),
        zero_lanes=sum(int((c == 0).all(0).sum()) for _, c, _, _ in scatters),
        ms=sum(cuda_ms(lambda: s_fn(i, c, t, st))
               for i, c, t, st in scatters))
    if not library:
        return out
    rows = [cot.t().contiguous() for _, cot, _, _ in scatters]
    zeros = {n_rows: torch.zeros(n_rows, cot.shape[0], device=cot.device)
             for _, cot, n_rows, _ in scatters}
    out["gather"].update(
        library_ms=sum(cuda_ms(lambda: torch.index_select(t, 0, i))
                       for i, t, _ in gathers),
        bound_ms=sum(k3_bound(i, k, t.shape[0], False)[0]
                     for i, t, k in gathers))
    out["scatter"].update(
        library_ms=sum(cuda_ms(lambda: torch.index_add(zeros[t], 0, i, r))
                       for (i, _, t, _), r in zip(scatters, rows)),
        bound_ms=sum(k3_bound(i, c.shape[0], t, True)[0]
                     for i, c, t, _ in scatters))
    return out


def phase_k3_recorded(device, runtimes):
    """K3 on the launches of one S1 and one S2 geometry-gradient step
    (record_k3): every gather equal to its plain version and every scatter
    within the reorder bar (k3_gather_result, k3_scatter_result), then the
    times of time_k3_launches, the kernels' timed a second time after the
    library's (`ms_repeat`), which shows how far the sums move within one
    run. Returns {scene: {"gather": ..., "scatter": ...}}."""
    out = {}
    for name in ("S1_glass_ico7", "S2_graft_entry"):
        gathers, scatters = record_k3(runtimes[name], device)
        equal = [k3_gather_result(*a)[0] for a in gathers]
        check(len(gathers) > 0 and all(equal), f"{name} geometry step: all "
              f"{len(gathers)} recorded K3 gathers equal to tab[idx]")
        results = [k3_scatter_result(*a) for a in scatters]
        worst = max((r[1] for r in results), default=0.0)
        faults = [r[0] for r in results if r[0]]
        check(len(scatters) > 0 and not faults and worst <= 1.0,
              f"{name} geometry step: all {len(scatters)} recorded K3 "
              f"scatters within 1e-6 + 1e-5 sum|terms| of index_add_ (worst "
              f"ratio {worst:.4f}){'; ' + faults[0] if faults else ''}")
        row = time_k3_launches(gathers, scatters)
        again = time_k3_launches(gathers, scatters, library=False)
        for kind, t in row.items():
            t["ms_repeat"] = again[kind]["ms"]
            print(f"  {name} geometry step, K3 {kind}: {t['launches']} "
                  f"launches, {t['lanes']} lanes, kernel {t['ms']:.4f} ms "
                  f"(timed again after the library: {t['ms_repeat']:.4f} "
                  f"ms), library {t['library_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms (sums)")
        out[name] = row
    return out


def phase_albedo_shape(device, s1):
    """The K3 scatter at the shape of the albedo's backward, numbers only
    (the port's albedo gather, path.gather_material, does not go through
    K3): the material ids of S1's camera hits (main_path_sets; a miss
    reads row 0's entity), T = S1's material count, K = 3, random
    cotangents; held to the reorder bar, and timed beside
    torch.zeros(T, 3).index_put_((mid,), g, accumulate=True), the
    operation behind torch's indexing_backward_kernel in the train step."""
    import torch
    from ignis_tpu_torch.ops import bvh_cuda, gather
    from ignis_tpu_torch.techniques.path import compute_surface
    sc = s1.scene
    cam, _ = main_path_sets(s1, device)["camera"]
    surf = compute_surface(sc, cam, bvh_cuda.intersect_bvh(cam, sc.tris,
                                                           sc.bvh))
    mid = sc.entities.mat[torch.clamp(surf.ent, min=0).long()].long()
    n_mat = sc.materials.base.r.numel()
    g = torch.Generator(device="cpu").manual_seed(29)
    cot = torch.randn(3, mid.numel(), generator=g).to(device)
    rows = cot.t().contiguous()
    idx = mid.to(torch.int32)
    fault, ratio, _ = k3_scatter_result(idx, cot, n_mat, 4)
    check(not fault and ratio <= 1.0, f"K3 scatter at the albedo's shape "
          f"({mid.numel()} lanes onto {n_mat} materials): within the reorder "
          f"bar (worst ratio {ratio:.4f})")
    row = dict(
        lanes=mid.numel(), materials=n_mat,
        ms=cuda_ms(lambda: gather.scatter_add_rows(idx, cot, n_mat, 4)),
        index_put_ms=cuda_ms(lambda: torch.zeros(n_mat, 3, device=device)
                             .index_put_((mid,), rows, accumulate=True)))
    row.update(zip(("bound_ms", "bound_by"), k3_bound(idx, 3, n_mat, True)))
    print(f"  K3 scatter at the albedo's shape: kernel {row['ms']:.4f} ms, "
          f"index_put_(accumulate=True) {row['index_put_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms")
    return row


def k3_material_set(rt, device, seed=31):
    """K3's inputs at the material fetch of the first bounce of rt's main
    path (path.gather_material): the material rows of main_path_sets'
    camera hits (a miss reads row 0's entity) into rt's material_table,
    the columns the bounce reads with textures (MAT_COLS + TEX_COLS), and
    a random cotangent block that is zero on the misses."""
    import torch
    from ignis_tpu_torch.techniques import path
    sc = rt.scene
    cam, _ = main_path_sets(rt, device)["camera"]
    hit = path.trace_scene(sc, cam)
    surf = path.compute_surface(sc, cam, hit)
    mid = path.material_ids(sc, surf).to(torch.int32)
    tab = path.material_table(sc)
    k = path.MAT_COLS + len(path.TEX_COLS)
    g = torch.Generator(device="cpu").manual_seed(seed)
    cot = torch.randn(k, mid.numel(), generator=g).to(device)
    return mid, tab, k, torch.where(hit.prim >= 0, cot, 0.0)


def k3_medium_set(rt, device, seed=37):
    """K3's inputs at the medium fetch of the first bounce of rt's main
    path (volpath's eval_medium_at after the camera hits, one gather of
    medium.gather_medium): the medium a camera lane takes on crossing the
    surface it hits (the entity's inner medium where it enters, its outer
    where it leaves, vacuum (-1, read as row 0) on a miss), clamped as
    gather_medium clamps it, into rt's medium_table ([n, 8]), its
    MED_COLS = 7 columns, and a random cotangent block."""
    import torch
    from ignis_tpu_torch.models import medium
    from ignis_tpu_torch.techniques import path
    sc = rt.scene
    cam, _ = main_path_sets(rt, device)["camera"]
    hit = path.trace_scene(sc, cam)
    surf = path.compute_surface(sc, cam, hit)
    ent = torch.clamp(surf.ent, min=0).long()
    med = torch.where(surf.is_entering, sc.entities.med_inner[ent],
                      sc.entities.med_outer[ent])
    med = torch.where(hit.prim >= 0, med, -1)
    tab = medium.medium_table(sc.media)
    idx = torch.clamp(med, 0, tab.shape[0] - 1).to(torch.int32)
    g = torch.Generator(device="cpu").manual_seed(seed)
    cot = torch.randn(medium.MED_COLS, idx.numel(), generator=g).to(device)
    return idx, tab, medium.MED_COLS, cot


def phase_k3_table(device, what, idx, tab, k, cot):
    """K3 on one table of the main path (k3_material_set, k3_medium_set):
    the gather equal to its plain version, the scatter within the reorder
    bar, each timed beside its bound and torch.index_select /
    torch.zeros(T, S).index_put_((idx,), rows, accumulate=True), the
    operation behind indexing_backward_kernel that a per-column fetch
    runs."""
    import torch
    from ignis_tpu_torch.ops import gather
    n_rows, stride = tab.shape
    g_err, s_err = check_k3(what, idx, tab, k, cot)
    rows = torch.zeros(idx.numel(), stride, device=device)
    rows[:, :k] = cot.t()
    mid = idx.long()
    out = {"gather": dict(
        lanes=idx.numel(), rows=n_rows, columns=k,
        ms=cuda_ms(lambda: gather.gather_rows(idx, tab, k)),
        library_ms=cuda_ms(lambda: torch.index_select(tab, 0, idx)),
        bound_ms=k3_bound(idx, k, n_rows, False)[0], max_abs_err=g_err),
        "scatter": dict(
        lanes=idx.numel(), rows=n_rows, columns=k,
        ms=cuda_ms(lambda: gather.scatter_add_rows(idx, cot, n_rows,
                                                   stride)),
        library_ms=cuda_ms(lambda: torch.zeros(n_rows, stride, device=device)
                           .index_put_((mid,), rows, accumulate=True)),
        bound_ms=k3_bound(idx, k, n_rows, True)[0], max_abs_err=s_err)}
    for kind, t in out.items():
        print(f"  {what}, K3 {kind}: {t['lanes']} lanes onto {n_rows} rows, "
              f"{k} columns: kernel {t['ms']:.4f} ms, library "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
    return out


def phase_grad_reference(device):
    """The albedo gradient of small_scene(64) on the card against the
    CPU's: rtol 1e-3."""
    import torch
    import ignis_tpu_torch
    from ignis_tpu_torch import loss_fn
    from ignis_tpu_torch.core.vec import Color
    grads = []
    for dev in (device, "cpu"):
        rt = ignis_tpu_torch.loadFromString(json.dumps(small_scene(64)),
                                            device=dev, spi=1)
        base = Color(*[c.detach().clone().requires_grad_()
                       for c in rt.scene.materials.base])
        target = torch.zeros((64, 64, 3), device=dev)
        loss = loss_fn({"base": base}, rt.scene, rt.settings, target, 0, 0)
        grads.append(torch.stack(torch.autograd.grad(loss, list(base)))
                     .cpu().numpy())
    gpu, cpu = grads
    print(f"  small_scene(64) albedo gradient: card {gpu.ravel().tolist()},"
          f" CPU {cpu.ravel().tolist()}")
    check(np.isfinite(gpu).all() and np.abs(cpu).max() > 0
          and np.allclose(gpu, cpu, rtol=1e-3, atol=0),
          "small_scene(64): albedo gradient on the card within rtol 1e-3 "
          "of the CPU's")


def sigma_grad(rt, device):
    """(loss, [6] gradient) of phase_train's loss (target black) w.r.t.
    rt's media.sigma_a and sigma_s, on the device rt lives on."""
    import torch
    from ignis_tpu_torch import loss_fn
    from ignis_tpu_torch.core.vec import Color
    s = rt.settings
    med = rt.scene.media
    sa, ss = [Color(*[c.detach().clone().requires_grad_() for c in col])
              for col in (med.sigma_a, med.sigma_s)]
    scene = rt.scene._replace(media=med._replace(sigma_a=sa, sigma_s=ss))
    target = torch.zeros((s.height, s.width, 3), device=device)
    loss = loss_fn({"base": scene.materials.base}, scene, s, target, 0, 0)
    grads = torch.autograd.grad(loss, [*sa, *ss])
    return loss, torch.stack([g.reshape(-1) for g in grads])


def phase_sigma(device, rt, small):
    """One sigma gradient step of S6 (`rt`) at its full size: the loss of
    phase_train w.r.t. media.sigma_a and sigma_s, through the weights of
    the medium events and surface branches and the transmittances (the
    crossing walk's included); counts reset before and read after. Then
    the same gradient of `small` (S6 at 64x64, K2) on the card against the
    CPU's: rtol 1e-3.

    The gradient is the estimator's, and it is biased: S6 plays Russian
    roulette from depth 2, whose probability follows the throughput and is
    not detached, so reverse mode misses the survival term (ROADMAP queue
    3; the CPU tests hold the sigma gradient to central differences with
    roulette off). The distance sampling is held fixed under the gradient
    (medium.sample_distance), so the free-flight sample adds no bias."""
    import torch
    import ignis_tpu_torch
    reset_all_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    loss, g = sigma_grad(rt, device)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    used = launches()
    print(f"  {S6_NAME}: sigma gradient (the estimator's, biased by the "
          f"undetached roulette past depth 2) in {sec:.4f} s, peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB, "
          f"loss {float(loss):.6f}, d/d(sigma_a, sigma_s) "
          f"{g.cpu().numpy().round(8).tolist()}, launches {used}")
    check(bool(torch.isfinite(g).all()) and bool((g != 0).all()),
          f"{S6_NAME}: sigma gradient finite and nonzero on every entry")
    check(used["K1"] > 0 and used["K3_scatter_add_rows"] > 0
          and plain_calls() == 0, f"{S6_NAME}: K1 and the K3 scatter "
          f"launched, no plain version called ({plain_calls()})")
    check(used["MT_replay_bwd"] == 0, f"{S6_NAME}: no MT replay in the "
          f"sigma gradient (no ray follows sigma): "
          f"{used['MT_replay_bwd']}")
    grads = []
    for dev in (device, "cpu"):
        r = ignis_tpu_torch.loadFromString(json.dumps(small), device=dev,
                                           spi=1)
        grads.append(sigma_grad(r, dev)[1].cpu().numpy())
    gpu, cpu = grads
    print(f"  small S6 (64x64) sigma gradient: card {gpu.ravel().tolist()},"
          f" CPU {cpu.ravel().tolist()}")
    check(np.isfinite(gpu).all() and np.abs(cpu).min() > 0
          and np.allclose(gpu, cpu, rtol=1e-3, atol=0),
          "small S6: sigma gradient on the card within rtol 1e-3 of the "
          "CPU's")
    return {"seconds": sec, "loss": float(loss),
            "grad": g.cpu().numpy().ravel().tolist(),
            "small_card": gpu.ravel().tolist(),
            "small_cpu": cpu.ravel().tolist(),
            "launches": used}


# ---------------------------------------------------------------------------
# phase 8: instancing and the other techniques
# ---------------------------------------------------------------------------

def grid_scene(n_side, spacing=1.5, subdivisions=2, size=64):
    """tests/test_instancing.py:17 _grid_scene: n_side^2 icospheres
    (radius 0.5, one shared mesh) on a grid under a point light, path
    tracing at max_depth 3; `subdivisions` is the shared icosphere's."""
    entities = []
    for i in range(n_side):
        for j in range(n_side):
            entities.append({
                "name": f"ball_{i}_{j}", "shape": "ball", "bsdf": "white",
                "transform": [
                    {"translate": [(i - n_side / 2) * spacing, 0.0,
                                   (j - n_side / 2) * spacing]},
                    {"rotate": [0, math.degrees((i * n_side + j) * 0.37),
                                0]},
                    {"scale": 0.5}]})
    return {
        "technique": {"type": "path", "max_depth": 3},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 0.7071, -0.7071, 8,
                                 0, 0.7071, 0.7071, -8]},
        "film": {"size": [size, size]},
        "bsdfs": [{"type": "diffuse", "name": "white",
                   "reflectance": [0.7, 0.6, 0.5]}],
        "shapes": [{"type": "icosphere", "name": "ball", "radius": 1.0,
                    "subdivisions": subdivisions}],
        "entities": entities,
        "lights": [{"type": "point", "name": "P", "position": [0, 6, 0],
                    "intensity": [80, 80, 80]}],
    }


# S7: _grid_scene(32, spacing=1.2) with the shared icosphere at
# subdivisions 4: 1,024 instances of one 5,120-triangle mesh (5,242,880
# triangles flattened), whose local soup takes K1.
S7_NAME = "S7_instanced_grid"
S7_SCENE = grid_scene(32, spacing=1.2, subdivisions=4, size=512)

# S8: tests/test_lighttracer.py:13 SCENE (a diffuse box lit by a small area
# light) raised from 48x48 to 512x512, max_depth 4; rendered under `lt`
# and `ppm` (1,000,000 photons, the reference default).
S8_NAME = "S8_lt_ppm_box"
S8_BOX = {
    "technique": {"type": "lt", "max_depth": 4},
    "camera": {"type": "perspective", "fov": 60, "near_clip": 0.01,
               "far_clip": 100,
               "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
    "film": {"size": [512, 512]},
    "bsdfs": [{"type": "diffuse", "name": "g",
               "reflectance": [0.8, 0.8, 0.8]},
              {"type": "diffuse", "name": "black", "reflectance": [0, 0, 0]}],
    "shapes": [{"type": "rectangle", "name": "B", "width": 4, "height": 4,
                "flip_normals": True},
               {"type": "rectangle", "name": "L", "width": 0.5,
                "height": 0.5}],
    "entities": [{"name": "B", "shape": "B", "bsdf": "g"},
                 {"name": "L", "shape": "L", "bsdf": "black",
                  "transform": [{"translate": [1.5, 0, -1.0]}]}],
    "lights": [{"type": "area", "name": "L", "entity": "L",
                "radiance": [10, 10, 10]}],
}
SIMPLE_TECHNIQUES = ("ao", "debug", "wireframe", "lightvisibility",
                     "camera_check", "env_check")
PROFILE_NAMES = {"K1": "bvh_walk_kernel", "K2": "isect_dense_kernel",
                 "K3": "gather_rows_kernel", "K3_scatter": "scatter_add"}


def aept_scene(env_file, size=512, subdivisions=7):
    """S1's scene under aept, its constant env replaced by S5's substitute
    env (`env_file`, at S5's scale): a constant env gives the guiding
    nothing to learn."""
    sc = json.loads(json.dumps(S1_GLASS_ICO7))
    sc["technique"]["type"] = "aept"
    sc["shapes"][1]["subdivisions"] = subdivisions
    sc["film"] = {"size": [size, size]}
    sc["textures"] = [{"type": "image", "name": "env",
                       "filename": str(env_file)}]
    sc["lights"][1] = {"type": "env", "name": "e", "radiance": "env",
                       "scale": [0.05, 0.05, 0.05]}
    return sc


def count_syncs(fn):
    """(fn()'s result, the host syncs it made), counted by torch's CUDA
    sync debug mode, which warns at every synchronizing call (an alive
    count, a nonzero, a host read)."""
    import warnings
    import torch
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def measure_steps(name, rt, need, steps=1, profile=True):
    """A warm-up step, then `steps` timed steps of `rt` with every
    kernel's launches reset just before and read just after and the host
    syncs counted, then one profiled step. `need` names the kernels the
    path must launch; no plain version may run."""
    import torch
    from ignis_tpu_torch.render.profile import profile_step
    rt.step()
    torch.cuda.synchronize()
    reset_all_counts()
    t0 = time.perf_counter()
    _, syncs = count_syncs(lambda: [rt.step() for _ in range(steps)])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    used = launches()
    plain = plain_calls()
    img = rt.framebuffer(normalized=True)
    s = rt.settings
    msps = steps * s.width * s.height * s.spi / sec / 1e6
    mean = float(img.mean())
    per = {k: v / steps for k, v in used.items()}
    print(f"  {name}: {msps:.4f} Msamples/s ({sec:.3f} s for {steps} "
          f"step(s)), image mean {mean:.6f}, a step: launches {per}, host "
          f"syncs {syncs / steps:g}")
    check(tuple(img.shape) == (s.height, s.width, 3)
          and bool(torch.isfinite(img).all()) and mean > 0,
          f"{name}: image finite and not black")
    check(all(used[k] > 0 for k in need),
          f"{name}: {', '.join(need)} launched")
    check(plain == 0, f"{name}: no plain version called ({plain})")
    out = {"msamples_per_s": msps, "seconds": sec, "steps": steps,
           "mean": mean, "launches_per_step": per,
           "host_syncs_per_step": syncs / steps}
    if profile:
        p = profile_step(rt.step, PROFILE_NAMES)
        print(f"    profiled step {p['wall_s']:.4f} s, device ops "
              f"{p['device_ops']}, device busy {p['device_busy_us']:.1f} us "
              f"(share {p['busy_share']:.4f}), K1 {p['K1_us']:.1f} us, K2 "
              f"{p['K2_us']:.1f} us, K3 {p['K3_us']:.1f} us, K3 scatter "
              f"{p['K3_scatter_us']:.1f} us")
        for kname, count, us in p["top"][:4]:
            print(f"      {us:10.1f} us {count:6d}x {kname}")
        out["profile"] = p
    return out


def group_bytes(rt):
    """Bytes on the card of each instanced group's tables (local soup,
    [T, 24] attribute table, [I, 12] instance table, [I, 20] transform
    table) beside what the flattened scene's soup and attribute table
    would take."""
    from ignis_tpu_torch.ops.instanced import group_tables
    out = []
    for g in rt.scene.instances:
        gt = group_tables(g)
        t, i = g.tris_per_instance, g.n_instances
        out.append({"instances": i, "tris_per_instance": t,
                    "local_bvh": g.bvh is not None,
                    "soup_bytes": 9 * 4 * t,
                    "attr_table_bytes": gt.attr.numel() * 4,
                    "instance_table_bytes": gt.inst.numel() * 4,
                    "transform_table_bytes": gt.xform.numel() * 4,
                    "flattened_soup_bytes": 9 * 4 * t * i,
                    "flattened_attr_table_bytes": 24 * 4 * t * i})
    return out


def phase_instanced(device):
    """S7 at 512x512, spi 4 through loadFromString(instancing=True) on the
    card: the groups' bytes, forward steps (launches, host syncs, a
    profiled step) and one albedo train step; then the instanced render
    against the flattened one on _grid_scene(8) at subdivisions 4 (the
    local soup through K1) and 2 (through K2), at tests/test_instancing.py
    :69-73's bars."""
    import torch
    import ignis_tpu_torch
    from ignis_tpu_torch import train_step
    t0 = time.perf_counter()
    rt = ignis_tpu_torch.loadFromString(json.dumps(S7_SCENE), spi=SPI,
                                        instancing=True)
    (geo,) = rt.scene.instances
    sizes = group_bytes(rt)[0]
    print(f"  {S7_NAME}: loaded in {time.perf_counter() - t0:.2f} s; "
          f"bytes on the card: {sizes}")
    check(geo.n_instances == 1024 and geo.tris_per_instance == 5120
          and geo.bvh is not None, f"{S7_NAME}: 1,024 instances of a "
          f"5,120-triangle mesh with its own BVH (K1)")
    out = {"bytes": sizes,
           "forward": measure_steps(S7_NAME, rt, ("K1", "K3_gather_rows"),
                                    steps=2)}
    s = rt.settings
    target = torch.zeros((s.height, s.width, 3), device=device)
    train_step(rt.scene, s, target, 0, 0, 1e-2)     # warm-up
    torch.cuda.synchronize()
    reset_all_counts()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    (loss, _), syncs = count_syncs(
        lambda: train_step(rt.scene, s, target, 0, 0, 1e-2))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    used = launches()
    msps = s.width * s.height * s.spi / sec / 1e6
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    print(f"  {S7_NAME}: train step {msps:.4f} Msamples/s fwd+bwd ({sec:.4f}"
          f" s), peak memory {peak:.3f} GiB, launches {used}, host syncs "
          f"{syncs}")
    check(bool(torch.isfinite(loss)) and used["K1"] > 0
          and used["K3_scatter_add_rows"] > 0 and used["MT_replay_bwd"] == 0
          and plain_calls() == 0,
          f"{S7_NAME}: train step finite through K1 and K3's scatter, no MT "
          f"replay (instanced geometry held fixed), no plain version")
    out["train"] = {"msamples_per_s": msps, "seconds": sec,
                    "peak_gib": peak, "launches": used, "host_syncs": syncs}
    del rt

    out["flattened"] = {sub: instanced_against_flattened(sub)
                        for sub in (4, 2)}
    return out


def instanced_against_flattened(subdivisions, size=512):
    """_grid_scene(8) with its icosphere at `subdivisions` (4: 5,120
    triangles, the local soup through K1; 2: 320, through K2) rendered
    instanced and flattened on the card, one step at spi 4: the 99th
    percentile of the per-pixel relative difference under 0.05 and means
    within 1% (tests/test_instancing.py:69-73)."""
    import ignis_tpu_torch
    local = "K1" if subdivisions >= 4 else "K2"
    doc = json.dumps(grid_scene(8, subdivisions=subdivisions, size=size))
    imgs, used = [], {}
    for inst in (False, True):
        r = ignis_tpu_torch.loadFromString(doc, spi=SPI, instancing=inst)
        reset_all_counts()
        imgs.append(r.step().framebuffer(normalized=True).cpu().numpy())
        used[inst] = launches()
    flat, inst = imgs
    rel = np.abs(flat - inst) / np.maximum(np.abs(flat), 1e-3)
    q99 = float(np.quantile(rel, 0.99))
    dmean = float(abs(flat.mean() - inst.mean()) / max(flat.mean(), 1e-6))
    print(f"  grid_scene(8) at subdivisions {subdivisions}, {size}x{size}: "
          f"means flat {flat.mean():.6f} / instanced {inst.mean():.6f}, 99th "
          f"percentile of the relative difference {q99:.6f}, launches flat "
          f"{used[False]}, instanced {used[True]}")
    check(q99 < 0.05 and dmean < 0.01 and used[True][local] > 0,
          f"grid_scene(8) at subdivisions {subdivisions}: instanced (local "
          f"soup through {local}) against flattened, 99th percentile "
          f"{q99:.4f} < 0.05, means within {dmean:.5f} < 1%")
    return {"q99": q99, "mean_rel": dmean, "flat_mean": float(flat.mean()),
            "instanced_mean": float(inst.mean()), "launches": used}


def phase_techniques(device, s1, env):
    """The other techniques on the card at 512x512, spi 4, each a warm-up,
    a timed step and a profiled step with its launches and host syncs:
    the six simple ones on S1's scene (its loaded arrays), aept on S1's
    scene under S5's substitute env, and S8 under lt and ppm."""
    import dataclasses
    import ignis_tpu_torch
    from ignis_tpu_torch.render.session import Runtime
    out = {}
    for tech in SIMPLE_TECHNIQUES:
        rt = Runtime(s1.scene, dataclasses.replace(s1.settings,
                                                   technique=tech))
        # wireframe and env_check read no hit attributes: no K3
        need = (("K1",) if tech in ("wireframe", "env_check")
                else ("K1", "K3_gather_rows"))
        out[tech] = measure_steps(f"S1 {tech}", rt, need)
    t0 = time.perf_counter()
    rt = ignis_tpu_torch.loadFromString(json.dumps(aept_scene(env)),
                                        spi=SPI)
    print(f"  S1 aept: loaded in {time.perf_counter() - t0:.2f} s")
    reset_all_counts()
    t0 = time.perf_counter()
    rt.step()               # the learning iteration, then a guided one
    import torch
    torch.cuda.synchronize()
    used = launches()
    print(f"  S1 aept: the first step (learning and guided) in "
          f"{time.perf_counter() - t0:.3f} s, launches {used}")
    check(used["K3_scatter_add_rows"] > 0,
          "S1 aept: the learning pass's histograms through K3's scatter")
    out["aept"] = measure_steps("S1 aept", rt, ("K1", "K3_gather_rows"))
    out["aept"]["first_step_launches"] = used
    for tech, need in (("lt", ("K2", "K3_gather_rows",
                               "K3_scatter_add_rows")),
                       ("ppm", ("K2", "K3_gather_rows"))):
        sc = json.loads(json.dumps(S8_BOX))
        sc["technique"]["type"] = tech
        rt = ignis_tpu_torch.loadFromString(json.dumps(sc), spi=SPI)
        if tech == "ppm":
            check(rt.settings.photon_count == 1_000_000,
                  "S8 ppm: 1,000,000 photons")
        out[tech] = measure_steps(f"{S8_NAME} {tech}", rt, need)
    return out


REFERENCE_CASES = SIMPLE_TECHNIQUES + ("aept", "lt", "ppm", "instanced")


def technique_card_vs_cpu(device, name, env_small, size=64):
    """One of REFERENCE_CASES on the card against the CPU at size x size,
    spi 4: 99% of pixels within rtol 1e-3 / atol 1e-4 and image means
    within 1e-4 relative; within 1e-3 for lt and aept, whose splat and
    histograms add in the order of the card's atomics."""
    import ignis_tpu_torch
    bar = 1e-3 if name in ("lt", "aept") else 1e-4
    if name in SIMPLE_TECHNIQUES:
        sc, kw = _ico3(S1_GLASS_ICO7), {"technique": name}
    elif name == "aept":
        sc, kw = aept_scene(env_small, size, subdivisions=3), {}
    elif name == "instanced":
        sc, kw = grid_scene(8), {"instancing": True}
    else:
        sc, kw = S8_BOX, {"technique": name}
        if name == "ppm":
            kw["photons"] = 50000
    small = json.loads(json.dumps(sc))
    small["film"] = {"size": [size, size]}
    imgs = []
    for dev in (device, "cpu"):
        r = ignis_tpu_torch.loadFromString(json.dumps(small), device=dev,
                                           spi=SPI, **kw)
        imgs.append(r.step().framebuffer(normalized=True).cpu().numpy())
    gpu, cpu = imgs
    close = float(np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1).mean())
    rel = float(abs(gpu.mean() - cpu.mean()) / max(cpu.mean(), 1e-9))
    print(f"  {name} {size}x{size}: means card {gpu.mean():.6f} / CPU "
          f"{cpu.mean():.6f} (relative {rel:.3e}), pixels close {close:.4f}")
    check(close >= 0.99 and rel <= bar and cpu.mean() > 0,
          f"{name} {size}x{size}: card against CPU, pixels close "
          f"{close:.4f} >= 0.99, means within {rel:.2e} <= {bar:g}")
    return {"mean_rel": rel, "pixels_close": close,
            "card_mean": float(gpu.mean()), "cpu_mean": float(cpu.mean())}


def phase_techniques_reference(device, env_small):
    """Every technique and the instanced render on the card against the
    CPU at 64x64 (technique_card_vs_cpu)."""
    return {name: technique_card_vs_cpu(device, name, env_small)
            for name in REFERENCE_CASES}


def _no_top(obj):
    """obj without the profiles' `top` lists (for the summary line)."""
    if isinstance(obj, dict):
        return {k: _no_top(v) for k, v in obj.items() if k != "top"}
    return obj


def _ico3(scene):
    s = json.loads(json.dumps(scene))
    s["shapes"][1]["subdivisions"] = 3
    return s



# ---------------------------------------------------------------------------
# phase 9: the scene-language slice (S9)
# ---------------------------------------------------------------------------

# tests/test_runtime_api.py:10 SCENE: a PExpr texture reading the
# registry parameter `tint`; the JAX package's test holds its image mean
# to 4x when tint goes 0.2 -> 0.8
RUNTIME_SCENE = {
    "technique": {"type": "path", "max_depth": 3},
    "camera": {"type": "perspective", "fov": 60,
               "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
    "film": {"size": [16, 16]},
    "parameters": {"tint": 0.2},
    "textures": [{"type": "expr", "name": "refl",
                  "expr": "vec3(tint, tint, tint)"}],
    "bsdfs": [{"type": "diffuse", "name": "g", "reflectance": "refl"}],
    "shapes": [{"type": "rectangle", "name": "B", "width": 4, "height": 4,
                "flip_normals": True}],
    "entities": [{"name": "B", "shape": "B", "bsdf": "g"}],
    "lights": [{"type": "point", "name": "P", "position": [0, 1, -1.5],
                "intensity": [8, 8, 8]}],
}
S9_SKIES = (
    {"type": "cie_uniform"}, {"type": "cie_cloudy"}, {"type": "cie_clear"},
    {"type": "cie_intermediate"}, {"type": "sky", "turbidity": 3.0})
# VOL_SCENE's fog (tests/test_compaction.py:88) with a PExpr sigma_s
# (the participating_media.json gate scene's expression family)
S9_FOG_SIGMA_S = "0.2*(color(1)-norm(Np.xyzz))"


def tensor_bytes(obj) -> int:
    """Bytes of every tensor in nested NamedTuples / tuples."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, tuple):
        return sum(tensor_bytes(v) for v in obj)
    return 0


def record_dj_gathers(rt):
    """(rows, table, k) of every K3 gather of the Dupuy-Jakob corner fetch
    in one step of rt: record_k3_calls' gathers from the scene's
    Dupuy-Jakob gather table."""
    from ignis_tpu_torch.models.djmeasured import DJData
    tables = {m.table.data_ptr() for m in rt.scene.measured
              if isinstance(m, DJData)}
    gathers, _ = record_k3_calls(rt.step)
    return [g for g in gathers if g[1].data_ptr() in tables]


def phase_dj_k3(seen):
    """K3 on the recorded Dupuy-Jakob gathers: each equal to its plain
    version, then the sums of the kernel's, the plain version's and
    torch.index_select's times and of the bound."""
    import torch
    from ignis_tpu_torch.ops import gather
    equal, errs = zip(*[k3_gather_result(*a) for a in seen])
    check(len(seen) > 0 and all(equal), f"S9 Dupuy-Jakob: all {len(seen)} "
          f"recorded K3 gathers equal to tab[idx]")
    t = time_k3_launches(seen, [])["gather"]
    t["plain_ms"] = sum(cuda_ms(lambda: gather.gather_rows_plain(i, tb, k))
                        for i, tb, k in seen)
    t["max_abs_err"] = max(errs)
    t["bound_by"] = "bytes"
    t["table_rows"] = int(seen[0][1].shape[0])
    print(f"  S9 Dupuy-Jakob K3 gathers: {t['launches']} launches, "
          f"{t['lanes']} lanes onto a [{t['table_rows']} x 4] table: kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, index_select "
          f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (sums)")
    torch.cuda.synchronize()
    return t


def _counting(module, name, counter):
    """Wrap module.name so each call adds one to counter[name]; returns
    the original."""
    real = getattr(module, name)

    def wrapped(*a, **kw):
        counter[name] = counter.get(name, 0) + 1
        return real(*a, **kw)
    setattr(module, name, wrapped)
    return real


def phase_tint(device, rt):
    """setParameter("tint") on the card: on S9 (`rt` has stepped, so its
    node records are packed), one step before and one after the change
    with pack_nodes and render_tables calls counted: the same counts, no
    rebuild, the registry's tensor updated in place, the image moved; on
    tests/test_runtime_api.py's scene, the JAX package's 4x ratio (within
    its 0.01)."""
    import ignis_tpu_torch
    from ignis_tpu_torch.ops import bvh_cuda
    from ignis_tpu_torch.render import session
    from ignis_tpu_torch.techniques import path
    reg = rt.scene.registry["tint"]
    counts = [{}, {}]
    means = []
    for i, tint in enumerate((None, S9_TINT / 2)):
        if tint is not None:
            rt.setParameter("tint", tint)
        rt.reset()
        real_pack = _counting(bvh_cuda, "pack_nodes", counts[i])
        real_tabs = _counting(path, "render_tables", counts[i])
        real_stabs = _counting(session, "render_tables", counts[i])
        try:
            rt.step()
        finally:
            bvh_cuda.pack_nodes = real_pack
            path.render_tables = real_tabs
            session.render_tables = real_stabs
        means.append(float(rt.framebuffer(normalized=True).mean()))
    print(f"  S9 setParameter('tint', {S9_TINT} -> {S9_TINT / 2}): image "
          f"mean {means[0]:.6f} -> {means[1]:.6f}; calls a step before "
          f"{counts[0]}, after {counts[1]}; rebuilds {rt.rebuilds}")
    check(counts[0] == counts[1] and rt.rebuilds == 0
          and rt.scene.registry["tint"] is reg
          and abs(float(reg) - S9_TINT / 2) < 1e-7
          and means[1] < means[0],
          "S9 tint: no rebuild (pack_nodes and render_tables calls "
          "unchanged), the registry tensor updated in place, the image "
          "darker")
    r = ignis_tpu_torch.loadFromString(json.dumps(RUNTIME_SCENE),
                                       device=device, spi=8)
    a = float(r.step().framebuffer(normalized=True).mean())
    r.setParameter("tint", 0.8)
    r.reset()
    b = float(r.step().framebuffer(normalized=True).mean())
    check(abs(b / a - 4.0) < 0.01 and r.rebuilds == 0,
          f"tests/test_runtime_api.py's scene on the card: mean ratio "
          f"{b / a:.6f} within 0.01 of 4, no rebuild")
    print(f"  tests/test_runtime_api.py's scene: ratio {b / a:.6f}")
    return {"mean_before": means[0], "mean_after": means[1],
            "calls_before": counts[0], "calls_after": counts[1],
            "runtime_api_ratio": b / a}


def phase_s9(device, build_dir):
    """S9 at 512x512, spi 4: forward steps (launches, host syncs, one
    profiled step), the Dupuy-Jakob K3 gathers against their plain
    version, setParameter('tint') without a rebuild, an albedo train
    step with its peak memory; then card against CPU at 64x64: S9 at
    subdivisions 1 (K2), each CIE sky and the Hosek sky, VOL_SCENE's fog
    with a PExpr sigma_s, and bake_texture2d."""
    import torch
    import ignis_tpu_torch
    from ignis_tpu_torch import train_step
    from ignis_tpu_torch.render.bake import bake_texture2d
    t0 = time.perf_counter()
    sc = s9_scene(build_dir)
    rt = ignis_tpu_torch.loadFromString(json.dumps(sc), spi=SPI)
    load_s = time.perf_counter() - t0
    n = rt.scene.tris.v0.x.numel()
    mbytes = [tensor_bytes(m) for m in rt.scene.measured]
    kinds = [type(m).__name__ for m in rt.scene.measured]
    print(f"  {S9_NAME}: {n} triangles, BVH "
          f"{'yes' if rt.scene.bvh is not None else 'no'}, measured tables "
          f"{dict(zip(kinds, mbytes))} bytes on the card, registry "
          f"{sorted(rt.scene.registry)}, BSDF kinds {rt.settings.bsdf_kinds},"
          f" light kinds {rt.settings.light_kinds}; files written and "
          f"loaded in {load_s:.2f} s")
    check(n == 102402 and rt.scene.bvh is not None and rt.warnings == []
          and kinds == ["KlemsData", "TensorTreeData", "DJData"]
          and {11, 12, 13} <= set(rt.settings.bsdf_kinds)
          and {4, 5} <= set(rt.settings.light_kinds)
          and "tint" in rt.scene.registry,
          f"{S9_NAME}: 102,402 triangles with a BVH, the three measured "
          f"tables, the perez sky with its sun, the registry")
    fwd = measure_steps(S9_NAME, rt, ("K1", "K3_gather_rows"))
    seen = record_dj_gathers(rt)
    dj = phase_dj_k3(seen)
    tint = phase_tint(device, rt)
    s = rt.settings
    target = torch.zeros((s.height, s.width, 3), device=device)
    reset_all_counts()
    secs, peaks = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t1 = time.perf_counter()
        loss, new_scene = train_step(rt.scene, s, target, 0, 0, 1e-2)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        peaks.append(torch.cuda.max_memory_allocated(device))
    used = launches()
    grad = torch.stack(list(rt.scene.materials.base)) - torch.stack(
        list(new_scene.materials.base))
    msps = s.width * s.height * s.spi / min(secs[1:]) / 1e6
    print(f"  {S9_NAME}: train step {msps:.4f} Msamples/s fwd+bwd (faster of "
          f"{[round(x, 4) for x in secs[1:]]} s), peak memory "
          f"{max(peaks) / 2**30:.3f} GiB, loss {float(loss):.6f}, launches "
          f"{used}")
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all())
          and bool((grad != 0).any()) and used["K1"] > 0
          and used["K3_gather_rows"] > 0 and used["K3_scatter_add_rows"] > 0
          and plain_calls() == 0,
          f"{S9_NAME}: train step finite, albedo gradient nonzero, K1 and K3 "
          f"launched, no plain version")
    train = {"msamples_per_s": msps, "step_s": secs,
             "peak_gib": max(peaks) / 2**30, "loss": float(loss),
             "launches": used}

    small = s9_scene(build_dir, subdivisions=1, size=64)
    r = ignis_tpu_torch.loadFromString(json.dumps(small), spi=SPI)
    check(r.scene.bvh is None, "S9 at subdivisions 1: under the BVH "
          "threshold (K2)")
    ref = {"S9 at subdivisions 1": card_vs_cpu(device, "S9 at subdivisions "
                                               "1", small)}
    for sky in S9_SKIES:
        scene = {**small, "lights": [{**sky, "name": "sky",
                                      "direction": S9_SUN}]}
        ref[sky["type"]] = card_vs_cpu(device, f"S9 small under "
                                       f"{sky['type']}", scene)
    fog = {
        "technique": {"type": "volpath", "max_depth": 8},
        "camera": S1_GLASS_ICO7["camera"], "film": {"size": [64, 64]},
        "bsdfs": [{"type": "diffuse", "name": "w",
                   "reflectance": [0.7, 0.7, 0.7]},
                  {"type": "dielectric", "name": "glass", "int_ior": 1.1}],
        "media": [{"type": "homogeneous", "name": "fog",
                   "sigma_a": [0.1, 0.1, 0.1], "sigma_s": S9_FOG_SIGMA_S,
                   "g": 0.2}],
        "shapes": [{"type": "rectangle", "name": "floor", "width": 6,
                    "height": 6},
                   {"type": "icosphere", "name": "ball", "radius": 0.8,
                    "subdivisions": 3}],
        "entities": [
            {"name": "floor", "shape": "floor", "bsdf": "w",
             "transform": [{"rotate": [-90, 0, 0]},
                           {"translate": [0, -1, 0]}]},
            {"name": "ball", "shape": "ball", "bsdf": "glass",
             "inner_medium": "fog"}],
        "lights": [{"type": "point", "name": "l", "position": [2, 3, 2],
                    "power": 60},
                   {"type": "env", "name": "e",
                    "radiance": [0.2, 0.25, 0.3]}]}
    ref["pexpr_fog"] = card_vs_cpu(device, "VOL_SCENE fog with a PExpr "
                                   "sigma_s", fog)
    params = {"tint": ("num", 0.6)}
    a = bake_texture2d(S9_FLOOR, 256, 128, parameters=params, device=device)
    b = bake_texture2d(S9_FLOOR, 256, 128, parameters=params, device="cpu")
    err = float(np.abs(a - b).max())
    check(a.shape == (128, 256, 3) and err <= 1e-6 * max(np.abs(b).max(), 1),
          f"bake_texture2d of S9's floor on the card vs the CPU: max |diff| "
          f"{err:.3e}")
    print(f"  bake_texture2d 256x128 of S9's floor: card vs CPU max |diff| "
          f"{err:.3e}")
    ref["bake"] = err
    return {"load_s": load_s, "triangles": n,
            "measured_bytes": dict(zip(kinds, mbytes)), "forward": fwd,
            "dj_k3": dj, "tint": tint, "train": train, "reference": ref}

def main() -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-json", metavar="PATH",
                    help="also write the renders' timings and the profiled "
                         "steps' breakdown to PATH")
    args = ap.parse_args()
    t_start = time.perf_counter()
    print(f"== phase 1: device ({time.perf_counter() - t_start:.1f} s in)")
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke needs one card", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"  torch.cuda.get_device_name: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    sys.path.insert(0, str(ROOT))
    import ignis_tpu_torch
    device = torch.device("cuda:0")

    print(f"== phase 2: build ({time.perf_counter() - t_start:.1f} s in)")
    phase_build()

    print(f"== loading S1-S5 on the card "
          f"({time.perf_counter() - t_start:.1f} s in)")
    from ignis_tpu_torch.utils.envgen import ensure_substitute_env
    t0 = time.perf_counter()
    env = ensure_substitute_env(ROOT / "build", *S5_ENV)
    env_small = ensure_substitute_env(ROOT / "build", 256, 128)
    print(f"  substitute envs {env.name}, {env_small.name} in "
          f"{time.perf_counter() - t0:.2f} s")
    runtimes = {}
    for name, sc in [(n, sc) for n, sc, _ in SCENES] + [
            (S5_NAME, s5_scene(env))]:
        t0 = time.perf_counter()
        runtimes[name] = ignis_tpu_torch.loadFromString(json.dumps(sc),
                                                        spi=SPI)
        rt = runtimes[name]
        check(rt.scene.device == device, f"{name} loaded onto {device} by "
              f"default")
        print(f"  {name}: {rt.scene.tris.v0.x.numel()} triangles, "
              f"{rt.scene.spheres.radius.numel()} spheres, BVH "
              f"{'yes' if rt.scene.bvh is not None else 'no'}, loaded in "
              f"{time.perf_counter() - t0:.2f} s")
    s5 = runtimes[S5_NAME]
    check(s5.scene.tris.v0.x.numel() == 184324 and s5.scene.bvh is not None
          and tuple(s5.scene.textures[3].image.shape) == (2048, 4096, 3),
          f"{S5_NAME}: 184,324 triangles with a BVH, the 4096x2048 env")
    t0 = time.perf_counter()
    s6_dict = s6_scene(ROOT / "build")
    print(f"  {S6_NAME}: mesh files written in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    s6 = runtimes[S6_NAME] = ignis_tpu_torch.loadFromString(
        json.dumps(s6_dict), spi=SPI)
    n6 = s6.scene.tris.v0.x.numel()
    print(f"  {S6_NAME}: {n6} triangles, BVH "
          f"{'yes' if s6.scene.bvh is not None else 'no'}, technique "
          f"{s6.settings.technique}, transparent_shadows "
          f"{s6.settings.transparent_shadows}, "
          f"{s6.scene.media.g.numel()} media, loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    check(n6 == 327808 and s6.scene.bvh is not None
          and s6.settings.transparent_shadows
          and s6.settings.technique == "volpath" and s6.warnings == [],
          f"{S6_NAME}: 327,808 triangles with a BVH, volpath with "
          f"transparent shadows")
    s6_small = s6_scene(ROOT / "build", subdivisions=2, size=64)

    print(f"== phase 3: K2 against its plain version ({time.perf_counter() - t_start:.1f} s in)")
    k2_err = phase_k2(device)
    k2_sets = phase_k2_sets(device, {
        "S2": (runtimes["S2_graft_entry"], S2_LIGHT),
        "S4": (runtimes["S4_glass_ico2"], S1_LIGHT)})

    print(f"== phase 4: K1 against its plain version and against K2 ({time.perf_counter() - t_start:.1f} s in)")
    k1_err, k1_rays = phase_k1(device, runtimes["S1_glass_ico7"])
    times = phase_times(device, runtimes["S1_glass_ico7"], k1_rays)
    k1_sets, deepest = phase_k1_sets(
        device, {"S1": runtimes["S1_glass_ico7"],
                 "S3": runtimes["S3_bench_big"]})
    s6_sets, deepest6 = phase_k1_sets(device, {"S6": s6},
                                      sets_of=crossing_sets)
    k1_sets.update(s6_sets)
    deepest = max(deepest, deepest6)

    print(f"== phase 5: render S1-S6 ({time.perf_counter() - t_start:.1f} s in)")
    counts, per_scene = phase_render(device, runtimes)
    profile = phase_profile(runtimes)

    print(f"== phase 6: reference checks ({time.perf_counter() - t_start:.1f} s in)")
    phase_reference(device, s5_scene(env_small, subdivisions=1, size=64),
                    s6_small)

    print(f"== phase 7: gradients ({time.perf_counter() - t_start:.1f} s in)")
    grad_errs, grad_times = phase_grad_kernels(
        device, runtimes["S1_glass_ico7"], k1_rays)
    grad_counts, train = phase_train(device, runtimes)
    train_profile = phase_train_profile(device, runtimes)
    geometry_profile = phase_geometry_profile(device,
                                              runtimes["S1_glass_ico7"])
    k3_recorded = phase_k3_recorded(device, runtimes)
    albedo = phase_albedo_shape(device, runtimes["S1_glass_ico7"])
    k3_tables = {
        "S5 material table": phase_k3_table(
            device, "S5 material table", *k3_material_set(s5, device)),
        "S6 medium table": phase_k3_table(
            device, "S6 medium table", *k3_medium_set(s6, device))}
    phase_grad_reference(device)
    sigma = phase_sigma(device, s6, s6_small)

    print(f"== phase 8: instancing and the other techniques "
          f"({time.perf_counter() - t_start:.1f} s in)")
    instancing = phase_instanced(device)
    techniques = phase_techniques(device, runtimes["S1_glass_ico7"], env)
    techniques_reference = phase_techniques_reference(device, env_small)

    print(f"== phase 9: the scene-language slice, S9 "
          f"({time.perf_counter() - t_start:.1f} s in)")
    s9 = phase_s9(device, ROOT / "build")

    def timed(t):
        ms, plain, bms, by = t
        return {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by}
    k1_sets["S1 phase-4 65,536 any hit"] = timed(times["K1_any"])
    kernels = [
        {"name": "K1_bvh_walk", "route": "cuda",
         "source": "ignis_tpu_torch/csrc/bvh_walk.cu",
         "replaces": "ignis_tpu/ops/pallas_bvh.py:74",
         "launches": counts["K1"],
         "max_abs_err": max([k1_err] + [r["max_abs_err"]
                                        for r in k1_sets.values()
                                        if "max_abs_err" in r]),
         **timed(times["K1"]), "library_ms": None, "deepest_stack": deepest,
         "sets": k1_sets},
        {"name": "K2_isect_dense", "route": "cuda",
         "source": "ignis_tpu_torch/csrc/isect_dense.cu",
         "replaces": "ignis_tpu/ops/pallas_isect.py:156",
         "launches": counts["K2"],
         "max_abs_err": max([k2_err] + [r["max_abs_err"]
                                        for r in k2_sets.values()]),
         **timed(times["K2"]),
         "dense_ms": dense_bound(262144, runtimes["S2_graft_entry"].scene
                                 .tris.v0.x.numel())[0],
         "library_ms": None,
         "sets": k2_sets},
    ]
    for name, source, replaces in (
            ("K3_gather_rows", "ignis_tpu_torch/csrc/gather_cols.cu",
             "ignis_tpu/ops/gather.py:59"),
            ("K3_scatter_add_rows", "ignis_tpu_torch/csrc/gather_cols.cu",
             "ignis_tpu/ops/gather.py:121"),
            ("MT_replay_bwd", "ignis_tpu_torch/csrc/mt_replay_bwd.cu",
             "ignis_tpu/ops/pallas_isect.py:381")):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": grad_counts[name],
                        "max_abs_err": grad_errs[name], **grad_times[name]})
    by_name = {k["name"]: k for k in kernels}
    for name, part in (("K3_gather_rows", "gather"),
                       ("K3_scatter_add_rows", "scatter")):
        by_name[name]["sets"].update({f"{scene} geometry step": row[part]
                                      for scene, row in k3_recorded.items()})
    by_name["K3_scatter_add_rows"]["sets"]["S1 albedo shape"] = albedo
    for name, part in (("K3_gather_rows", "gather"),
                       ("K3_scatter_add_rows", "scatter")):
        for table, row in k3_tables.items():
            by_name[name]["sets"][table] = row[part]
            by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"],
                                               row[part]["max_abs_err"])
    by_name["K3_gather_rows"]["sets"]["S9 Dupuy-Jakob step"] = s9["dj_k3"]
    by_name["K3_gather_rows"]["max_abs_err"] = max(
        by_name["K3_gather_rows"]["max_abs_err"], s9["dj_k3"]["max_abs_err"])
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} launched on the main path")
    if args.profile_json:
        Path(args.profile_json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.profile_json).write_text(json.dumps(
            {"nvidia_smi": smi, "scenes": per_scene, "profile": profile,
             "train": train, "sigma": sigma, "train_profile": train_profile,
             "geometry_profile": geometry_profile,
             "instancing": instancing, "techniques": techniques,
             "techniques_reference": techniques_reference, "s9": s9},
            indent=1))
    print(json.dumps({"scenes": per_scene, "train": train, "sigma": sigma,
                      "geometry_profile_us": {
                          k: v for k, v in geometry_profile.items()
                          if k.endswith("_us")}}))
    print(json.dumps({"instancing": _no_top(instancing),
                      "techniques": _no_top(techniques),
                      "techniques_reference": techniques_reference}))
    print(json.dumps({"s9": _no_top(s9)}))
    print(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
