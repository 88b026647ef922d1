"""igutil-equivalent tool (port of ignis_tpu/util_cli.py; the reference's
src/tools/util/main.cpp).

    python -m ignis_tpu_torch.util_cli info image.exr
    python -m ignis_tpu_torch.util_cli convert in.exr out.png
    python -m ignis_tpu_torch.util_cli glare image.exr
    python -m ignis_tpu_torch.util_cli inspect window.xml -o bsdf.exr

Subcommands:
  info <image>                 image statistics (ImageInfo.cpp)
  convert <input> <output>     image <-> image (EXR, HDR, PNG; exposure and
                               offset for PNG), mesh <-> mesh (obj, ply,
                               serialized -> obj, ply), Mitsuba XML -> JSON
  glare <image>                glare metrics (igexplorer's evalglare)
  inspect <bsdf>               a measured BSDF's slice at one incident
                               direction (bsdfinspector)
info, glare and inspect compute on the CUDA card unless `--target cpu`;
without a card they exit 2.
"""
from __future__ import annotations

import argparse
import sys

from .cli import add_target_args, target_device

IMAGE_EXT = {".exr", ".hdr", ".png", ".jpg", ".jpeg", ".bmp", ".tga"}
MESH_EXT = {".obj", ".ply", ".serialized", ".mts"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="igtorch-util",
                                description="ignis_tpu_torch utility tool")
    sub = p.add_subparsers(dest="command", required=True)

    pi = sub.add_parser("info", help="Print image statistics")
    pi.add_argument("input")
    add_target_args(pi)

    pb = sub.add_parser(
        "inspect", help="Visualize a measured BSDF (bsdfinspector analog)")
    pb.add_argument("input", help=".xml (klems/tensortree) or .bsdf file")
    pb.add_argument("-o", "--output", default="bsdf.exr")
    pb.add_argument("--theta", type=float, default=30.0,
                    help="Incident theta in degrees")
    pb.add_argument("--phi", type=float, default=0.0,
                    help="Incident phi in degrees")
    pb.add_argument("--res", type=int, default=256)
    add_target_args(pb)

    pg = sub.add_parser(
        "glare", help="Glare analysis (igexplorer evalglare analog)")
    pg.add_argument("input", help="radiance image (EXR/HDR)")
    pg.add_argument("--fov", type=float, default=60.0)
    pg.add_argument("--mul", type=float, default=5.0,
                    help="glare source luminance multiplier over average")
    pg.add_argument("--scale", type=float, default=1.0)
    pg.add_argument("--ev", type=float, default=-1.0,
                    help="vertical illuminance (lx); <0 = automatic")
    pg.add_argument("-o", "--output", default=None,
                    help="optional EXR for the relative source map")
    add_target_args(pg)

    pc = sub.add_parser("convert", help="Convert images or meshes")
    pc.add_argument("input")
    pc.add_argument("output")
    pc.add_argument("--exposure", type=float, default=0.0,
                    help="Tonemap exposure (2^x) for LDR outputs")
    pc.add_argument("--offset", type=float, default=0.0,
                    help="Tonemap offset for LDR outputs")
    pc.add_argument("--shape-index", type=int, default=0,
                    help="Shape index for .serialized inputs")
    return p


def _cmd_info(args, device) -> int:
    import torch
    from .render.tonemap import image_info
    from .utils.image import load_image
    img = load_image(args.input)
    info = image_info(torch.from_numpy(img).to(device))
    h, w = img.shape[0], img.shape[1]
    print(f"size: {w}x{h}")
    for k in ("min", "max", "average", "soft_min", "soft_max", "median",
              "inf_count", "nan_count", "neg_count"):
        print(f"{k}: {getattr(info, k).cpu().numpy()}")
    return 0


def _cmd_convert(args) -> int:
    from pathlib import Path
    in_ext = Path(args.input).suffix.lower()
    out_ext = Path(args.output).suffix.lower()
    if in_ext in MESH_EXT and out_ext in MESH_EXT:
        from .scene import mesh as meshlib
        if in_ext in (".serialized", ".mts"):
            m = meshlib.load_mts_serialized(args.input, args.shape_index)
        elif in_ext == ".obj":
            m = meshlib.load_obj(args.input)
        else:
            m = meshlib.load_ply(args.input)
        if out_ext == ".obj":
            meshlib.save_obj(args.output, m)
        elif out_ext == ".ply":
            meshlib.save_ply(args.output, m)
        else:
            print(f"Cannot write mesh format {out_ext}", file=sys.stderr)
            return 1
        print(f"{args.input} -> {args.output}: {len(m.vertices)} vertices, "
              f"{len(m.indices)} faces")
        return 0
    if in_ext == ".xml" and out_ext == ".json":
        from .scene.mitsuba import convert_mitsuba
        convert_mitsuba(args.input, args.output)
        print(f"{args.input} -> {args.output} (mitsuba scene)")
        return 0
    if in_ext in IMAGE_EXT:
        import numpy as np
        from .utils.image import load_image, save_image
        img = np.asarray(load_image(args.input), np.float32)
        if out_ext not in (".exr", ".hdr"):
            img = img * (2.0 ** args.exposure) + args.offset
        save_image(args.output, img)
        print(f"{args.input} -> {args.output}")
        return 0
    print(f"Unsupported conversion {in_ext} -> {out_ext}", file=sys.stderr)
    return 1


def _klems_layers(path, theta_i, phi_i, theta_o, phi_o, inside, res):
    """The JAX tool's raster of a Klems matrix (numpy): the incident
    column at the nearest patch, each outgoing pixel's row."""
    import numpy as np
    from .scene.klems import load_klems
    k = load_klems(path)
    layers = {}
    for lname, comp in (("FrontTransmission", k.front_transmission),
                        ("FrontReflection", k.front_reflection)):
        ti = np.searchsorted(comp.col.upper, theta_i)
        ti = min(ti, len(comp.col.upper) - 1)
        nphi = comp.col.phi_count[ti]
        pidx = int(phi_i / (2 * np.pi) * nphi + 0.5) % max(nphi, 1)
        col = comp.col.lin_off[ti] + pidx
        vals = comp.matrix[:, col]
        to_r = np.searchsorted(comp.row.upper, theta_o.ravel())
        to_r = np.minimum(to_r, len(comp.row.upper) - 1)
        nph = comp.row.phi_count[to_r]
        pho = (phi_o.ravel() % (2 * np.pi))
        pidx_o = ((pho / (2 * np.pi) * nph + 0.5) % np.maximum(
            nph, 1)).astype(int)
        rows = comp.row.lin_off[to_r] + pidx_o
        im = np.array(vals[rows].reshape(res, res))
        im[~inside] = 0
        layers[lname] = np.stack([im] * 3, -1).astype(np.float32)
        print(f"{lname}: total {comp.total:.4f}")
    return layers


def _cmd_inspect(args, device) -> int:
    """Headless bsdfinspector (src/tools/bsdfinspector/): a measured BSDF
    at one incident direction as hemisphere heat maps. Klems rasterizes
    its matrix in numpy, as the JAX tool does; TensorTree evaluates the
    port's models/tensortree.py on `device` where the JAX tool uses jnp;
    Dupuy-Jakob evaluates models/djmeasured.py (fr * cos theta_o, the
    incident direction as the known one), where the JAX tool's numpy
    slice indexes its [P, T, H, W, 3] table as [T, H, W, 3] and fails."""
    import numpy as np
    import torch

    from .core.vec import Color, Vec3
    from .utils.image import write_exr_multilayer

    theta_i = np.deg2rad(args.theta)
    phi_i = np.deg2rad(args.phi)
    res = args.res

    # the outgoing hemisphere as a disk image
    ys, xs = np.mgrid[0:res, 0:res]
    px = (xs + 0.5) / res * 2.0 - 1.0
    py = (ys + 0.5) / res * 2.0 - 1.0
    r = np.sqrt(px * px + py * py)
    inside = r <= 1.0
    theta_o = np.arcsin(np.clip(r, 0, 1))
    phi_o = np.arctan2(py, px)

    def lanes(a):
        return torch.as_tensor(np.asarray(a, np.float32).ravel(),
                               device=device)
    wo = Vec3(lanes(np.sin(theta_o) * np.cos(phi_o)),
              lanes(np.sin(theta_o) * np.sin(phi_o)), lanes(np.cos(theta_o)))
    n = res * res

    def full(v):
        return torch.full((n,), float(v), dtype=torch.float32, device=device)
    wi = Vec3(full(np.sin(theta_i) * np.cos(phi_i)),
              full(np.sin(theta_i) * np.sin(phi_i)), full(np.cos(theta_i)))

    def image(v):
        im = np.array(v.cpu().numpy().reshape(res, res))
        im[~inside] = 0
        return im

    path = str(args.input)
    layers = {}
    if path.endswith(".bsdf"):
        from .models.djmeasured import dj_eval, from_numpy
        from .scene.djmeasured import load_djmeasured
        d = load_djmeasured(path)
        white = Color(full(1.0), full(1.0), full(1.0))
        c = dj_eval(from_numpy(d, device), white, wo, wi)
        layers[""] = np.stack([image(c.r), image(c.g), image(c.b)],
                              -1).astype(np.float32)
        print(f"djmeasured: {len(d.theta_nodes)} theta nodes")
    else:
        with open(path) as f:
            text = f.read()
        if "TensorTree" in text:
            from .models.tensortree import _eval_component, from_numpy
            from .scene.tensortree import load_tensortree
            tt = from_numpy(load_tensortree(path), device=device)
            nd = tt.front_transmission.grid.dim()
            for lname, comp in (("FrontTransmission", tt.front_transmission),
                                ("FrontReflection", tt.front_reflection)):
                win = Vec3(-wi.x, -wi.y, -wi.z) \
                    if lname == "FrontTransmission" else wi
                im = image(_eval_component(comp, nd, win, wo))
                layers[lname] = np.stack([im] * 3, -1).astype(np.float32)
                print(f"{lname}: total {float(comp.total):.4f}")
        else:
            layers = _klems_layers(path, theta_i, phi_i, theta_o, phi_o,
                                   inside, res)
        layers[""] = layers.pop("FrontTransmission")
    write_exr_multilayer(args.output, layers,
                         {"igTheta": float(args.theta),
                          "igPhi": float(args.phi)})
    print(f"wrote {args.output}")
    return 0


def _cmd_glare(args, device) -> int:
    import torch
    from .render.glare import compute_glare
    from .utils.image import load_image
    img = load_image(args.input)
    r = compute_glare(torch.from_numpy(img[..., :3]).to(device),
                      fov_deg=args.fov, mul=args.mul, scale=args.scale,
                      vertical_illuminance=args.ev)
    # the explorer's overview table (OverviewWidget.cpp:46-74)
    perception = "Imperceptible"
    if r.dgp > 0.45:
        perception = "Intolerable"
    elif r.dgp > 0.40:
        perception = "Disturbing"
    elif r.dgp > 0.35:
        perception = "Perceptible"
    print(f"DGP     {r.dgp:8.3f}  ({perception})")
    print(f"DGI     {r.dgi:8.3f}")
    print(f"DGI_mod {r.dgi_mod:8.3f}")
    print(f"DGR     {r.dgr:8.3f}")
    print(f"VCP     {r.vcp:8.3f}")
    print(f"UGR     {r.ugr:8.3f}")
    print(f"UGR_exp {r.ugr_exp:8.3f}")
    print(f"UGP     {r.ugp:8.3f}")
    print(f"Ev      {r.vertical_illuminance:8.3f} lx")
    print(f"Lum avg {r.avg_lum:8.3f} cd/m^2   max {r.max_lum:.3f}")
    print(f"Source  lum {r.source_lum:.3f}  omega {r.source_omega:.5f}  "
          f"at ({r.source_x:.1f}, {r.source_y:.1f})")
    if args.output:
        import numpy as np
        from .utils.image import save_image
        m = r.source_map.astype("float32")
        save_image(args.output, np.stack([m, m, m], axis=-1))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "convert":
        return _cmd_convert(args)
    device = target_device(args)
    if device is None:
        return 2
    return {"info": _cmd_info, "inspect": _cmd_inspect,
            "glare": _cmd_glare}[args.command](args, device)


if __name__ == "__main__":
    sys.exit(main())
