"""Mitsuba XML scene -> ignis JSON converter.

A copy of ignis_tpu/scene/mitsuba.py (the reference igutil's Mitsuba
import, MtsConverter.cpp via tinyparser-mitsuba); plain Python. Covers
the common node set — integrator, perspective sensor + hdrfilm,
diffuse/dielectric/conductor/plastic/roughplastic/twosided/mask bsdfs,
ply/obj/serialized/rectangle/cube/sphere shapes with to_world transforms,
area/point/constant/envmap emitters, $defaults and <default>
substitution.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Optional


def _subst(value: str, defaults: dict) -> str:
    if value and "$" in value:
        for k, v in defaults.items():
            value = value.replace("$" + k, str(v))
    return value


def _props(el, defaults) -> dict:
    """Collect typed child properties of a Mitsuba node."""
    out = {}
    for ch in el:
        name = ch.get("name")
        if ch.tag in ("float", "integer"):
            v = _subst(ch.get("value", "0"), defaults)
            out[name] = float(v) if ch.tag == "float" else int(float(v))
        elif ch.tag in ("boolean",):
            out[name] = _subst(ch.get("value", "false"),
                               defaults).lower() == "true"
        elif ch.tag in ("string",):
            out[name] = _subst(ch.get("value", ""), defaults)
        elif ch.tag in ("rgb", "spectrum", "color"):
            v = _subst(ch.get("value", "0"), defaults).replace(",", " ")
            parts = [float(x) for x in v.split()]
            out[name] = parts * 3 if len(parts) == 1 else parts[:3]
    return out


def _transform(el, defaults):
    """<transform> children -> our transform DSL list (applied in order)."""
    import numpy as np
    ops = []
    for ch in el:
        if ch.tag == "translate":
            ops.append({"translate": _vec3(ch, defaults)})
        elif ch.tag == "scale":
            v = ch.get("value")
            if v is not None:
                s = float(_subst(v, defaults))
                ops.append({"scale": [s, s, s]})
            else:
                ops.append({"scale": _vec3(ch, defaults, default=1.0)})
        elif ch.tag == "rotate":
            axis = _vec3(ch, defaults)
            ang = float(_subst(ch.get("angle", "0"), defaults))
            # our DSL: rotate = euler xyz degrees; use axis-angle via
            # qrotate when off-axis
            if axis == [1, 0, 0]:
                ops.append({"rotate": [ang, 0, 0]})
            elif axis == [0, 1, 0]:
                ops.append({"rotate": [0, ang, 0]})
            elif axis == [0, 0, 1]:
                ops.append({"rotate": [0, 0, ang]})
            else:
                half = np.deg2rad(ang) / 2.0
                a = np.asarray(axis, float)
                a = a / max(np.linalg.norm(a), 1e-12)
                s = np.sin(half)
                ops.append({"qrotate": [float(np.cos(half)),
                                        float(a[0] * s), float(a[1] * s),
                                        float(a[2] * s)]})
        elif ch.tag == "lookat":
            def pv(attr):
                return [float(x) for x in
                        _subst(ch.get(attr, "0,0,0"), defaults)
                        .replace(",", " ").split()]
            ops.append({"lookat": {"origin": pv("origin"),
                                   "target": pv("target"), "up": pv("up")}})
        elif ch.tag == "matrix":
            vals = [float(x) for x in
                    _subst(ch.get("value", ""), defaults).split()]
            ops.append({"matrix": vals})
    return ops


def _vec3(ch, defaults, default=0.0):
    if ch.get("value") is not None:
        v = _subst(ch.get("value"), defaults).replace(",", " ").split()
        if len(v) == 1:
            return [float(v[0])] * 3
        return [float(x) for x in v[:3]]
    return [float(_subst(ch.get(a, str(default)), defaults))
            for a in ("x", "y", "z")]


_BSDF_MAP = {
    "diffuse": "diffuse",
    "roughdiffuse": "roughdiffuse",
    "dielectric": "dielectric",
    "thindielectric": "thindielectric",
    "roughdielectric": "roughdielectric",
    "conductor": "conductor",
    "roughconductor": "roughconductor",
    "plastic": "plastic",
    "roughplastic": "roughplastic",
    "principled": "principled",
}


def _convert_bsdf(el, defaults, name: str) -> dict:
    t = el.get("type")
    if t in ("twosided", "mask", "bumpmap", "normalmap"):
        inner = el.find("bsdf")
        if inner is not None:
            # flatten: our frames are two-sided already; mask opacity kept
            b = _convert_bsdf(inner, defaults, name)
            if t == "mask":
                p = _props(el, defaults)
                return {"type": "mask", "name": name, "bsdf": name + "_in",
                        "opacity": p.get("opacity", 1.0),
                        "_inner": dict(b, name=name + "_in")}
            return b
    p = _props(el, defaults)
    out = {"type": _BSDF_MAP.get(t, "diffuse"), "name": name}
    ren = {"reflectance": "reflectance", "int_ior": "int_ior",
           "ext_ior": "ext_ior", "alpha": "roughness",
           "specular_reflectance": "specular_reflectance",
           "specular_transmittance": "specular_transmittance",
           "diffuse_reflectance": "diffuse_reflectance",
           "eta": "eta", "k": "k", "base_color": "base_color",
           "roughness": "roughness", "metallic": "metallic"}
    for k, v in p.items():
        if k in ren:
            out[ren[k]] = v
    return out


def convert_mitsuba(path, out_path: Optional[str] = None) -> dict:
    """Convert a Mitsuba 2/3 XML scene file to an ignis JSON dict."""
    import json

    root = ET.parse(str(path)).getroot()
    defaults = {}
    for d in root.findall("default"):
        defaults[d.get("name")] = d.get("value")

    scene = {"technique": {"type": "path"}, "bsdfs": [], "shapes": [],
             "entities": [], "lights": [], "textures": []}

    integ = root.find("integrator")
    if integ is not None:
        p = _props(integ, defaults)
        scene["technique"] = {
            "type": {"path": "path", "volpath": "volpath",
                     "ptracer": "lt"}.get(integ.get("type"), "path"),
            "max_depth": int(p.get("max_depth", 64)),
        }

    sensor = root.find("sensor")
    if sensor is not None:
        p = _props(sensor, defaults)
        cam = {"type": "perspective", "fov": p.get("fov", 60.0),
               "near_clip": p.get("near_clip", 0.01),
               "far_clip": p.get("far_clip", 1e4)}
        tr = sensor.find("transform")
        if tr is not None:
            cam["transform"] = _transform(tr, defaults)
        scene["camera"] = cam
        film = sensor.find("film")
        if film is not None:
            fp = _props(film, defaults)
            scene["film"] = {"size": [int(fp.get("width", 512)),
                                      int(fp.get("height", 512))]}

    for b in root.findall("bsdf"):
        name = b.get("id") or f"bsdf_{len(scene['bsdfs'])}"
        cv = _convert_bsdf(b, defaults, name)
        inner = cv.pop("_inner", None)
        if inner:
            scene["bsdfs"].append(inner)
        scene["bsdfs"].append(cv)

    shape_count = 0
    for sh in root.findall("shape"):
        t = sh.get("type")
        p = _props(sh, defaults)
        sname = sh.get("id") or f"shape_{shape_count}"
        shape_count += 1
        if t in ("ply", "obj", "serialized"):
            shape = {"type": {"serialized": "mitsuba"}.get(t, t),
                     "name": sname, "filename": p.get("filename", "")}
            if "shape_index" in p:
                shape["shape_index"] = p["shape_index"]
        elif t == "rectangle":
            shape = {"type": "rectangle", "name": sname, "width": 2,
                     "height": 2}
        elif t == "cube":
            shape = {"type": "cube", "name": sname}
        elif t == "sphere":
            shape = {"type": "sphere", "name": sname,
                     "radius": p.get("radius", 1.0),
                     "center": p.get("center", [0, 0, 0])}
        else:
            continue
        scene["shapes"].append(shape)

        ent = {"name": sname, "shape": sname}
        ref = sh.find("ref")
        inline_b = sh.find("bsdf")
        if ref is not None:
            ent["bsdf"] = ref.get("id")
        elif inline_b is not None:
            bname = f"{sname}_bsdf"
            cv = _convert_bsdf(inline_b, defaults, bname)
            inner = cv.pop("_inner", None)
            if inner:
                scene["bsdfs"].append(inner)
            scene["bsdfs"].append(cv)
            ent["bsdf"] = bname
        tr = sh.find("transform")
        if tr is not None:
            ent["transform"] = _transform(tr, defaults)
        scene["entities"].append(ent)

        em = sh.find("emitter")
        if em is not None and em.get("type") == "area":
            ep = _props(em, defaults)
            scene["lights"].append({"type": "area", "name": f"{sname}_light",
                                    "entity": sname,
                                    "radiance": ep.get("radiance",
                                                       [1, 1, 1])})

    for em in root.findall("emitter"):
        t = em.get("type")
        p = _props(em, defaults)
        lname = em.get("id") or f"light_{len(scene['lights'])}"
        if t == "point":
            scene["lights"].append({"type": "point", "name": lname,
                                    "position": p.get("position", [0, 0, 0]),
                                    "intensity": p.get("intensity",
                                                       [1, 1, 1])})
        elif t == "constant":
            scene["lights"].append({"type": "env", "name": lname,
                                    "radiance": p.get("radiance",
                                                      [1, 1, 1])})
        elif t == "envmap":
            tex = f"{lname}_tex"
            scene["textures"].append({"type": "image", "name": tex,
                                      "filename": p.get("filename", "")})
            light = {"type": "env", "name": lname, "radiance": tex}
            tr = em.find("transform")
            if tr is not None:
                light["transform"] = _transform(tr, defaults)
            scene["lights"].append(light)
        elif t in ("directional",):
            scene["lights"].append({"type": "directional", "name": lname,
                                    "direction": p.get("direction",
                                                       [0, 0, 1]),
                                    "irradiance": p.get("irradiance",
                                                        [1, 1, 1])})
        elif t in ("sun", "sunsky", "sky"):
            scene["lights"].append({"type": {"sun": "sun", "sky": "sky",
                                             "sunsky": "sunsky"}[t],
                                    "name": lname, **p})

    if out_path:
        Path(out_path).write_text(json.dumps(scene, indent=1))
    return scene
