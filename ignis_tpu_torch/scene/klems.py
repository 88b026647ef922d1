"""Klems BSDF XML loader (Radiance/WINDOW format).

Parses the WindowElement/Optical/Layer XML (reference:
src/runtime/measured/KlemsLoader.cpp): per-component angle bases (theta
rings with per-ring phi counts) and the scattering matrices
[outgoing x incoming]. The component naming follows the reference's
front/back flip of the window convention (KlemsLoader.cpp:209-217):
"Transmission Front" data feeds the *back* transmission and vice versa.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import NamedTuple, Optional

import numpy as np


def _parse_xml(path):
    """Parse the XML with any namespace stripped (LBNL files declare
    xmlns="http://windows.lbl.gov")."""
    it = ET.iterparse(str(path))
    for _, el in it:
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    return it.root


class KlemsBasisNp(NamedTuple):
    lower: np.ndarray       # [T] radians, sorted ascending by upper
    upper: np.ndarray       # [T]
    phi_count: np.ndarray   # [T] int
    lin_off: np.ndarray     # [T] int
    entry_count: int
    permutation: np.ndarray  # file order -> sorted linear index


class KlemsComponentNp(NamedTuple):
    row: KlemsBasisNp       # outgoing
    col: KlemsBasisNp       # incoming
    matrix: np.ndarray      # [row.entry_count, col.entry_count]
    total: float


class KlemsNp(NamedTuple):
    front_reflection: KlemsComponentNp
    back_reflection: KlemsComponentNp
    front_transmission: KlemsComponentNp
    back_transmission: KlemsComponentNp


def _build_basis(blocks) -> KlemsBasisNp:
    rows = []
    for child in blocks:
        lower = np.deg2rad(float(child.findtext("ThetaBounds/LowerTheta", "0")))
        upper = np.deg2rad(float(child.findtext("ThetaBounds/UpperTheta", "0")))
        nphi = int(child.findtext("nPhis", "0"))
        if nphi <= 0 or lower >= upper:
            raise ValueError("invalid AngleBasisBlock")
        rows.append((lower, upper, nphi))
    order = np.argsort([r[1] for r in rows], kind="stable")
    lower = np.array([rows[i][0] for i in order], np.float32)
    upper = np.array([rows[i][1] for i in order], np.float32)
    phi_count = np.array([rows[i][2] for i in order], np.int32)
    lin_off = np.concatenate([[0], np.cumsum(phi_count)[:-1]]).astype(np.int32)
    entry_count = int(phi_count.sum())
    # permutation: file entry k (file theta-ring order) -> sorted linear index
    perm = np.empty(entry_count, np.int64)
    k = 0
    for fi in range(len(rows)):
        si = int(np.nonzero(order == fi)[0][0])
        for j in range(rows[fi][2]):
            perm[k] = lin_off[si] + j
            k += 1
    return KlemsBasisNp(lower, upper, phi_count, lin_off, entry_count, perm)


def _black_component(basis: KlemsBasisNp) -> KlemsComponentNp:
    n = basis.entry_count
    return KlemsComponentNp(basis, basis, np.zeros((n, n), np.float32), 0.0)


def load_klems(path) -> Optional[KlemsNp]:
    doc = _parse_xml(path)
    layer = doc.find("Optical/Layer")
    if layer is None:
        raise ValueError(f"{path}: no Optical/Layer")
    datadef = layer.find("DataDefinition")
    if datadef is None:
        raise ValueError(f"{path}: no DataDefinition")
    struct = (datadef.findtext("IncidentDataStructure") or "").strip()
    row_based = struct == "Rows"
    if not row_based and struct != "Columns":
        raise ValueError(f"{path}: IncidentDataStructure '{struct}'")

    allbasis = {}
    for ab in datadef.findall("AngleBasis"):
        name = (ab.findtext("AngleBasisName") or "").strip()
        allbasis[name] = _build_basis(ab.findall("AngleBasisBlock"))
    if not allbasis:
        raise ValueError(f"{path}: no AngleBasis")

    comps = {}
    for data in layer.findall("WavelengthData"):
        if (data.findtext("Wavelength") or "").strip() != "Visible":
            continue
        block = data.find("WavelengthDataBlock")
        if block is None:
            continue
        colb = allbasis[(block.findtext("ColumnAngleBasis") or "").strip()]
        rowb = allbasis[(block.findtext("RowAngleBasis") or "").strip()]
        raw = np.array((block.findtext("ScatteringData") or "")
                       .replace(",", " ").split(), np.float32)
        need = rowb.entry_count * colb.entry_count
        if raw.size != need:
            raise ValueError(f"{path}: scattering data length {raw.size} != "
                             f"{need}")
        raw = np.abs(np.nan_to_num(raw, nan=0.0, posinf=0.0, neginf=0.0))
        mat = np.zeros((rowb.entry_count, colb.entry_count), np.float32)
        idx = np.arange(need)
        if row_based:
            frow = idx % colb.entry_count
            fcol = idx // colb.entry_count
        else:
            frow = idx // colb.entry_count
            fcol = idx % colb.entry_count
        mat[rowb.permutation[frow], colb.permutation[fcol]] = raw
        # total = sum of matrix * per-entry solid angle of the column basis
        comp = KlemsComponentNp(rowb, colb, mat, float(mat.sum()))
        direction = (block.findtext("WavelengthDataDirection") or "").strip()
        if direction == "Transmission Front":
            comps["back_transmission"] = comp
        elif direction in ("Scattering Back", "Reflection Back"):
            comps["front_reflection"] = comp
        elif direction == "Transmission Back":
            comps["front_transmission"] = comp
        else:
            comps["back_reflection"] = comp

    basis0 = next(iter(allbasis.values()))
    fr = comps.get("front_reflection") or _black_component(basis0)
    br = comps.get("back_reflection") or _black_component(basis0)
    ft = comps.get("front_transmission")
    bt = comps.get("back_transmission")
    if bt is None or (ft is not None and bt.total <= 1e-7):
        bt = ft
    if ft is None or (bt is not None and ft.total <= 1e-7):
        ft = bt
    if ft is None and bt is None:
        raise ValueError(f"{path}: no transmission data")
    return KlemsNp(fr, br, ft, bt)
