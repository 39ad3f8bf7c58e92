"""Parser for the reference's custom ``.mat`` material format.

Port of ``isaklm_raytracer_tpu/scene/mat.py``, bit-compatible with
load_material (mesh_loading.cuh:152-219): a material section starts at the
exact line ``material <name>`` and ends at the first blank line; keys are
  albedo r g b | emittance r g b | roughness f | n f | k f |
  transparent | texture path
with all-zero defaults and no texture. A missing file or name gives the
all-default material.
"""

from __future__ import annotations

import os
from typing import Callable, Optional


def _split(line: str) -> list[str]:
    """split_string(line, ' ') semantics (mesh_loading.cuh:73-103): empty
    fields dropped."""
    return [tok for tok in line.split(" ") if tok != ""]


def load_material(
    material_file_path: str,
    material_name: str,
    texture_loader: Optional[Callable[[str], int]] = None,
) -> dict:
    """Parse one named material from a .mat file into a material dict
    (a ``MaterialTable.stack`` row).

    texture_loader(path) -> tex_id registers a texture and returns its atlas
    id; None leaves tex_id = -1 even when a texture key is present. A
    missing material name (or file) yields the all-default material, like
    the reference's fallthrough.
    """
    material = {
        "albedo": (0.0, 0.0, 0.0),
        "emittance": (0.0, 0.0, 0.0),
        "roughness": 0.0,
        "ior": 0.0,
        "extinction": 0.0,
        "transparent": 0.0,
        "tex_id": -1,
    }
    if not os.path.exists(material_file_path):
        return material

    found = False
    with open(material_file_path, "r") as f:
        for raw in f:
            line = raw.rstrip("\n").rstrip("\r")
            if line == f"material {material_name}":
                found = True
            elif found:
                if line == "":
                    break
                toks = _split(line)
                if not toks:
                    continue
                key = toks[0]
                if key == "albedo":
                    material["albedo"] = (float(toks[1]), float(toks[2]), float(toks[3]))
                elif key == "emittance":
                    material["emittance"] = (float(toks[1]), float(toks[2]), float(toks[3]))
                elif key == "roughness":
                    material["roughness"] = float(toks[1])
                elif key == "n":
                    material["ior"] = float(toks[1])
                elif key == "k":
                    material["extinction"] = float(toks[1])
                elif key == "transparent":
                    material["transparent"] = 1.0
                elif key == "texture" and texture_loader is not None:
                    material["tex_id"] = texture_loader(toks[1])
    return material
