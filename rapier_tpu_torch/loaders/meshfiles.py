"""Mesh-file readers shared by the URDF and MJCF loaders (the reference's
rapier3d-meshloader formats): OBJ, binary and ASCII STL, and Collada
(.dae).  Each returns ``(vertices [V, 3] float32, triangles [T, 3] int32)``,
or None for a missing file or an unknown format, as the reference's
`rapier_tpu.loaders.urdf._load_mesh_file` does."""

from __future__ import annotations

import os
import struct
import xml.etree.ElementTree as ET

import numpy as np


def load_mesh_file(path: str):
    """An OBJ, STL (binary or ASCII) or Collada file's triangles."""
    if not os.path.exists(path):
        return None
    lower = path.lower()
    if lower.endswith(".obj"):
        verts, faces = [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "v":
                    verts.append([float(x) for x in parts[1:4]])
                elif parts[0] == "f":
                    idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                    for k in range(1, len(idx) - 1):     # fan-triangulate
                        faces.append([idx[0], idx[k], idx[k + 1]])
        return np.asarray(verts, np.float32), np.asarray(faces, np.int32)
    if lower.endswith(".stl"):
        return _load_stl(path)
    if lower.endswith(".dae"):
        return load_collada(path)
    return None


def _load_stl(path: str):
    """Binary STL (80-byte header, uint32 count, 50-byte records) when the
    record arithmetic matches the file's size, else ASCII; duplicate
    vertices (rounded to 1e-6) merged so the triangles share them."""
    with open(path, "rb") as f:
        raw = f.read()
    n_tri = struct.unpack_from("<I", raw, 80)[0] if len(raw) >= 84 else -1
    if n_tri >= 0 and 84 + 50 * n_tri == len(raw):
        rec = np.frombuffer(raw[84:84 + 50 * n_tri], dtype=np.uint8).reshape(n_tri, 50)
        v = rec[:, 12:48].copy().view("<f4").reshape(-1, 3).astype(np.float32)
    else:
        verts = []
        for line in raw.decode("ascii", errors="replace").splitlines():
            parts = line.split()
            if parts and parts[0] == "vertex":
                verts.append([float(x) for x in parts[1:4]])
        v = np.asarray(verts, np.float32)
    if not len(v):
        return v, np.zeros((0, 3), np.int32)
    vq = np.round(v.astype(np.float64) * 1e6) / 1e6
    uniq, inv = np.unique(vq, axis=0, return_inverse=True)
    return uniq.astype(np.float32), inv.reshape(-1, 3).astype(np.int32)


def load_collada(path: str):
    """Every ``<library_geometries>`` mesh's ``<triangles>`` and
    ``<polylist>`` primitives (polygons fan-triangulated), concatenated, in
    metres (``<unit meter>``); materials, scenes and controllers are not
    read.  None without geometry."""
    root = ET.parse(path).getroot()

    def local(tag):          # Collada is namespaced: match local names
        return tag.rsplit("}", 1)[-1]

    def children(elem, *names):
        return [e for e in elem if local(e.tag) in names]

    scale = 1.0
    for a in (e for e in root.iter() if local(e.tag) == "unit"):
        scale = float(a.get("meter", 1.0))

    all_v, all_t = [], []
    n_verts = 0
    for geom in (e for e in root.iter() if local(e.tag) == "geometry"):
        for mesh in children(geom, "mesh"):
            sources = {}
            for s in children(mesh, "source"):
                arr = next(iter(children(s, "float_array")), None)
                if arr is not None and arr.text:
                    sources["#" + s.get("id", "")] = np.asarray(arr.text.split(), np.float64)
            pos_by_vertid = {}
            for vtx in children(mesh, "vertices"):
                for inp in children(vtx, "input"):
                    if inp.get("semantic") == "POSITION":
                        pos_by_vertid["#" + vtx.get("id", "")] = inp.get("source", "")
            src_base: dict = {}      # position source -> its first row in all_v

            def src_offset(v_src):
                nonlocal n_verts
                if v_src not in src_base:
                    pos = sources.get(v_src)
                    if pos is None:
                        return None
                    src_base[v_src] = n_verts
                    all_v.append((pos.reshape(-1, 3) * scale).astype(np.float32))
                    n_verts += len(all_v[-1])
                return src_base[v_src]

            for prim in children(mesh, "triangles", "polylist"):
                v_off, v_src, stride = 0, None, 1
                for inp in children(prim, "input"):
                    off = int(inp.get("offset", 0))
                    stride = max(stride, off + 1)
                    if inp.get("semantic") == "VERTEX":
                        v_off = off
                        v_src = pos_by_vertid.get(inp.get("source", ""))
                p_el = next(iter(children(prim, "p")), None)
                if p_el is None or not p_el.text or v_src is None:
                    continue
                offset = src_offset(v_src)
                if offset is None:
                    continue
                vidx = np.asarray(p_el.text.split(), np.int64)[v_off::stride]
                if local(prim.tag) == "polylist":
                    vc_el = next(iter(children(prim, "vcount")), None)
                    counts = (np.asarray(vc_el.text.split(), np.int64)
                              if vc_el is not None and vc_el.text
                              else np.full(len(vidx) // 3, 3, np.int64))
                    tris, c = [], 0
                    for cnt in counts:
                        for k in range(1, cnt - 1):
                            tris.append([vidx[c], vidx[c + k], vidx[c + k + 1]])
                        c += cnt
                    t = np.asarray(tris, np.int64).reshape(-1, 3)
                else:
                    t = vidx.reshape(-1, 3)
                all_t.append((t + offset).astype(np.int32))
    if not all_v:
        return None
    return np.concatenate(all_v), np.concatenate(all_t)
