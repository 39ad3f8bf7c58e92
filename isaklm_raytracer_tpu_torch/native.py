"""ctypes bindings of the native (C++) OBJ parser and KD-tree builder.

Port of ``obj_parse_native`` and ``kd_build_native`` of
``isaklm_raytracer_tpu/native.py``. They are the repo's
``native/obj_loader.cpp`` and ``native/kd_builder.cpp`` behind a plain C
ABI, used as they are. At first use each is compiled with g++ into ``_build/`` inside
this package (listed in .gitignore), never into ``native/``, whose
libraries belong to the JAX package. The library's file name hashes the
source, the compiler and the flags, so a stale build is never loaded. The
flags are portable (no ``-march=native``): a library in ``_build/`` may be
loaded on another host of the same checkout.

Unlike the JAX package, which prints and falls back to its Python parser,
a failed build or load raises ``NativeBuildError`` with the compiler's
message: a large scene never takes the slow path unasked. The Python
parser and the numpy KD builder run only when the caller asks for them
(``load_mesh(..., use_native=False)``, ``build_kd_tree(...,
use_native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_SOURCES = {"objload": "obj_loader.cpp", "kdbuild": "kd_builder.cpp"}
_LOCK = threading.Lock()
_LIBS: dict = {}


class NativeBuildError(RuntimeError):
    """The compiler is missing, refused the source, or its library does not load."""


def library_path(name: str) -> Path:
    """Where lib<name> lives: the name hashes the source, the compiler and the flags."""
    digest = hashlib.sha256((NATIVE_DIR / _SOURCES[name]).read_bytes())
    digest.update(" ".join((CXX, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _build(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / _SOURCES[name])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"native build of {name}: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"native build of {name} failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a reader never sees half a library


def _load(name: str) -> ctypes.CDLL:
    """Load lib<name>, building it with g++ on first use; raises
    ``NativeBuildError`` when that fails."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        path = library_path(name)
        if not path.exists():
            _build(name, path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeBuildError(f"cannot load {path}: {e}") from e
        _LIBS[name] = lib
        return lib


class _KDResult(ctypes.Structure):
    _fields_ = [
        ("child_a", ctypes.POINTER(ctypes.c_int32)),
        ("child_b", ctypes.POINTER(ctypes.c_int32)),
        ("axis", ctypes.POINTER(ctypes.c_int32)),
        ("plane", ctypes.POINTER(ctypes.c_float)),
        ("is_leaf", ctypes.POINTER(ctypes.c_uint8)),
        ("n_nodes", ctypes.c_int64),
        ("tri_indices", ctypes.POINTER(ctypes.c_int32)),
        ("n_indices", ctypes.c_int64),
        ("bbox_min", ctypes.c_float * 3),
        ("bbox_max", ctypes.c_float * 3),
    ]


def kd_build_native(vertices: np.ndarray, max_depth: int, leaf_size: int) -> dict:
    """Build the KD tree of (N, 3, 3) float32 triangle corners natively:
    a dict of numpy arrays child_a, child_b, axis (K,) int32, plane (K,)
    float32, is_leaf (K,) bool, tri_indices (I,) int32, bbox_min and
    bbox_max (3,) float32, equal to ``accel.kdtree``'s numpy builder bit for
    bit. Raises NativeBuildError when the builder cannot be built."""
    lib = _load("kdbuild")
    lib.kd_build.restype = ctypes.POINTER(_KDResult)
    lib.kd_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ]
    lib.kd_free.argtypes = [ctypes.POINTER(_KDResult)]

    vertices = np.ascontiguousarray(vertices, np.float32)
    res = lib.kd_build(vertices.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       len(vertices), max_depth, leaf_size)
    try:
        r = res.contents
        k, i = r.n_nodes, r.n_indices

        def arr(ptr, n):
            return np.ctypeslib.as_array(ptr, (n,)).copy()

        out = {
            "child_a": arr(r.child_a, k),
            "child_b": arr(r.child_b, k),
            "axis": arr(r.axis, k),
            "plane": arr(r.plane, k),
            "is_leaf": arr(r.is_leaf, k).astype(bool),
            "tri_indices": arr(r.tri_indices, i) if i else np.zeros((0,), np.int32),
            "bbox_min": np.asarray(r.bbox_min[:], np.float32),
            "bbox_max": np.asarray(r.bbox_max[:], np.float32),
        }
    finally:
        lib.kd_free(res)
    return out


class _ObjResult(ctypes.Structure):
    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("n_positions", ctypes.c_int64),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("n_normals", ctypes.c_int64),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("n_uvs", ctypes.c_int64),
        ("face_pos", ctypes.POINTER(ctypes.c_int32)),
        ("face_uv", ctypes.POINTER(ctypes.c_int32)),
        ("face_nrm", ctypes.POINTER(ctypes.c_int32)),
        ("face_mat", ctypes.POINTER(ctypes.c_int32)),
        ("n_faces", ctypes.c_int64),
        ("mat_names", ctypes.c_char_p),
        ("mat_names_len", ctypes.c_int64),
    ]


def obj_parse_native(path: str) -> dict:
    """Parse an OBJ file natively into numpy arrays: positions (P, 3),
    normals (N, 3), uvs (T, 2) (v stored as 1 - v), per-corner face_pos,
    face_uv, face_nrm (F, 3) int32 (-1 = absent), face_mat (F,) (-1 before
    any usemtl) and mat_names in order of first use. Raises
    FileNotFoundError for a missing file, NativeBuildError when the parser
    cannot be built."""
    lib = _load("objload")
    lib.obj_parse.restype = ctypes.POINTER(_ObjResult)
    lib.obj_parse.argtypes = [ctypes.c_char_p]
    lib.obj_free.argtypes = [ctypes.POINTER(_ObjResult)]

    res = lib.obj_parse(path.encode())
    if not res:
        raise FileNotFoundError(path)
    try:
        r = res.contents
        f = r.n_faces

        def arr(ptr, n, dtype):
            if n == 0:
                return np.zeros((0,), dtype)
            return np.ctypeslib.as_array(ptr, (n,)).copy()

        names = r.mat_names[: r.mat_names_len].decode() if r.mat_names_len else ""
        out = {
            "positions": arr(r.positions, r.n_positions * 3, np.float32).reshape(-1, 3),
            "normals": arr(r.normals, r.n_normals * 3, np.float32).reshape(-1, 3),
            "uvs": arr(r.uvs, r.n_uvs * 2, np.float32).reshape(-1, 2),
            "face_pos": arr(r.face_pos, f * 3, np.int32).reshape(-1, 3),
            "face_uv": arr(r.face_uv, f * 3, np.int32).reshape(-1, 3),
            "face_nrm": arr(r.face_nrm, f * 3, np.int32).reshape(-1, 3),
            "face_mat": arr(r.face_mat, f, np.int32),
            "mat_names": names.split("\n") if names else [],
        }
    finally:
        lib.obj_free(res)
    return out
