"""Port parity: the host asset pipeline (PNG decode, texture registry, .mat,
native and Python OBJ parsers, scene assembly, export, the CLI manifest).

Every case writes its files under ``tmp_path`` (from numpy with a seed, or
the JAX tests' own fixtures) and puts the same files through the JAX
function and its port. Tolerances: parsers, atlases, export text and the
assembled scenes are EXACT (the same numpy arithmetic on the same
parsed values); the one exception is a manifest with a rotation, whose
matrix comes from each package's ``rotation_matrix`` (torch and XLA sin
and cos may differ in the last bit, ``tests/test_torch_math.py``'s 1e-6),
and the native parser's ``vt`` against the Python parser's, which flips
v in float32 (``1.0f - v``) where Python flips it in float64: one
float32 ulp at 1 (1.2e-7). The round trips through text are those of
``tests/test_parsers.py::TestObjExport`` (2e-6 after the loader's
re-centering; uvs and materials exact).

The JAX package is imported inside the tests (``_jax``), so that the card
test at the end, which ``chip_smoke.py`` runs on a machine without JAX,
can load this file.
"""

import importlib
import json
import os
import re
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu_torch import interop, native
from isaklm_raytracer_tpu_torch.accel import prepare_scene
from isaklm_raytracer_tpu_torch.cli import render as cli
from isaklm_raytracer_tpu_torch.io.png import _decode_png, load_image, save_png
from isaklm_raytracer_tpu_torch.math import transforms
from isaklm_raytracer_tpu_torch.scene import procedural
from isaklm_raytracer_tpu_torch.scene.export import (
    load_offset,
    material_rows,
    save_mat,
    save_obj,
)
from isaklm_raytracer_tpu_torch.scene.mat import load_material
from isaklm_raytracer_tpu_torch.scene.obj import (
    Transformation,
    create_scene_from_files,
    load_mesh,
)
from isaklm_raytracer_tpu_torch.scene.texture import TextureRegistry

torch.set_num_threads(1)  # the test workers share the host's cores


def _reference_root() -> str:
    """tests/test_textures.py's REF_ROOT: the reference checkout that the
    JAX package's reference-file cases read, read here from that file so
    that both skip alike."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_textures.py")
    with open(path) as f:
        return re.search(r'^REF_ROOT = "([^"]+)"', f.read(), re.M).group(1)


REF_ROOT = _reference_root()
needs_reference = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF_ROOT, "materials")),
    reason="reference checkout not mounted",
)
ROT_ATOL = 1e-6  # rotation_matrix, torch against XLA (tests/test_torch_math.py)
VT_ATOL = 1.2e-7  # one float32 ulp at 1: native 1.0f - v against Python's float64 flip


def _jax(module: str):
    """A module of the JAX package, imported on first use."""
    return importlib.import_module(f"isaklm_raytracer_tpu.{module}")


def _needs_gxx():
    if shutil.which(native.CXX) is None:
        pytest.skip(f"{native.CXX} not found: the native parser cannot be built")


def _assert_tree_equal(got, want, path="", atol=0.0):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}", atol)
    elif isinstance(want, (list, tuple, str)) or want is None:
        assert got == want, path
    elif atol:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol,
                                   err_msg=path)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def _mesh_equal(got, want, atol=0.0):
    _assert_tree_equal(
        {"v": got.vertices, "n": got.normals, "uv": got.uvs, "m": got.material_names},
        {"v": want.vertices, "n": want.normals, "uv": want.uvs, "m": want.material_names},
        atol=atol,
    )


# ---------------------------------------------------------------------------
# io/png: load_image, _decode_png
# ---------------------------------------------------------------------------


def _filter_row(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> bytes:
    """The PNG encoder's filter ``kind`` over one row (the inverse of what the
    decoders undo), so every filter type can be fed to them."""
    x = line.astype(np.int64)
    p = prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = p
    elif kind == 3:
        pred = (a + p) >> 1
    else:
        pa, pb, pc = np.abs(p - c), np.abs(a - c), np.abs(a + p - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes()


def _write_png(path, img: np.ndarray, color_type: int, filters) -> None:
    h, w = img.shape[:2]
    flat = img.reshape(h, -1)
    bpp = flat.shape[1] // w
    prev = np.zeros(flat.shape[1], np.uint8)
    raw = b""
    for row in range(h):
        raw += _filter_row(filters[row % len(filters)], flat[row], prev, bpp)
        prev = flat[row]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((7, 9, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    save_png(path, img, flip_vertical=False)
    back = load_image(path)
    np.testing.assert_allclose(back[..., :3].astype(np.float32) / 255.0, img,
                               atol=1 / 255.0 + 1e-6)
    np.testing.assert_array_equal(back, _jax("io.png").load_image(path))


@pytest.mark.parametrize("color_type,channels", [(0, 1), (2, 3), (4, 2), (6, 4)],
                         ids=["gray", "rgb", "gray_alpha", "rgba"])
def test_png_decoder_every_filter_matches_jax_and_pil(tmp_path, color_type, channels):
    """Rows under each filter type 0-4 in turn: the port's decoder equals the
    JAX package's byte for byte, and both equal PIL's decode."""
    rng = np.random.default_rng(color_type)
    img = rng.integers(0, 256, (11, 13, channels), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    _write_png(path, img, color_type, filters=(0, 1, 2, 3, 4, 4, 3, 2, 1))
    ours = _decode_png(path)
    np.testing.assert_array_equal(ours, _jax("io.png")._decode_png(path))
    assert ours.shape == (11, 13, 4) and ours.dtype == np.uint8
    pytest.importorskip("PIL")
    np.testing.assert_array_equal(ours, load_image(path))


def test_png_own_decoder_matches_pil(tmp_path):
    rng = np.random.default_rng(1)
    img = (rng.random((5, 6, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "y.png")
    save_png(path, img, flip_vertical=False)
    ours = _decode_png(path)
    np.testing.assert_array_equal(ours, _jax("io.png")._decode_png(path))
    pytest.importorskip("PIL")
    np.testing.assert_array_equal(ours, load_image(path))


def test_png_decoder_reads_pil_files(tmp_path):
    """A PNG written by PIL (its own filter choice) decodes to PIL's pixels."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(2)
    img = np.cumsum(rng.integers(0, 4, (32, 40, 4)), axis=1).astype(np.uint8)
    path = str(tmp_path / "pil.png")
    Image.fromarray(img, "RGBA").save(path)
    np.testing.assert_array_equal(_decode_png(path), img)
    np.testing.assert_array_equal(_decode_png(path), _jax("io.png")._decode_png(path))


def test_png_vertical_flip(tmp_path):
    img = np.zeros((2, 2, 3), np.uint8)
    img[0] = 255  # bottom row (y=0) white
    path = str(tmp_path / "z.png")
    save_png(path, img)  # default flip: y=0 row becomes last PNG row
    back = load_image(path)
    assert back[1, 0, 0] == 255 and back[0, 0, 0] == 0
    np.testing.assert_array_equal(back, _decode_png(path))


def test_png_rejects_what_it_cannot_decode(tmp_path):
    path = tmp_path / "bad.png"
    path.write_bytes(b"GIF89a....")
    with pytest.raises(ValueError, match="not a PNG"):
        _decode_png(str(path))


# ---------------------------------------------------------------------------
# scene/texture: TextureRegistry.load
# ---------------------------------------------------------------------------


def test_texture_registry_load_dedups_by_path(tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for i, (h, w) in enumerate([(4, 6), (3, 5)]):
        p = str(tmp_path / f"t{i}.png")
        save_png(p, rng.integers(0, 256, (h, w, 3), dtype=np.uint8), flip_vertical=False)
        paths.append(p)
    checker = procedural.checker_texture(tiles=2, size=8)

    def fill(reg):
        ids = [reg.load(paths[0]), reg.add_array(checker, key="checker"), reg.load(paths[1]),
               reg.load(paths[0]), reg.load("checker")]
        return ids, reg.build()

    ids, atlas = fill(TextureRegistry())
    jids, jatlas = fill(_jax("scene.texture").TextureRegistry())
    assert ids == jids == [0, 1, 2, 0, 1]
    _assert_tree_equal(interop._leaves(atlas, interop._TEXTURES),
                       interop._leaves(jatlas, interop._TEXTURES))
    assert atlas.buffer.shape == (24 + 64 + 15, 3)


@needs_reference
@pytest.mark.parametrize(
    "name,size",
    [("chair_wood.jpg", 900), ("desk.jpg", None), ("wall.png", None),
     ("emissive_gradient.png", None), ("chair_textile.png", None),
     ("simple_chair.png", None), ("table.png", None)],
)
def test_decode_reference_textures(name, size):
    """Every texture the reference scene ships decodes as in the JAX package
    (stb_image parity, scene.cuh:25-63)."""
    path = os.path.join(REF_ROOT, "textures", name)
    if not os.path.exists(path):
        pytest.skip(f"{name} stripped from checkout")
    img = load_image(path)
    assert img.ndim == 3 and img.shape[2] == 4 and img.dtype == np.uint8
    if size is not None:
        assert img.shape[0] == size
    np.testing.assert_array_equal(img, _jax("io.png").load_image(path))


@needs_reference
def test_reference_textures_register():
    reg = TextureRegistry()
    i = reg.load(os.path.join(REF_ROOT, "textures", "chair_wood.jpg"))
    j = reg.load(os.path.join(REF_ROOT, "textures", "chair_wood.jpg"))
    assert i == j
    assert reg.build().buffer.shape[0] == 900 * 900


# ---------------------------------------------------------------------------
# scene/mat: load_material
# ---------------------------------------------------------------------------

MAT_FILE = """material red
albedo 1.0 0.2 0.1
roughness 0.5
n 1.45

material lamp
albedo 0.7 0.7 0.7
emittance 10 9 6.5
roughness 0.2
n 1.2

material gold
albedo 0.97 0.74 0.33
n 0.27732
k 2.9278

material glass
albedo 0.995 0.995 0.995
n 1.51
transparent
"""


@pytest.fixture()
def mat_path(tmp_path):
    p = tmp_path / "test.mat"
    p.write_text(MAT_FILE)
    return str(p)


def _both_materials(path, name, loader=None):
    got = load_material(path, name, loader)
    assert got == _jax("scene.mat").load_material(path, name, loader)
    return got


def test_mat_basic(mat_path):
    m = _both_materials(mat_path, "red")
    assert m["albedo"] == (1.0, 0.2, 0.1)
    assert m["roughness"] == 0.5 and m["ior"] == 1.45
    assert m["extinction"] == 0.0 and m["transparent"] == 0.0


def test_mat_emissive_metal_glass(mat_path):
    assert _both_materials(mat_path, "lamp")["emittance"] == (10.0, 9.0, 6.5)
    assert _both_materials(mat_path, "gold")["extinction"] == 2.9278
    glass = _both_materials(mat_path, "glass")
    assert glass["transparent"] == 1.0 and glass["ior"] == 1.51


def test_mat_missing_name_or_file_defaults(mat_path, tmp_path):
    for path, name in ((mat_path, "nonexistent"), (str(tmp_path / "none.mat"), "red")):
        m = _both_materials(path, name)
        assert m["albedo"] == (0.0, 0.0, 0.0) and m["ior"] == 0.0 and m["tex_id"] == -1


def test_mat_section_ends_at_blank_line(tmp_path):
    # keys after the blank line must NOT leak into the material
    p = tmp_path / "m.mat"
    p.write_text("material a\nalbedo 0.5 0.5 0.5\n\nroughness 0.9\n")
    assert _both_materials(str(p), "a")["roughness"] == 0.0


def test_mat_exact_header_line_and_texture_loader(tmp_path):
    """A section starts only at the exact line ``material <name>`` (no
    trailing space, no other name that shares the prefix); a texture key
    reaches the loader, which a None loader ignores."""
    p = tmp_path / "m.mat"
    p.write_text("material ab\nalbedo 1 1 1\n\nmaterial a \nalbedo 2 2 2\n\n"
                 "material a\r\nalbedo   0.25  0.5 0.75\ntexture /tex/a.png\n\n")
    seen = []

    def loader(path):
        seen.append(path)
        return 7

    m = _both_materials(str(p), "a", loader)
    assert m["albedo"] == (0.25, 0.5, 0.75) and m["tex_id"] == 7
    assert seen == ["/tex/a.png", "/tex/a.png"]  # once a package
    assert _both_materials(str(p), "a")["tex_id"] == -1


def test_mat_random_files_match(tmp_path):
    """Seeded random materials written by each package's save_mat parse
    back identically in both packages, every field exact."""
    rng = np.random.default_rng(11)
    names = [f"m{i}" for i in range(12)]
    mats = [{
        "albedo": tuple(rng.random(3).astype(np.float32)),
        "emittance": tuple((rng.random(3) * 20 * (i % 3 == 0)).astype(np.float32)),
        "roughness": float(np.float32(rng.random())),
        "ior": float(np.float32(1 + rng.random())),
        "extinction": float(np.float32(rng.random() * 3)),
        "transparent": float(i % 4 == 1),
    } for i in range(12)]
    port, jax_ = str(tmp_path / "p.mat"), str(tmp_path / "j.mat")
    save_mat(port, names, mats)
    _jax("scene.export").save_mat(jax_, names, mats)
    assert open(port).read() == open(jax_).read()
    for name, m in zip(names, mats):
        got = _both_materials(port, name)
        for k in ("roughness", "ior", "extinction", "transparent"):
            assert np.float32(got[k]) == np.float32(m[k]), (name, k)
        assert np.array_equal(np.float32(got["albedo"]), np.float32(m["albedo"]))


@needs_reference
def test_missing_material_yields_defaults():
    got = _both_materials(os.path.join(REF_ROOT, "materials", "glass.mat"), "no_such_material")
    assert got["albedo"] == (0.0, 0.0, 0.0)
    assert got["ior"] == 0.0 and got["tex_id"] == -1


@needs_reference
@pytest.mark.parametrize("fname", ["chair.mat", "cheburashka.mat", "desk.mat", "dragon.mat",
                                   "glass.mat", "happy_buddha.mat", "horse.mat", "house.mat",
                                   "outlet.mat", "room.mat", "simple_chair.mat", "table.mat"])
def test_reference_mat_files(fname):
    """Every material of every .mat file the reference ships parses as in
    the JAX package, texture keys included."""
    path = os.path.join(REF_ROOT, "materials", fname)
    with open(path, encoding="utf-8", errors="replace") as f:
        names = [ln.rstrip("\r\n")[len("material "):] for ln in f
                 if ln.startswith("material ")]
    assert names
    for name in names:
        _both_materials(path, name, loader=lambda p: len(p))


# ---------------------------------------------------------------------------
# native: obj_parse_native, its build
# ---------------------------------------------------------------------------

OBJ_BODY = """v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vt 0.25 0.75
vn 0 0 1
vn 0 0 0
usemtl a
f 1/1/1 2//1 3//1 4//1
usemtl b
f -5 -4 -1
f 1//2 2 3
f 1 2 5
"""


def _random_obj(path, seed: int) -> None:
    """A seeded OBJ with what both parsers must agree on: %.9g floats,
    fan polygons of 3-6 corners, positive and negative indices, missing
    uv/normal slots, an all-zero normal, usemtl switches and faces before
    the first usemtl."""
    rng = np.random.default_rng(seed)
    lines = []
    n_v, n_t, n_n = 40, 25, 20
    for p in rng.uniform(-3, 3, (n_v, 3)).astype(np.float32):
        lines.append("v " + " ".join("%.9g" % x for x in p))
    for t in rng.random((n_t, 2)).astype(np.float32):
        lines.append("vt " + " ".join("%.9g" % x for x in t))
    normals = rng.normal(size=(n_n, 3)).astype(np.float32)
    normals[3] = 0.0  # a false normal
    for n in normals:
        lines.append("vn " + " ".join("%.9g" % x for x in n))
    for i in range(60):
        if i % 17 == 5:
            lines.append(f"usemtl mat{i % 3}")
        corners = []
        for _ in range(int(rng.integers(3, 7))):
            v = int(rng.integers(1, n_v + 1))
            spec = str(v if rng.random() < 0.7 else v - n_v - 1)
            form = int(rng.integers(0, 4))
            t, n = int(rng.integers(1, n_t + 1)), int(rng.integers(1, n_n + 1))
            spec += ["", f"/{t}", f"//{n}", f"/{t}/{n}"][form]
            corners.append(spec)
        lines.append("f " + "  ".join(corners))
    path.write_text("\n".join(lines) + "\n")


def test_obj_native_raw_parse(tmp_path):
    _needs_gxx()
    obj = tmp_path / "m.obj"
    obj.write_text(OBJ_BODY)
    parsed = native.obj_parse_native(str(obj))
    assert parsed["positions"].shape == (5, 3)
    assert parsed["normals"].shape == (2, 3)
    # quad fan = 2 tris, negative-index tri, 1 skipped (false normal), 1 more
    assert parsed["face_pos"].shape[0] == 4
    assert parsed["mat_names"] == ["a", "b"]
    np.testing.assert_allclose(parsed["uvs"][0], [0.25, 0.25], atol=1e-6)  # v-flip
    _assert_tree_equal(parsed, _jax("native").obj_parse_native(str(obj)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_obj_native_matches_python_and_jax(tmp_path, seed):
    """The native parser (port and JAX builds of one source) and the Python
    parsers of both packages give the same mesh: exact, but for the vt
    flip (VT_ATOL) between the native and Python parsers."""
    _needs_gxx()
    obj = tmp_path / "m.obj"
    if seed == 0:
        obj.write_text(OBJ_BODY)
    else:
        _random_obj(obj, seed)
    mat = tmp_path / "m.mat"
    mat.write_text("material a\nalbedo 1 0 0\n\nmaterial b\nalbedo 0 1 0\n\n"
                   "material mat1\nemittance 1 1 1\n")
    jload = _jax("scene.obj").load_mesh
    py = load_mesh(str(obj), str(mat), use_native=False)
    nat = load_mesh(str(obj), str(mat), use_native=True)
    _mesh_equal(py, jload(str(obj), str(mat), use_native=False))
    _mesh_equal(nat, jload(str(obj), str(mat), use_native=True))
    assert py.material_names == nat.material_names
    np.testing.assert_array_equal(py.vertices, nat.vertices)
    np.testing.assert_array_equal(py.normals, nat.normals)
    np.testing.assert_allclose(py.uvs, nat.uvs, rtol=0, atol=VT_ATOL)
    if seed:
        assert len(py.material_names) > 60 and "" in py.material_names


def test_obj_missing_file_raises(tmp_path):
    _needs_gxx()
    with pytest.raises(FileNotFoundError):
        load_mesh(str(tmp_path / "none.obj"), "")


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A missing compiler, or one that refuses the source, raises
    NativeBuildError naming the compiler's message; nothing falls back to
    the Python parser."""
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    obj = tmp_path / "m.obj"
    obj.write_text(OBJ_BODY)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.NativeBuildError, match="no-such-compiler"):
        load_mesh(str(obj), "")
    broken = tmp_path / "src"
    broken.mkdir()
    (broken / "obj_loader.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_DIR", broken)
    monkeypatch.setattr(native, "CXX", "g++")
    _needs_gxx()
    with pytest.raises(native.NativeBuildError, match="failed.*\n.*error"):
        native.obj_parse_native(str(obj))
    assert not list((tmp_path / "_build").glob("*"))  # no library, no temporary


def test_native_library_path_hashes_source_and_flags(monkeypatch):
    path = native.library_path("objload")
    assert path.parent == native.BUILD_DIR and path.name.startswith("libobjload_")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-DX",))
    assert native.library_path("objload") != path


# ---------------------------------------------------------------------------
# scene/obj: load_mesh quirks (tests/test_parsers.py), both parsers
# ---------------------------------------------------------------------------


def _obj(tmp_path, body):
    p = tmp_path / "mesh.obj"
    p.write_text(body)
    return str(p)


@pytest.fixture(params=[True, False], ids=["native", "python"])
def use_native(request):
    if request.param:
        _needs_gxx()
    return request.param


def _both_meshes(obj, mat, use_native, *args, **kwargs):
    got = load_mesh(obj, mat, *args, use_native=use_native, **kwargs)
    _mesh_equal(got, _jax("scene.obj").load_mesh(obj, mat, *args, use_native=use_native,
                                                 **kwargs))
    return got


def test_obj_quad_fan_triangulation(tmp_path, mat_path, use_native):
    obj = _obj(tmp_path, "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nusemtl red\nf 1 2 3 4\n")
    mesh = _both_meshes(obj, mat_path, use_native)
    assert mesh.vertices.shape == (2, 3, 3)
    assert mesh.material_names == ["red", "red"]
    c = np.array([0.5, 0.5, 0.0])
    np.testing.assert_allclose(mesh.vertices[0, 0], [0, 0, 0] - c, atol=1e-6)
    np.testing.assert_allclose(mesh.vertices[1, 2], [0, 1, 0] - c, atol=1e-6)


def test_obj_negative_indices(tmp_path, mat_path, use_native):
    obj = _obj(tmp_path, "v 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl red\nf -3 -2 -1\n")
    mesh = _both_meshes(obj, mat_path, use_native)
    assert mesh.vertices.shape == (1, 3, 3)
    np.testing.assert_allclose(mesh.vertices[0, 1], [0.5, -0.5, 0.0], atol=1e-6)


def test_obj_vt_v_flip_and_default_uv(tmp_path, mat_path, use_native):
    obj = _obj(tmp_path, "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.25 0.75\nusemtl red\nf 1/1 2 3\n")
    mesh = _both_meshes(obj, mat_path, use_native)
    np.testing.assert_allclose(mesh.uvs[0, 0], [0.25, 0.25], atol=1e-6)  # 1 - 0.75
    # corners without vt get the reference's literal ZERO_VEC2D = (1, 1)
    np.testing.assert_array_equal(mesh.uvs[0, 1], [1.0, 1.0])


def test_obj_false_normal_skips_face(tmp_path, mat_path, use_native):
    obj = _obj(tmp_path, "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 0\nvn 0 0 1\n"
                         "usemtl red\nf 1//1 2//2 3//2\nf 1//2 2//2 3//2\n")
    mesh = _both_meshes(obj, mat_path, use_native)
    assert mesh.vertices.shape == (1, 3, 3)
    np.testing.assert_array_equal(mesh.normals[0, 0], [0, 0, 1])


def test_obj_smooth_normals(tmp_path, mat_path, use_native):
    obj = _obj(tmp_path, "v 0 0 0\nv 1 0 0\nv 1 0 1\nv 0 1 0\nusemtl red\nf 1 2 4\nf 2 3 4\n")
    mesh = _both_meshes(obj, mat_path, use_native, smooth_normals=True)
    n1 = np.cross([0, 0, 1], [-1, 1, 0]).astype(np.float64)
    expected = np.array([0.0, 0.0, 1.0]) + n1 / np.linalg.norm(n1)
    np.testing.assert_allclose(mesh.normals[0, 1], expected / np.linalg.norm(expected),
                               atol=1e-5)


def test_obj_flat_normals_without_smooth(tmp_path, mat_path, use_native):
    obj = _obj(tmp_path, "v 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl red\nf 1 2 3\n")
    mesh = _both_meshes(obj, mat_path, use_native, smooth_normals=False)
    np.testing.assert_allclose(mesh.normals[0], [[0, 0, 1]] * 3, atol=1e-6)


def test_obj_transform_center_then_rotate_offset(tmp_path, mat_path, use_native):
    obj = _obj(tmp_path, "v 0 0 0\nv 2 0 0\nv 0 2 0\nusemtl red\nf 1 2 3\n")
    rot = transforms.rotation_matrix(0.3, device="cpu").numpy()
    tr = Transformation(np.array([5.0, 0.0, 0.0], np.float32), rot * 2.0)
    mesh = _both_meshes(obj, mat_path, use_native, tr)
    expected = (np.array([0.0, 0.0, 0.0]) - [1.0, 1.0, 0.0]) @ (rot * 2.0).T + [5, 0, 0]
    np.testing.assert_allclose(mesh.vertices[0, 0], expected, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(mesh.normals[0, 0]), 1.0, atol=1e-5)


def test_obj_faces_before_usemtl_get_the_default_material(tmp_path, mat_path, use_native):
    obj = _obj(tmp_path, "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\nusemtl red\nf 3 2 1\n")
    assert _both_meshes(obj, mat_path, use_native).material_names == ["", "red"]


# ---------------------------------------------------------------------------
# scene/obj: create_scene_from_files
# ---------------------------------------------------------------------------


def _two_meshes(tmp_path, mat_path):
    obj1 = _obj(tmp_path, "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nusemtl red\nf 1 2 3 4\n")
    p2 = tmp_path / "lamp.obj"
    p2.write_text("v 0 0 2\nv 1 0 2\nv 0 1 2\nusemtl lamp\nf 1 2 3\n")
    return [(obj1, mat_path, Transformation.identity(), False),
            (str(p2), mat_path, Transformation.identity(), False)]


def test_create_scene_from_files_matches_jax(tmp_path, mat_path):
    """Unprepared: every leaf exact against the JAX package's scene; prepared
    on the CPU: every leaf, cluster tables included, exact against JAX's
    prepare_scene of its own loaded scene."""
    _needs_gxx()
    meshes = _two_meshes(tmp_path, mat_path)
    jcreate = _jax("scene.obj").create_scene_from_files
    raw = create_scene_from_files(meshes, prepare=False)
    assert isinstance(raw.vertices, np.ndarray) and raw.cbvh is None
    _assert_tree_equal(interop.scene_to_numpy(raw),
                       interop.scene_to_numpy(jcreate(meshes, build_kd=False)))
    scene = create_scene_from_files(meshes, device="cpu", kd_depth=4, kd_leaf=2)
    want = interop.scene_to_numpy(jcreate(meshes, kd_depth=4, kd_leaf=2))
    _assert_tree_equal(interop.scene_to_numpy(scene), want)
    assert scene.num_triangles == 3 and scene.has_lights
    em = scene.materials.emittance[scene.mat_id]
    lamp = int(torch.nonzero((em > 0).any(-1))[0][0])
    np.testing.assert_array_equal(scene.light_indices.numpy(), [lamp])
    # material 0 is the default "" material; the others in usemtl order
    np.testing.assert_array_equal(scene.materials.albedo.numpy(),
                                  np.float32([[0, 0, 0], [1.0, 0.2, 0.1], [0.7, 0.7, 0.7]]))


def test_create_scene_without_card_raises_unless_cpu(tmp_path, mat_path, monkeypatch):
    _needs_gxx()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        create_scene_from_files(_two_meshes(tmp_path, mat_path))


def test_mat_texture_flows_through_create_scene_from_files(tmp_path):
    _needs_gxx()
    tex_png = tmp_path / "checker.png"
    save_png(str(tex_png), procedural.checker_texture(tiles=2, size=8), flip_vertical=False)
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nvn 0 0 -1\n"
                   "usemtl painted\nf 1/1/1 2/2/1 3/3/1\n")
    mat = tmp_path / "tri.mat"
    mat.write_text(f"material painted\nalbedo 1.0 0.5 0.25\nroughness 0.2\nn 1.3\n"
                   f"texture {tex_png}\n")
    meshes = [(str(obj), str(mat), Transformation.identity(), False)]
    scene = create_scene_from_files(meshes, prepare=False)
    _assert_tree_equal(
        interop.scene_to_numpy(scene),
        interop.scene_to_numpy(_jax("scene.obj").create_scene_from_files(meshes, build_kd=False)),
    )
    tex_ids = np.asarray(scene.materials.tex_id)
    assert tex_ids[int(scene.mat_id[0])] == 0
    np.testing.assert_array_equal(
        scene.textures.buffer,
        procedural.checker_texture(tiles=2, size=8).reshape(-1, 3).astype(np.float32) / 255.0,
    )


# ---------------------------------------------------------------------------
# scene/export: save_mat, save_obj, load_offset; round trips
# ---------------------------------------------------------------------------


def _roundtrip(tmp_path, scene, mat_names, uvs=False, texture_paths=None):
    """Export with both packages (the same text, byte for byte), load the
    port's files back: the same triangle soup (TestObjExport's tolerances)."""
    verts, normals, mat_id = scene.vertices, scene.normals, scene.mat_id
    rows = material_rows(scene.materials, texture_paths)
    jexport = _jax("scene.export")
    files = {}
    for who, (mat_fn, obj_fn) in {"port": (save_mat, save_obj),
                                  "jax": (jexport.save_mat, jexport.save_obj)}.items():
        obj_path, mat_path = str(tmp_path / f"{who}.obj"), str(tmp_path / f"{who}.mat")
        mat_fn(mat_path, mat_names, rows)
        obj_fn(obj_path, verts, normals, mat_id, mat_names, uvs=scene.uvs if uvs else None)
        files[who] = (obj_path, mat_path)
    for port_file, jax_file in zip(files["port"], files["jax"]):
        assert open(port_file).read() == open(jax_file).read()
    offset = load_offset(verts)
    np.testing.assert_array_equal(offset, jexport.load_offset(verts))
    loaded = create_scene_from_files(
        [(*files["port"], Transformation(offset, np.eye(3, dtype=np.float32)), False)],
        prepare=False,
    )
    np.testing.assert_allclose(loaded.vertices, verts, atol=2e-6)
    np.testing.assert_allclose(loaded.normals, normals, atol=2e-6)
    np.testing.assert_array_equal(loaded.uvs, scene.uvs)
    for field in ("albedo", "emittance", "roughness", "ior", "extinction", "transparent"):
        np.testing.assert_array_equal(
            np.asarray(getattr(loaded.materials, field))[loaded.mat_id],
            np.asarray(getattr(scene.materials, field))[mat_id], err_msg=field,
        )
    return loaded


def test_roundtrip_cornell(tmp_path):
    _needs_gxx()
    _roundtrip(tmp_path, procedural.cornell_box(glossy=True), ["white", "red", "green", "light"])


def test_roundtrip_with_uvs(tmp_path):
    _needs_gxx()
    b = procedural.SceneBuilder()
    m = b.add_material(albedo=(0.5, 0.6, 0.7), roughness=0.2, ior=1.3)
    b.add_quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), m, uv=True)
    b.add_quad((0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1), m)
    scene = b.build()
    assert not np.all(scene.uvs == 1.0)
    _roundtrip(tmp_path, scene, ["mat0"], uvs=True)


def test_roundtrip_textured_demo_keeps_the_atlas(tmp_path):
    """The demo with its checker written as a PNG and named by a ``texture``
    line: the atlas equals the procedural one exactly (uint8 texels), and
    the textured material's rows carry it."""
    _needs_gxx()
    demo = procedural.material_demo_scene()
    png = tmp_path / "checker.png"
    save_png(str(png), procedural.checker_texture(), flip_vertical=False)
    loaded = _roundtrip(tmp_path, demo, ["floor", "white", "gold", "glass", "light"], uvs=True,
                        texture_paths={0: str(png)})
    _assert_tree_equal(interop._leaves(loaded.textures, interop._TEXTURES),
                       interop._leaves(demo.textures, interop._TEXTURES))
    textured = loaded.materials.tex_id[loaded.mat_id] >= 0
    np.testing.assert_array_equal(textured, demo.materials.tex_id[demo.mat_id] >= 0)


def test_save_obj_random_soup_text_matches_jax(tmp_path):
    """Seeded random arrays with shared corners, several material runs and
    uvs: the port writes the JAX package's OBJ byte for byte, and both
    packages load it back to the same scene, exactly."""
    _needs_gxx()
    rng = np.random.default_rng(21)
    pool = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    verts = pool[rng.integers(0, 50, (200, 3))]
    normals = rng.normal(size=(200, 3, 3)).astype(np.float32)
    uvs = rng.random((200, 3, 2)).astype(np.float32)
    mat_id = np.sort(rng.integers(0, 3, 200)).astype(np.int32)
    names = ["x", "y", "z"]
    save_obj(str(tmp_path / "p.obj"), verts, normals, mat_id, names, uvs=uvs)
    _jax("scene.export").save_obj(str(tmp_path / "j.obj"), verts, normals, mat_id, names, uvs=uvs)
    assert (tmp_path / "p.obj").read_text() == (tmp_path / "j.obj").read_text()
    meshes = [(str(tmp_path / "p.obj"), "", Transformation(load_offset(verts), np.eye(3)),
               True)]
    _assert_tree_equal(
        interop.scene_to_numpy(create_scene_from_files(meshes, prepare=False)),
        interop.scene_to_numpy(_jax("scene.obj").create_scene_from_files(meshes,
                                                                         build_kd=False)),
    )


# ---------------------------------------------------------------------------
# cli/render: the JSON scene manifest
# ---------------------------------------------------------------------------


def test_cli_scene_manifest(tmp_path):
    _needs_gxx()
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 2\nv 1 0 2\nv 0 1 2\nusemtl lamp\nf 1 2 3\n")
    mat = tmp_path / "tri.mat"
    mat.write_text("material lamp\nalbedo 0.5 0.5 0.5\nemittance 5 5 5\n")
    manifest = tmp_path / "scene.json"
    manifest.write_text(json.dumps(
        [{"obj": str(obj), "mat": str(mat), "offset": [0, 0, 2], "scale": 1.0}]))
    out = str(tmp_path / "m.png")
    assert cli.main([
        "--scene", str(manifest), "--device", "cpu", "--width", "8", "--height", "8",
        "--max-samples", "2", "--min-samples", "1", "--max-bounces", "2",
        "--camera", "0", "0", "0", "0", "0", "--aperture", "0", "--out", out,
    ]) == 0
    img = load_image(out)
    assert img.shape == (8, 8, 4) and img[..., :3].max() > 0


@pytest.mark.parametrize("rotated", [False, True], ids=["offset_scale", "yaw_pitch_roll"])
def test_manifest_scene_matches_jax(tmp_path, mat_path, rotated):
    """The CLI's manifest loader against the JAX CLI's on a two-mesh
    manifest with offsets, scales and smooth normals: exact without a
    rotation, within ROT_ATOL with one."""
    _needs_gxx()
    meshes = _two_meshes(tmp_path, mat_path)
    entries = [
        {"obj": meshes[0][0], "mat": mat_path, "offset": [0.5, -1, 2], "scale": 2.0,
         "smooth_normals": True},
        {"obj": meshes[1][0], "mat": mat_path, "offset": [0, 3, 0], "scale": 0.5},
    ]
    if rotated:
        entries[0].update(yaw=0.4, pitch=-0.2, roll=0.1)
        entries[1].update(yaw=-1.1)
    manifest = tmp_path / "scene.json"
    manifest.write_text(json.dumps(entries))
    port = cli.load_scene(cli.parse_args(["--scene", str(manifest)]), "cpu")
    jcli = _jax("cli.render")
    want = jcli.load_scene(jcli.parse_args(["--scene", str(manifest), "--kd-depth", "4",
                                            "--kd-leaf", "2"]))
    # the port's CLI builds no KD tree (its renders take the cluster tables)
    assert port.kd is None and port.wkd is None
    _assert_tree_equal(interop.scene_to_numpy(port),
                       {**interop.scene_to_numpy(want), "kd": None, "wkd": None},
                       atol=ROT_ATOL * 8 if rotated else 0.0)  # |p - c| * scale <= 8


def test_cli_missing_manifest_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        cli.main(["--scene", str(tmp_path / "none.json"), "--device", "cpu",
                  "--width", "8", "--height", "8"])


def test_port_modules_import_nothing_of_the_jax_package():
    """No module of the port imports a module of the JAX package, not even
    one that imports no JAX itself (native.py, scene/mat.py,
    scene/export.py): the port keeps its own copies."""
    import ast

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    pkg = os.path.join(pkg, "isaklm_raytracer_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(root, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                         [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for name in names:
                    assert name.split(".")[0] != "isaklm_raytracer_tpu", (f, name)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_loaded_demo_through_flat(tmp_path):
    """The demo exported to OBJ + .mat + PNG and loaded back onto the card:
    the procedural atlas exactly; the flat kernel equal to its plain version
    bit for bit on the loaded scene's camera rays; a render through the flat
    kernel alone (no plain version on CUDA), within the aggregate gate of
    scripts/hero_obj_roundtrip.py (mean |d| < 2e-3, pixels off by more than
    0.05 under 1%) of the same files rendered on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from isaklm_raytracer_tpu_torch.camera import Camera, generate_rays
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import intersector_name, render, resolve_image
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    demo = procedural.material_demo_scene()
    png = tmp_path / "checker.png"
    save_png(str(png), procedural.checker_texture(), flip_vertical=False)
    names = ["floor", "white", "gold", "glass", "light"]
    save_mat(str(tmp_path / "demo.mat"), names,
             material_rows(demo.materials, {0: str(png)}))
    save_obj(str(tmp_path / "demo.obj"), demo.vertices, demo.normals, demo.mat_id, names,
             uvs=demo.uvs)
    meshes = [(str(tmp_path / "demo.obj"), str(tmp_path / "demo.mat"),
               Transformation(load_offset(demo.vertices), np.eye(3, dtype=np.float32)), False)]
    scene = create_scene_from_files(meshes)
    assert scene.device.type == "cuda" and intersector_name(scene.cbvh) == "flat"
    assert torch.equal(scene.textures.buffer.cpu(), torch.from_numpy(demo.textures.buffer))

    tri = scene.cbvh.tri_const[: scene.cbvh.real_clusters]
    camera = Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2, device="cuda")
    ids = torch.arange(128 * 128, device="cuda")
    u = torch.rand((ids.numel(), 4), generator=torch.Generator("cuda").manual_seed(0),
                   device="cuda")
    rays = ki.prep_rays(*generate_rays(camera, 128, 128, ids % 128, ids // 128, u))
    got, want = ki.flat_intersect(tri, rays, 1e-5), ki.flat_intersect_plain(tri, rays, 1e-5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[1] != ki._BIG_ID).sum()) > ids.numel() // 2

    config = RenderConfig(width=64, height=64, max_bounces=4, ray_chunk=0)
    ki.COUNTS.reset()
    gb = render(scene, camera, config, num_samples=2, seed=0)
    torch.cuda.synchronize()
    assert ki.COUNTS.flat_kernel > 0 and ki.COUNTS.plain_cuda() == 0
    assert all(getattr(ki.COUNTS, f"{k}_kernel") == 0
               for k in ("flat_mxu", "queue", "hbm", "blk", "blk_mxu"))
    card = resolve_image(gb, config).cpu().numpy()
    cpu_scene = prepare_scene(create_scene_from_files(meshes, prepare=False), "cpu")
    gb = render(cpu_scene, camera.to("cpu"), config, num_samples=2, seed=0)
    dev = np.abs(card - resolve_image(gb, config).numpy())
    assert np.isfinite(card).all() and card.mean() > 0.01
    assert dev.mean() < 2e-3 and (dev.max(axis=-1) > 0.05).mean() < 0.01, dev.mean()
