"""The port's TOML config, BMP writer and CLI against the JAX package.

The same TOML files go through both packages' read_config_file: the same
fields, the same warnings and the same config echo, with every quirk of
the reference's parser (soft shadows and transparency are not read, a
missing scene file exits 1, `~` and `$HOME`, an empty output_dir, no
lights, an unknown light type). write_bmp writes the same bytes. cli.run
renders a two-camera config of the 41x32 dragon stand-in
(tools/make_large_asset.py) with the accel on (JAX's cluster path in
interpret mode, intersect.FORCE_CLUSTER_INTERPRET) and off: the same file
names, and images equal on >= 99.5% of pixels within 1 of 255.
"""

import dataclasses
import os
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu import cli as jcli
from cge_tpu import config as jconfig
from cge_tpu.ops import intersect as jint
from cge_tpu.scene import image_io as jio
from cge_tpu.scene import scene as jscene
from cge_tpu_torch import cli as pcli
from cge_tpu_torch import config as pconfig
from cge_tpu_torch.scene import image_io as pio
from cge_tpu_torch.scene import scene as pscene
from tools.make_large_asset import write_obj

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGHTS = """
    [[lights]]
    type = "point"
    position = [1.0, 2.0, 3.0]
    color = [1.0, 1.0, 1.0]
"""
CONFIGS = {
    "full_schema": """
        command_line_rendering = true
        window_size = [320, 200]
        data_path = "default"
        scene = "cornell_box"
        output_dir = "~/renders"

        [features]
        enable_shading = true
        enable_recursive = true

        [features.extra]
        enable_bloom_effect = true
        enable_bilinear_texture_filtering = true

        [[cameras]]
        field_of_view = 65.0
        distance_from_look_at = 2.2
        look_at = [0.1, -0.1, 0.0]
        rotation = [-15.0, 40.0, 0.0]

        [[cameras]]

        [[lights]]
        type = "point"
        position = [1.0, 2.0, 3.0]
        color = [1.0, 1.0, 1.0]

        [[lights]]
        type = "segment"
        endpoints = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]
        colors = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]

        [[lights]]
        type = "parallelogram"
        corner = [0.0, 1.0, 0.0]
        edges = [[0.5, 0.0, 0.0], [0.0, 0.0, 0.5]]
        colors = [[1.0,0.0,0.0],[0.0,1.0,0.0],[0.0,0.0,1.0],[0.0,1.0,1.0]]
    """,
    "defaults_scene_int": """
        scene = 6
        output_dir = "out"
    """ + LIGHTS,
    "scene_names": """
        scene = "Cornell-Box-Parallelogram-Light"
        output_dir = "$HOME/x"
        command_line_rendering = false
        window_size = [64]
    """ + LIGHTS,
    "obj_path": """
        data_path = "{data}"
        scene = "mesh.obj"
        output_dir = "~"
    """ + LIGHTS,
    # the reference never reads these three flags from the file
    "unparsed_flags": """
        scene = "cube"
        output_dir = "/x/y"
        [features]
        enable_soft_shadow = true
        enable_accel_structure = true
        [features.extra]
        enable_transparency = true
        enable_bvh_sah_binning = true
        enable_depth_of_field = true
    """ + LIGHTS,
    "no_lights_empty_output": """
        scene = "spheres"
        output_dir = ""
    """,
    "unknown_light": """
        scene = "spheres"
        output_dir = "x"
        [[lights]]
        type = "spot"
        position = [0.0, 0.0, 0.0]
        [[lights]]
        type = "segment"
        endpoints = [[0.0, 0.0, 0.0]]
    """,
}


def _write(tmp_path, body, data=""):
    p = tmp_path / "cfg.toml"
    p.write_text(textwrap.dedent(body).replace("{data}", data))
    return str(p)


def _fields(cfg):
    """A config's fields as plain values."""
    scene = cfg.scene
    return dict(
        cli=cfg.cli_rendering_enabled, window=tuple(cfg.window_size),
        data_path=cfg.data_path,
        scene=(("type", int(scene)) if isinstance(scene, int)
               else ("path", scene)),
        output_dir=cfg.output_dir,
        features=dataclasses.asdict(cfg.features),
        cameras=[dataclasses.asdict(c) for c in cfg.cameras],
        lights=[(type(l).__name__, dataclasses.asdict(l))
                for l in cfg.lights])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_read_config_matches_jax(name, tmp_path, monkeypatch, capsys):
    """The same fields, warnings (stdout and stderr) and echo text. The
    one difference is the default data directory: the JAX package's names
    a place on its host, the port's is empty (a prebuilt scene read from
    it needs its directory named), so where a config leaves data_path to
    the default, that field and its echo line hold each side's own
    DEFAULT_DATA_DIR and everything else is equal."""
    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "mesh.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    path = _write(tmp_path, CONFIGS[name], str(tmp_path))
    j = jconfig.read_config_file(path)
    jout = capsys.readouterr()
    p = pconfig.read_config_file(path)
    pout = capsys.readouterr()
    pf, jf = _fields(p), _fields(j)
    pe, je = str(p).splitlines(), str(j).splitlines()
    if j.data_path == jscene.DEFAULT_DATA_DIR:
        assert p.data_path == pscene.DEFAULT_DATA_DIR == ""
        del pf["data_path"], jf["data_path"]
        k = je.index(f"  data_path: {j.data_path}")
        assert pe.pop(k) == "  data_path: "
        je.pop(k)
    else:
        assert p.data_path == j.data_path == str(tmp_path)
    assert pf == jf
    assert (pout.out, pout.err) == (jout.out, jout.err)
    assert pe == je
    if name == "unparsed_flags":
        f = p.features
        assert f.enable_accel_structure and f.enable_depth_of_field
        assert not (f.enable_soft_shadow or f.enable_transparency
                    or f.enable_bvh_sah_binning)
    if name == "no_lights_empty_output":
        assert p.output_dir == str(tmp_path) and p.lights == []
        assert "No lights" in pout.err and "No output directory" in pout.out
    if name == "unknown_light":
        assert "Unknown light type: spot -- Skip" in pout.err
        assert len(p.lights) == 1


def test_missing_scene_exits_1(tmp_path, capsys):
    """Under a named data_path (the default data directories differ, see
    test_read_config_matches_jax)."""
    path = _write(tmp_path, """
        data_path = "{data}"
        scene = "nope.obj"
        output_dir = "x"
    """, str(tmp_path))
    codes = []
    for mod in (jconfig, pconfig):
        with pytest.raises(SystemExit) as e:
            mod.read_config_file(path)
        codes.append(e.value.code)
    assert codes == [1, 1]
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0] == err[1]
    assert err[0] == (f"Error: Scene file {tmp_path / 'nope.obj'} does not "
                      f"exist.")


@pytest.mark.parametrize("base,extra", [
    ({"enableShading": True, "enableAccelStructure": True,
      "extra": {"enableBvhSahBinning": True, "enableDepthOfField": True}},
     None),
    ({"enableNormalInterp": True}, {"enableGlossyReflection": True}),
    ({"enableHardShadow": 1, "extra": {"enableTransparency": True}},
     {"enableBloomEffect": True}),
    ({}, None),
])
def test_features_from_nested_matches_jax(base, extra):
    j = cge_tpu.Features.from_nested(base, extra)
    p = ct.Features.from_nested(base, extra)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)


def test_features_from_nested_unknown_flag():
    for cls in (cge_tpu.Features, ct.Features):
        with pytest.raises(KeyError):
            cls.from_nested({"enableWarpDrive": True})


def test_scene_names_match_jax():
    for t in jscene.SceneType:
        name = jscene.serialize_scene_type(t)
        assert pscene.serialize_scene_type(pscene.SceneType(int(t))) == name
        for spelling in (name, name.replace("_", ""), name.upper(),
                         name.replace("_", "-"), "nope"):
            jt = jscene.deserialize_scene_type(spelling)
            pt = pscene.deserialize_scene_type(spelling)
            assert (pt is None and jt is None) or int(pt) == int(jt)


@pytest.mark.parametrize("shape", [(3, 5), (8, 8), (2, 7), (1, 1), (6, 13)])
def test_write_bmp_bytes_match_jax(shape, tmp_path):
    """Bottom-up BGR rows padded to 4 bytes, to_u8's truncation, NaN -> 0,
    and read_bmp gives JAX's read_bmp (Pillow) back."""
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(-0.3, 1.3, shape + (3,)).astype(np.float32)
    img.flat[::7] = np.nan
    img[0, 0] = (1.0, 0.5, 0.999)
    a, b = tmp_path / "jax.bmp", tmp_path / "port.bmp"
    jio.write_bmp(str(a), img)
    pio.write_bmp(str(b), img)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(pio.read_bmp(str(b)),
                                  jio.read_bmp(str(a)))
    assert pio.read_bmp(str(b)).shape == shape + (3,)


def test_png_bytes_decode():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    assert np.array_equal(pio.decode_png(pio.png_bytes(img)), img)


@pytest.fixture(scope="module")
def obj_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    write_obj(str(d / "dragon.obj"), 41, 32)
    return d


def _cli_config(obj_dir, out, accel):
    return textwrap.dedent(f"""
        window_size = [32, 24]
        data_path = "{obj_dir}"
        scene = "dragon.obj"
        output_dir = "{out}"
        [features]
        enable_shading = true
        enable_hard_shadow = true
        enable_normal_interp = true
        enable_accel_structure = {str(accel).lower()}
        [[cameras]]
        [[cameras]]
        field_of_view = 40.0
        distance_from_look_at = 2.5
        rotation = [10.0, -30.0, 0.0]
        [[lights]]
        type = "point"
        position = [-1.0, 1.0, -1.0]
        color = [1.0, 1.0, 1.0]
    """)


NAME = re.compile(r"^dragon_\d{4}-\d\d-\d\d-\d\d:\d\d:\d\d_cam_(\d)\.bmp$")


@pytest.mark.parametrize("accel", [True, False])
def test_cli_run_matches_jax(accel, obj_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jint, "FORCE_CLUSTER_INTERPRET", True)
    path = tmp_path / "cfg.toml"
    paths = {}
    for side, mod, kw in (("jax", jcli, {}),
                          ("port", pcli, {"device": "cpu"})):
        path.write_text(_cli_config(obj_dir, tmp_path / side, accel))
        cfg = (jconfig if side == "jax" else pconfig).read_config_file(
            str(path))
        paths[side] = mod.run(cfg, **kw)
    out = capsys.readouterr().out
    assert len(re.findall(r"Rendering took \d+ ms, 2 images rendered\.",
                          out)) == 2
    for i, (a, b) in enumerate(zip(paths["jax"], paths["port"])):
        assert NAME.match(os.path.basename(b)).group(1) == str(i)
        assert NAME.match(os.path.basename(a)).group(1) == str(i)
        assert f"Image {i} saved to {b}" in out
        ja = np.round(jio.read_bmp(a) * 255).astype(int)
        pb = np.round(pio.read_bmp(b) * 255).astype(int)
        assert pb.shape == (24, 32, 3)
        assert pb.max() > 20
        close = (np.abs(ja - pb) <= 1).all(axis=-1).mean()
        assert close >= 0.995, (i, close)
    assert not np.array_equal(pio.read_bmp(paths["port"][0]),
                              pio.read_bmp(paths["port"][1]))


def test_cli_main_and_module(obj_dir, tmp_path):
    """`python -m cge_tpu_torch.cli --device cpu cfg` renders both cameras
    and exits 0; main() with the default device raises without a card."""
    path = tmp_path / "cfg.toml"
    path.write_text(_cli_config(obj_dir, tmp_path / "out", True))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "cge_tpu_torch.cli",
                        "--device", "cpu", str(path)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "Rendering took" in r.stdout and r.stdout.startswith("Config:")
    names = sorted(os.listdir(tmp_path / "out"))
    assert [NAME.match(n).group(1) for n in names] == ["0", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pcli.main([str(path)])


def test_prebuilt_scene_reads_data_path(obj_dir, tmp_path, capsys):
    """The port has no default data directory: a prebuilt mesh scene of a
    config without data_path fails to load, naming data_dir; under a
    data_path holding its OBJ (the stand-in copied as monkey.obj) the CLI
    renders it; Spheres needs no data files."""
    body = """
        window_size = [16, 12]
        scene = "{scene}"
        output_dir = "{out}"
        [features]
        enable_shading = true
        [[cameras]]
    """
    path = tmp_path / "cfg.toml"
    path.write_text(textwrap.dedent(body).format(scene="monkey",
                                                 out=tmp_path / "a"))
    cfg = pconfig.read_config_file(str(path))
    assert cfg.data_path == ""
    with pytest.raises(FileNotFoundError, match="data_dir"):
        pcli.run(cfg, device="cpu")
    shutil.copy(os.path.join(obj_dir, "dragon.obj"), tmp_path / "monkey.obj")
    path.write_text(f'data_path = "{tmp_path}"\n'
                    + textwrap.dedent(body).format(scene="monkey",
                                                   out=tmp_path / "b"))
    (monkey,) = pcli.run(pconfig.read_config_file(str(path)), device="cpu")
    path.write_text(textwrap.dedent(body).format(scene="spheres",
                                                 out=tmp_path / "c"))
    (spheres,) = pcli.run(pconfig.read_config_file(str(path)), device="cpu")
    capsys.readouterr()
    for p in (monkey, spheres):
        img = pio.read_bmp(p)
        assert img.shape == (12, 16, 3) and img.max() > 0
