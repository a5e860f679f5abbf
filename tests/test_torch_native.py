"""The port's native host library (cge_tpu_torch.native) against its numpy
twins and against the JAX package's library (cge_tpu.native).

The library is built here with g++ at first use, as on any machine. On
the 41x32 dragon stand-in (tools/make_large_asset.py), its textured and
glass variants (cge_tpu_torch/tools/common.py):
  - the loader equals cge_tpu.native's bit for bit (one C++ source) and
    the numpy loader to f32 rounding (rtol 1e-6, atol 1e-7, the JAX
    package's tests/test_native.py rule; triangles exactly), with and
    without normalisation; a missing file raises FileNotFoundError;
  - the cluster perm equals cge_tpu.native's, which is the JAX default's,
    with the numpy twin's cluster sizes and, on these stand-ins (no split
    plane through equal centres), its triangles cluster by cluster;
  - the reference BVH (median, SAH) equals the JAX package's native build
    node for node, and the numpy twin in levels, leaves, max per leaf and
    leaf spans;
  - a failed build raises with the compiler's output, never falls back;
  - the loader and both builders run clean under ASan and UBSan, and so
    do the image decoders on whole and damaged files: cge_jpeg.cpp from a
    C++ main (every JPEG fixture, and files of each of its paths written
    here: each upsampler, YCCK, arithmetic coding, block smoothing,
    lossless, the cases Pillow refuses), the PNG row filters, TGA
    run-length packets, GIF LZW and PSD PackBits through the Python
    decoders that call them;
  - one object a source: a change to one source rebuilds its object only,
    with the same flags.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cge_tpu import native as jnative
from cge_tpu.ops import bvh as jbvh
from cge_tpu.scene.mesh_io import Material as JMaterial
from cge_tpu.scene.mesh_io import load_mesh as jload_mesh
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import SphereDef, build_scene_arrays
from cge_tpu_torch import native
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.ops import bvh
from cge_tpu_torch.scene import jpeg, mesh_io
from cge_tpu_torch.tools.common import write_textured_obj, write_variant_obj
from jax_references import make_textures
from tools.make_large_asset import write_obj

LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))


@pytest.fixture(scope="module")
def objs(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    out = {"dragon": str(d / "dragon.obj"),
           "textured": str(d / "textured" / "dragon.obj"),
           "glass": str(d / "glass" / "dragon.obj")}
    for p in out.values():
        os.makedirs(os.path.dirname(p), exist_ok=True)
    write_obj(out["dragon"], 41, 32)
    write_textured_obj(out["textured"], 41, 32)
    write_variant_obj(out["glass"], 41, 32, "glass")
    return out


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("which", ["dragon", "textured", "glass"])
def test_loader_matches_jax_native_and_numpy(objs, which, normalize):
    path = objs[which]
    mine = native.load_obj(path, normalize)
    ref = jnative.load_obj_native(path, normalize)
    assert len(mine) == len(ref) > 1
    for a, b in zip(mine, ref):
        for x, y in zip(a[:4], b[:4]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        for k in ("kd", "ks"):
            np.testing.assert_array_equal(a[4][k], b[4][k])
        for k in ("shininess", "dissolve", "map_kd", "default"):
            assert a[4][k] == b[4][k], k
    subs = mesh_io.load_mesh(path, normalize)
    twin = mesh_io.load_mesh(path, normalize, use_native=False)
    assert len(subs) == len(twin) == len(mine)
    for a, b in zip(subs, twin):
        np.testing.assert_array_equal(a.triangles, b.triangles)
        for k in ("positions", "normals", "texcoords"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(a.material.kd, b.material.kd)
        np.testing.assert_array_equal(a.material.ks, b.material.ks)
        # the native loader hands over f32 values, the numpy twin Python
        # floats; the scene stores both as f32
        assert np.float32(a.material.shininess) == np.float32(
            b.material.shininess)
        assert np.float32(a.material.transparency) == np.float32(
            b.material.transparency)
        assert (a.material.kd_texture is None) == (b.material.kd_texture
                                                   is None)
        if a.material.kd_texture is not None:
            np.testing.assert_array_equal(a.material.kd_texture.pixels,
                                          b.material.kd_texture.pixels)
    if which == "glass":
        assert sorted({np.float32(m.material.transparency)
                       for m in subs}) == [np.float32(0.45), 1.0]
    if which == "textured":
        assert any(m.material.kd_texture is not None for m in subs)


def test_loader_missing_file_raises(tmp_path):
    absent = str(tmp_path / "absent.obj")
    with pytest.raises(FileNotFoundError, match="absent.obj"):
        native.load_obj(absent, False)
    with pytest.raises(FileNotFoundError):
        mesh_io.load_mesh(absent)


def _jax_scene(path, spheres=()):
    return build_scene_arrays(jload_mesh(path), list(spheres),
                              [JPointLight(*LIGHT)])


def _port_scene(js):
    return scene_from_numpy({k: np.asarray(getattr(js, k))
                             for k in TENSOR_FIELDS},
                            all_opaque=js.all_opaque,
                            all_diffuse=js.all_diffuse, device="cpu")


@pytest.fixture(scope="module")
def scenes(objs, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native_big") / "dragon.obj")
    write_obj(path, 121, 64)
    mixed = _jax_scene(objs["dragon"], [
        SphereDef((0.0, 0.1, 0.0), 0.3, JMaterial()),
        SphereDef((0.55, 0.45, -0.7), 0.2, JMaterial())])
    return {"small": _jax_scene(objs["dragon"]), "large": _jax_scene(path),
            "mixed": mixed}


@pytest.mark.parametrize("which", ["small", "large"])
def test_cluster_perm_matches_jax_native(scenes, which):
    js = scenes[which]
    V, T, M = (np.asarray(x) for x in (js.vertices, js.tris, js.tri_mask))
    mine = bvh.build_clusters(V, T, M)
    np.testing.assert_array_equal(mine, jbvh.build_clusters(V, T, M))
    np.testing.assert_array_equal(
        mine, jbvh.build_clusters(V, T, M, use_native=True))
    twin = bvh.build_clusters(V, T, M, use_native=False)
    assert mine.shape == twin.shape
    np.testing.assert_array_equal((mine >= 0).sum(1), (twin >= 0).sum(1))
    assert sorted(mine[mine >= 0].tolist()) == np.nonzero(M)[0].tolist()
    # no split plane of these stand-ins cuts through equal centres, so the
    # clusters hold the same triangles (where one does, nth_element and
    # argpartition put the tied ones on either side)
    assert all(set(a) == set(b) for a, b in zip(mine, twin))


def _spans(b):
    m = b.node_meta
    return sorted((int(x), int(y)) for x, y in m[m[:, 0] == 1][:, 2:4])


@pytest.mark.parametrize("sah", [False, True])
@pytest.mark.parametrize("which", ["small", "mixed"])
def test_reference_bvh_matches_jax_native(scenes, which, sah):
    js = scenes[which]
    ps = _port_scene(js)
    mine = bvh.build_reference_bvh(ps, sah_binning=sah)
    ref = jbvh.build_reference_bvh(js, sah_binning=sah, use_native=True)
    for k in ("node_lo", "node_hi", "node_meta", "perm_is_sphere",
              "perm_index"):
        a, b = getattr(mine, k), getattr(ref, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (mine.root, mine.num_levels, mine.num_leaves,
            mine.max_per_leaf) == (ref.root, ref.num_levels, ref.num_leaves,
                                   ref.max_per_leaf)
    twin = bvh.build_reference_bvh(ps, sah_binning=sah, use_native=False)
    assert (mine.num_levels, mine.num_leaves, mine.max_per_leaf) == (
        twin.num_levels, twin.num_leaves, twin.max_per_leaf)
    assert len(mine.node_meta) == len(twin.node_meta)
    assert _spans(mine) == _spans(twin)
    assert sorted(zip(mine.perm_is_sphere.tolist(),
                      mine.perm_index.tolist())) == sorted(
        zip(twin.perm_is_sphere.tolist(), twin.perm_index.tolist()))
    # the recorded SAH cuts come from the numpy twin, as in the JAX package
    cuts = bvh.build_reference_bvh(ps, sah_binning=sah, record_sah_cuts=True)
    assert cuts.sah_cuts_per_level is not None


def test_one_changed_source_rebuilds_one_object(tmp_path):
    """native.build compiles each source into an object of its own, named
    by the source, the compiler and the flags (-Werror among them): a
    second build compiles nothing and loads the same library; one with a
    source changed compiles that source only and links a new library."""
    build_dir = str(tmp_path / "build")
    first = native.build(build_dir=build_dir)
    assert sorted(first.compiled) == sorted(native.SOURCES)
    assert len(os.listdir(os.path.join(build_dir, "objects"))) == len(
        native.SOURCES)
    again = native.build(build_dir=build_dir)
    assert again.compiled == () and again.path == first.path
    changed = tmp_path / "cge_zstd.cpp"
    changed.write_text(open(native.ZSTD_SOURCE).read() + "// changed\n")
    sources = tuple(str(changed) if src == native.ZSTD_SOURCE else src
                    for src in native.SOURCES)
    third = native.build(build_dir=build_dir, sources=sources)
    assert third.compiled == (str(changed),)
    assert third.path != first.path
    assert "-Werror" in native.CXXFLAGS


@pytest.mark.parametrize("how", ["missing_compiler", "bad_flag"])
def test_failed_build_raises(tmp_path, how):
    kw = (dict(cxx=str(tmp_path / "no" / "g++")) if how == "missing_compiler"
          else dict(flags=native.CXXFLAGS + ("-fno-such-flag-here",)))
    with pytest.raises(RuntimeError, match="native build") as err:
        native.build(build_dir=str(tmp_path / "build"), **kw)
    if how == "bad_flag":
        assert "no-such-flag-here" in str(err.value)
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "build"))


def test_default_paths_raise_without_fallback(objs, monkeypatch):
    """With the library unbuildable, the default loader and builders raise
    instead of running the numpy twins."""
    def broken():
        raise RuntimeError("native build failed (test)")

    monkeypatch.setattr(native, "library", broken)
    with pytest.raises(RuntimeError, match="native build failed"):
        mesh_io.load_mesh(objs["dragon"])
    subs = mesh_io.load_mesh(objs["dragon"], use_native=False)
    V = np.concatenate([s.positions for s in subs])
    T = subs[0].triangles.astype(np.int64)
    with pytest.raises(RuntimeError, match="native build failed"):
        bvh.build_clusters(V, T, np.ones(len(T), bool))
    assert bvh.build_clusters(V, T, np.ones(len(T), bool),
                              use_native=False).shape[1] == bvh.CLUSTER_SIZE


SANITIZED_MAIN = r"""
#include <cstdio>
#include <vector>
extern "C" {
void* cge_load_obj(const char*, int);
const char* cge_error(void*);
int cge_n_submeshes(void*);
void cge_submesh_counts(void*, int, int*, int*);
void cge_submesh_data(void*, int, float*, float*, float*, unsigned*);
int cge_submesh_material(void*, int, float*, char*, int);
void cge_release(void*);
int cge_build_clusters(const float*, int, int, int*, int);
int cge_build_bvh(const float*, const float*, const float*, int, int, int,
                  float*, float*, int*, int*, int*);
}
int main(int argc, char** argv) {
    if (argc != 2) return 2;
    for (int norm = 0; norm < 2; ++norm) {
        void* h = cge_load_obj(argv[1], norm);
        if (cge_error(h)[0]) { std::fprintf(stderr, "load\n"); return 1; }
        int n = cge_n_submeshes(h);
        std::vector<float> centers;
        std::vector<float> lo, hi;
        for (int i = 0; i < n; ++i) {
            int nv = 0, nt = 0;
            cge_submesh_counts(h, i, &nv, &nt);
            std::vector<float> pos(3 * nv), nrm(3 * nv), uv(2 * nv), m(8);
            std::vector<unsigned> tri(3 * nt);
            cge_submesh_data(h, i, pos.data(), nrm.data(), uv.data(),
                             tri.data());
            char map_kd[256];
            cge_submesh_material(h, i, m.data(), map_kd, 256);
            for (int t = 0; t < nt; ++t) {
                float c[3] = {0, 0, 0}, l[3] = {1e30f, 1e30f, 1e30f},
                      u[3] = {-1e30f, -1e30f, -1e30f};
                for (int k = 0; k < 3; ++k)
                    for (int a = 0; a < 3; ++a) {
                        float v = pos[3 * tri[3 * t + k] + a];
                        c[a] += v / 3;
                        l[a] = v < l[a] ? v : l[a];
                        u[a] = v > u[a] ? v : u[a];
                    }
                centers.insert(centers.end(), c, c + 3);
                lo.insert(lo.end(), l, l + 3);
                hi.insert(hi.end(), u, u + 3);
            }
        }
        cge_release(h);
        int N = (int)(centers.size() / 3);
        std::vector<int> perm(2 * (N / 128 + 1) * 128);
        int L = cge_build_clusters(centers.data(), N, 128, perm.data(),
                                   (int)perm.size());
        if (L <= 0) { std::fprintf(stderr, "clusters\n"); return 1; }
        for (int sah = 0; sah < 2; ++sah) {
            std::vector<float> nlo(3 * (2 * N - 1)), nhi(3 * (2 * N - 1));
            std::vector<int> meta(6 * (2 * N - 1)), p(N), stats(3);
            int nodes = cge_build_bvh(lo.data(), hi.data(), centers.data(),
                                      N, sah, 2 * N - 1, nlo.data(),
                                      nhi.data(), meta.data(), p.data(),
                                      stats.data());
            if (nodes <= 0) { std::fprintf(stderr, "bvh\n"); return 1; }
        }
        std::printf("SANITIZED_OK norm=%d submeshes=%d clusters=%d\n", norm,
                    n, L);
    }
    return 0;
}
"""


def test_host_library_under_asan_ubsan(objs, tmp_path):
    """The port's copy of cge_host.cpp with its build flags plus
    -fsanitize=address,undefined, linked to a main program that loads the
    textured stand-in (with and without normalisation) and runs both
    builders (median and SAH BVH) in a subprocess. At -O0 in place of -O2:
    the sanitized build takes 5 s here against 25-30 s, and no
    optimisation hides undefined behaviour."""
    main = tmp_path / "main.cpp"
    main.write_text(SANITIZED_MAIN)
    exe = tmp_path / "san"
    flags = [f for f in native.CXXFLAGS if f not in ("-fPIC", "-O2")]
    flags.insert(0, "-O0")
    subprocess.run([native.CXX, *flags, "-g", "-fno-omit-frame-pointer",
                    "-fsanitize=address,undefined", native.SOURCE, str(main),
                    "-o", str(exe)], check=True, timeout=300,
                   capture_output=True)
    r = subprocess.run([str(exe), objs["textured"]], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, UBSAN_OPTIONS="halt_on_error=1",
                                ASAN_OPTIONS="detect_leaks=1"))
    assert r.returncode == 0, f"sanitized run failed:\n{r.stdout}\n{r.stderr}"
    assert r.stdout.count("SANITIZED_OK") == 2


JPEG_MAIN = r"""
#include <cstdio>
#include <string>
#include <vector>
extern "C" {
int cge_jpeg_info(const unsigned char*, long, int*, char*, int);
int cge_jpeg_decode(const unsigned char*, long, unsigned char*, long, char*,
                    int);
}
// Each file whole, then cut at eight lengths and with bytes flipped: a
// whole file must decode; a damaged one may decode or fail, never fault.
static int run(const std::vector<unsigned char>& d, bool whole) {
    int info[3] = {0, 0, 0};
    char err[256];
    if (cge_jpeg_info(d.data(), (long)d.size(), info, err, 256))
        return whole ? 1 : 0;
    std::vector<unsigned char> rgb((size_t)info[0] * info[1] * info[2]);
    int rc = cge_jpeg_decode(d.data(), (long)d.size(), rgb.data(),
                             (long)rgb.size(), err, 256);
    return whole && rc ? 1 : 0;
}
int main(int argc, char** argv) {
    bool refused = false;  // files after --refused may fail whole too
    for (int i = 1; i < argc; ++i) {
        if (std::string(argv[i]) == "--refused") {
            refused = true;
            continue;
        }
        FILE* f = std::fopen(argv[i], "rb");
        if (!f) return 2;
        std::vector<unsigned char> d;
        int c;
        while ((c = std::fgetc(f)) != EOF) d.push_back((unsigned char)c);
        std::fclose(f);
        if (run(d, !refused)) {
            std::fprintf(stderr, "%s\n", argv[i]);
            return 1;
        }
        for (int k = 1; k <= 8; ++k) {
            std::vector<unsigned char> cut(d.begin(),
                                           d.begin() + d.size() * k / 9);
            run(cut, false);
            std::vector<unsigned char> flip = d;
            for (size_t j = d.size() * k / 9; j < d.size(); j += 97)
                flip[j] ^= (unsigned char)(0x5A + k);
            run(flip, false);
        }
        std::printf("SANITIZED_OK %s\n", argv[i]);
    }
    return 0;
}
"""


def _sanitized_jpeg_main(tmp_path):
    """cge_jpeg.cpp with the library's flags plus -fsanitize=address,
    undefined at -O0, linked to JPEG_MAIN."""
    main = tmp_path / "main.cpp"
    main.write_text(JPEG_MAIN)
    exe = tmp_path / "san"
    flags = [f for f in native.CXXFLAGS if f not in ("-fPIC", "-O2")]
    subprocess.run([native.CXX, "-O0", *flags, "-g",
                    "-fno-omit-frame-pointer",
                    "-fsanitize=address,undefined", native.JPEG_SOURCE,
                    str(main), "-o", str(exe)], check=True, timeout=300,
                   capture_output=True)
    return exe


def _run_sanitized(exe, files):
    r = subprocess.run([str(exe), *files], capture_output=True, text=True,
                       timeout=300,
                       env=dict(os.environ, UBSAN_OPTIONS="halt_on_error=1",
                                ASAN_OPTIONS="detect_leaks=1"))
    assert r.returncode == 0, f"sanitized run failed:\n{r.stdout}\n{r.stderr}"
    assert r.stdout.count("SANITIZED_OK") == len(
        [f for f in files if f != "--refused"])


@pytest.fixture(scope="module")
def jpeg_san(tmp_path_factory):
    return _sanitized_jpeg_main(tmp_path_factory.mktemp("jpeg_san"))


def test_jpeg_decoder_under_asan_ubsan(jpeg_san):
    """cge_jpeg.cpp with the library's flags plus
    -fsanitize=address,undefined at -O0, linked to a main program that
    decodes every small JPEG fixture (tests/torch_textures/) whole, cut
    short at eight lengths and with bytes flipped: whole files decode,
    damaged ones decode or fail with a message, and none faults."""
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "torch_textures")
    files = sorted(os.path.join(fixtures, f) for f in os.listdir(fixtures)
                   if f.endswith(".jpg") and "1024" not in f)
    assert len(files) >= 16
    _run_sanitized(jpeg_san, files)


def _variant_jpegs(group):
    """Files written here through libjpeg (make_textures.jpeg_encode) for
    one group of the JPEG decoder's paths."""
    rng = np.random.default_rng(len(group))
    px = make_textures.smooth_image(rng, 37, 29, 20.0)
    cmyk = make_textures.cmyk_of(px)
    if group == "upsampling":
        return [make_textures.jpeg_encode(img, sampling=s)
                for s in make_textures.SAMPLINGS.values()
                for img in (px, px[:2, :3], px[:1], px[:, :1])]
    if group == "ycck":
        return [make_textures.jpeg_encode(cmyk, colorspace="ycck", **kw)
                for kw in (dict(), dict(adobe=False), dict(
                    sampling=[(1, 2), (1, 1), (1, 1), (1, 2)]))]
    if group == "arithmetic":
        return [make_textures.jpeg_encode(px, arithmetic=True, **kw)
                for kw in (dict(), dict(progressive=True, restart=2),
                           dict(conditioning={0: (3, 9, 2)}),
                           dict(sampling=[(2, 2), (1, 1), (1, 1)]))]
    if group == "smoothing":
        return [make_textures.jpeg_encode(px, scans=sc, arithmetic=a)
                for sc in make_textures.SMOOTH_SCANS.values()
                for a in (False, True)]
    if group == "no_eoi":
        # no EOI: the cut copies JPEG_MAIN makes end inside the scan data,
        # where the bit buffer reads ahead; the whole files decode
        out = []
        for kw in (dict(), dict(restart=2), dict(sampling=[(1, 1)] * 3)):
            data = make_textures.jpeg_encode(px, **kw)[:-2]
            out += [data + bytes(i % 250 + 1 for i in range(k))
                    for k in (40, 300)]
        return out
    if group == "lossless":
        sub = [px[..., 0], px[::2, ::2, 1], px[::2, ::2, 2]]
        return [make_textures.jpeg_encode(img, lossless=(p, p % 3),
                                          restart_rows=p % 2)
                for p in range(1, 8) for img in (px[..., :1], px, cmyk)] + [
            make_textures.lossless_jpeg(sub, [(2, 2), (1, 1), (1, 1)], p,
                                        0, p % 2) for p in (1, 4, 7)]
    return [make_textures.jpeg_refused(c) for c in make_textures.JPEG_REFUSED
            if c != "arithmetic_64k"]


@pytest.mark.parametrize("group", ["upsampling", "ycck", "arithmetic",
                                   "smoothing", "lossless", "refused",
                                   "no_eoi"])
def test_jpeg_variants_under_asan_ubsan(tmp_path, jpeg_san, group):
    """The JPEG decoder's new paths under ASan and UBSan, each file whole,
    cut short at eight lengths and with bytes flipped (JPEG_MAIN): every
    sampling's upsampler, YCCK, arithmetic coding with restarts and DAC,
    block smoothing under both codings, lossless at each predictor, the
    files Pillow refuses (which may fail, never fault), and files without
    their EOI (the bit buffer's read-ahead to the end of the data)."""
    files = []
    for i, data in enumerate(_variant_jpegs(group)):
        path = tmp_path / f"{group}_{i}.jpg"
        path.write_bytes(data)
        files.append(str(path))
    if group == "refused":
        # whole files raise, as in Pillow: decoded as damaged ones
        for f in files:
            with pytest.raises(ValueError):
                jpeg.decode_jpeg(open(f, "rb").read())
        files.insert(0, "--refused")
    _run_sanitized(jpeg_san, files)


IMAGES_SCRIPT = r"""
import hashlib, json, os, sys
sys.path.insert(0, sys.argv[1])
from cge_tpu_torch import native
from cge_tpu_torch.scene import image_io

build_dir, fixtures = sys.argv[2], sys.argv[3]
flags = tuple(f for f in native.CXXFLAGS if f != "-O2") + (
    "-O0", "-g", "-fno-omit-frame-pointer", "-fsanitize=address,undefined")
native._LIBRARY = native.build(flags=flags, build_dir=build_dir)
native.MAX_PIXELS = 1 << 20          # flipped sizes allocate little here
manifest = {f["name"]: f for f in json.load(
    open(os.path.join(fixtures, "manifest.json")))["files"]}
for name in sys.argv[4:]:
    data = open(os.path.join(fixtures, name), "rb").read()
    rgb = image_io.decode_image(data)
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == \
        manifest[name]["sha256"], name
    for k in range(1, 9):
        flip = bytearray(data)
        for j in range(len(data) * k // 9, len(data), 97):
            flip[j] ^= 0x5A + k
        for damaged in (data[:len(data) * k // 9], bytes(flip)):
            try:
                image_io.decode_image(damaged)
            except ValueError:
                pass
    print("SANITIZED_OK", name, flush=True)
"""


def test_image_decoders_under_asan_ubsan(tmp_path):
    """The library built with its flags plus -fsanitize=address,undefined
    at -O0 and loaded into a Python with ASan preloaded (and every Python
    object in malloc's memory, so that ASan fences each file's bytes):
    every small TGA, GIF, PSD, PNG, TIFF, WebP, DDS, SGI, PCX, DCX, QOI,
    ICO, CUR, BLP, FTEX, Sun raster, JPEG 2000 and ICNS fixture
    (tests/torch_textures/; the TIFF LZW and predictors, the VP8, VP8L and
    ALPH bit readers, the BC6H and BC7 bit readers and partition tables of
    cge_bcn_decode, the SGI, PCX, Sun and ICNS run-length rows and the QOI
    op stream of cge_raster.cpp, and the JPEG 2000 codestreams of
    cge_j2k.cpp among the entries) decodes whole to its manifest
    hash, then cut short at eight lengths and with bytes flipped; a
    damaged file decodes or raises a ValueError, and nothing faults (UBSan
    halts on its first report)."""
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "torch_textures")
    names = sorted(f for f in os.listdir(fixtures)
                   if f.split(".")[-1] in ("tga", "gif", "psd", "png", "tif",
                                           "webp", "dds", "sgi", "bw", "pcx",
                                           "dcx", "qoi", "ico", "cur", "blp",
                                           "ftc", "ftu", "ras", "j2k", "jp2",
                                           "icns")
                   and os.path.getsize(os.path.join(fixtures, f)) < 20000)
    assert len(names) >= 80
    assert sum(f.endswith(".tif") for f in names) >= 250
    assert sum(f.endswith(".webp") for f in names) >= 40
    assert sum(f.endswith(".dds") for f in names) >= 60
    assert sum(f.endswith((".sgi", ".bw", ".pcx", ".dcx", ".qoi", ".ras"))
               for f in names) >= 19
    assert sum(f.endswith((".j2k", ".jp2", ".icns")) for f in names) >= 50
    # ASan first; libstdc++ loaded with it, or ASan cannot intercept the
    # decoders' C++ exceptions
    preload = " ".join(subprocess.run(
        [native.CXX, f"-print-file-name={lib}"], capture_output=True,
        text=True, check=True).stdout.strip()
        for lib in ("libasan.so", "libstdc++.so.6"))
    script = tmp_path / "images.py"
    script.write_text(IMAGES_SCRIPT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, str(script), repo, str(tmp_path / "build"),
         fixtures, *names], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, LD_PRELOAD=preload, PYTHONMALLOC="malloc",
                 ASAN_OPTIONS="detect_leaks=0",
                 UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1"))
    assert r.returncode == 0, f"sanitized run failed:\n{r.stdout}\n{r.stderr}"
    assert r.stdout.count("SANITIZED_OK") == len(names)


def test_tail_decoders_under_asan_ubsan(tmp_path):
    """The sanitized library of test_image_decoders_under_asan_ubsan over
    every fixture of tests/torch_textures/pillow_tail/: the ThunderScan rows
    of cge_raster.cpp, the Part 2 marker readers of cge_j2k.cpp and the raw
    data of cge_jpeg.cpp under libtiff's old-style JPEG source among the
    entries, each whole, cut short at eight lengths and with bytes flipped;
    nothing faults."""
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "torch_textures", "pillow_tail")
    names = sorted(f for f in os.listdir(fixtures) if f != "manifest.json")
    assert len(names) >= 30
    preload = " ".join(subprocess.run(
        [native.CXX, f"-print-file-name={lib}"], capture_output=True,
        text=True, check=True).stdout.strip()
        for lib in ("libasan.so", "libstdc++.so.6"))
    script = tmp_path / "images.py"
    script.write_text(IMAGES_SCRIPT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, str(script), repo, str(tmp_path / "build"),
         fixtures, *names], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, LD_PRELOAD=preload, PYTHONMALLOC="malloc",
                 ASAN_OPTIONS="detect_leaks=0",
                 UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1"))
    assert r.returncode == 0, f"sanitized run failed:\n{r.stdout}\n{r.stderr}"
    assert r.stdout.count("SANITIZED_OK") == len(names)


def test_x11_and_fault_decoders_under_asan_ubsan(tmp_path):
    """The sanitized library of test_image_decoders_under_asan_ubsan over
    every fixture of tests/torch_textures/x11_pnm/: XBM's hex bytes of
    cge_raster.cpp, and cge_jpeg.cpp's bit buffer as libjpeg fills it
    (JPEGs without their EOI, whose cut copies end inside the scan data)
    and its header rules (standard Huffman tables, 16-bit DQT entries, an
    unused table's all-ones code), each whole, cut short at eight lengths
    and with bytes flipped; nothing faults."""
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "torch_textures", "x11_pnm")
    names = sorted(f for f in os.listdir(fixtures) if f != "manifest.json")
    assert len(names) >= 30
    assert sum(f.endswith(".jpg") for f in names) >= 6
    preload = " ".join(subprocess.run(
        [native.CXX, f"-print-file-name={lib}"], capture_output=True,
        text=True, check=True).stdout.strip()
        for lib in ("libasan.so", "libstdc++.so.6"))
    script = tmp_path / "images.py"
    script.write_text(IMAGES_SCRIPT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, str(script), repo, str(tmp_path / "build"),
         fixtures, *names], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, LD_PRELOAD=preload, PYTHONMALLOC="malloc",
                 ASAN_OPTIONS="detect_leaks=0",
                 UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1"))
    assert r.returncode == 0, f"sanitized run failed:\n{r.stdout}\n{r.stderr}"
    assert r.stdout.count("SANITIZED_OK") == len(names)


def test_legacy_decoders_under_asan_ubsan(tmp_path):
    """The sanitized library of test_image_decoders_under_asan_ubsan over
    the FLI / FLC and Windows Paint fixtures of tests/torch_textures/legacy/
    that JAX decodes: cge_raster.cpp's FLI frame chunks (BRUN, LC, SS2,
    COPY, BLACK) and MSP run-length rows, each whole, cut short at eight
    lengths and with bytes flipped; nothing faults."""
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "torch_textures", "legacy")
    with open(os.path.join(fixtures, "manifest.json")) as f:
        names = sorted(e["name"] for e in json.load(f)["files"]
                       if e["kind"] in ("fli", "msp"))
    assert len(names) >= 12
    preload = " ".join(subprocess.run(
        [native.CXX, f"-print-file-name={lib}"], capture_output=True,
        text=True, check=True).stdout.strip()
        for lib in ("libasan.so", "libstdc++.so.6"))
    script = tmp_path / "images.py"
    script.write_text(IMAGES_SCRIPT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, str(script), repo, str(tmp_path / "build"),
         fixtures, *names], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, LD_PRELOAD=preload, PYTHONMALLOC="malloc",
                 ASAN_OPTIONS="detect_leaks=0",
                 UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1"))
    assert r.returncode == 0, f"sanitized run failed:\n{r.stdout}\n{r.stderr}"
    assert r.stdout.count("SANITIZED_OK") == len(names)


def test_im_bit_decoder_under_asan_ubsan(tmp_path):
    """The sanitized library of test_image_decoders_under_asan_ubsan over
    the IM fixtures of tests/torch_textures/science/ that go through
    cge_raster.cpp's bit decoder (F;3, F;12, F;24, F;31: IM's packed
    samples, the leftover bits carried into the next row, more than 32
    buffered bits), each whole, cut short at eight lengths and with bytes
    flipped; nothing faults."""
    import re

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "torch_textures", "science")
    with open(os.path.join(fixtures, "manifest.json")) as f:
        names = sorted(e["name"] for e in json.load(f)["files"]
                       if e["kind"] == "im"
                       and re.fullmatch(r"im_F_\d+_\d+x\d+\.im", e["name"])
                       and e["name"].split("_")[2] not in ("8", "16", "32"))
    assert len(names) == 4
    preload = " ".join(subprocess.run(
        [native.CXX, f"-print-file-name={lib}"], capture_output=True,
        text=True, check=True).stdout.strip()
        for lib in ("libasan.so", "libstdc++.so.6"))
    script = tmp_path / "images.py"
    script.write_text(IMAGES_SCRIPT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, str(script), repo, str(tmp_path / "build"),
         fixtures, *names], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, LD_PRELOAD=preload, PYTHONMALLOC="malloc",
                 ASAN_OPTIONS="detect_leaks=0",
                 UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1"))
    assert r.returncode == 0, f"sanitized run failed:\n{r.stdout}\n{r.stderr}"
    assert r.stdout.count("SANITIZED_OK") == len(names)


CODECS_SCRIPT = r"""
import ctypes, io, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from cge_tpu_torch import native
from jax_references import make_textures
from PIL import Image
import zstandard

flags = tuple(f for f in native.CXXFLAGS if f != "-O2") + (
    "-O0", "-g", "-fno-omit-frame-pointer", "-fsanitize=address,undefined")
lib = native.build(flags=flags, build_dir=sys.argv[2])
err = ctypes.create_string_buffer(512)


def exact(b):
    # a buffer of exactly len(b) bytes, so that ASan sees a read past it
    return (ctypes.c_char * max(1, len(b))).from_buffer_copy(b or b"\0")


def damaged(data, rng):
    yield data
    for k in range(1, 9):
        yield data[:len(data) * k // 9]
        flip = bytearray(data)
        for j in rng.integers(0, len(data), 1 + k // 3):
            flip[j] ^= int(rng.integers(1, 256))
        yield bytes(flip)


rng = np.random.default_rng(9)
counts = {"zstd": 0, "fax": 0, "jpeg": 0, "ok": 0}
sources = [bytes(rng.integers(0, 256, 3000, dtype=np.uint8)), bytes(40000),
           np.repeat(rng.integers(0, 8, 30000).astype(np.uint8), 5)
           .tobytes(), (b"\xff" + bytes(20)) * 3000]
for src in sources:
    for level in (1, 3, 19):
        frame = zstandard.ZstdCompressor(level=level).compress(src)
        for d in damaged(frame, rng):
            for size in (len(src), len(src) + 7):
                out = np.empty(size, np.uint8)
                st = np.zeros(25, np.int64)
                rc = lib.cge_zstd_decode(exact(d), len(d), out.ctypes.data,
                                         size, st.ctypes.data, err, 512)
                counts["zstd"] += 1
                counts["ok"] += rc == 0
runs = make_textures.zstd_runs_frame(bytes(300) + b"abc" * 50 + bytes(9))
for d in damaged(runs, rng):
    out = np.empty(459, np.uint8)
    lib.cge_zstd_decode(exact(d), len(d), out.ctypes.data, 459, None, err,
                        512)
for comp, num, info in (("tiff_ccitt", 2, {}), ("group3", 3, {292: 0}),
                        ("group3", 3, {292: 1}), ("group3", 3, {292: 5}),
                        ("group4", 4, {})):
    for h, w in ((17, 45), (3, 2700), (9, 7)):
        bw = np.repeat(rng.random((h, -(-w // 3))) < 0.4, 3, 1)[:, :w]
        strip = make_textures.pillow_strip(Image.fromarray(bw), comp, info)
        for d in damaged(strip, rng):
            out = np.empty((h, (w + 7) // 8), np.uint8)
            starts = np.zeros(1, np.int_)
            sizes = np.array([len(d)], np.int_)
            rows = np.array([h], np.intc)
            lib.cge_fax_decode(exact(d), starts.ctypes.data,
                               sizes.ctypes.data, 1, num, info.get(292, 0),
                               w, rows.ctypes.data, out.ctypes.data, None,
                               err, 512)
            counts["fax"] += 1
img = make_textures.smooth_image(rng, 37, 29, 14.0)
for photo, sub, src in ((1, 0, img[..., :1]), (2, 0, img), (6, 1, img),
                        (6, 2, img), (5, 0, np.concatenate(
                            [img, img[..., :1]], -1))):
    mode = {1: "L", 2: "RGB", 5: "CMYK", 6: "RGB"}[photo]
    im = Image.fromarray(src[..., 0] if mode == "L" else src,
                         "CMYK" if mode == "CMYK" else None)
    jpeg = make_textures._pillow(im, "JPEG", quality=70, subsampling=sub,
                                 restart_marker_blocks=2)
    tables, stream = make_textures.jpeg_split(jpeg)
    color = 1 if photo == 6 else 0
    for t in damaged(tables, rng):
        for d in damaged(stream, rng):
            info = np.zeros(6, np.intc)
            if lib.cge_jpeg_tiff_info(exact(t), len(t), exact(d), len(d),
                                      color, info.ctypes.data, err, 512):
                continue
            n = int(info[0]) * int(info[1]) * (3 if color else int(info[2]))
            if n > 1 << 22:
                continue
            out = np.empty(max(n, 1), np.uint8)
            lib.cge_jpeg_tiff_decode(exact(t), len(t), exact(d), len(d),
                                     color, out.ctypes.data, n, err, 512)
            counts["jpeg"] += 1
print("SANITIZED_OK", counts, flush=True)
"""


def test_zstd_fax_and_jpeg_tiff_under_asan_ubsan(tmp_path):
    """cge_zstd.cpp, cge_fax.cpp and the JPEG-in-TIFF entry points of
    cge_image.cpp built with -fsanitize=address,undefined at -O0, in a
    Python with ASan preloaded, each input in a buffer of exactly its size:
    ZSTD frames of libzstd's at levels 1, 3 and 19 (raw, RLE and
    compressed blocks, every literal and sequence mode among them) and a
    frame of RLE literals, CCITT strips of Pillow's (RLE, Group 3 1D, 2D
    and with fill bits, Group 4; a 2700-pixel row among them), and JPEG
    tables and abbreviated streams (grey, RGB, CMYK, YCbCr 2x1 and 2x2,
    restart markers), each whole, cut at eight lengths and with bytes
    flipped: every call returns, whole inputs decode, and nothing faults
    (UBSan halts on its first report)."""
    preload = " ".join(subprocess.run(
        [native.CXX, f"-print-file-name={lib}"], capture_output=True,
        text=True, check=True).stdout.strip()
        for lib in ("libasan.so", "libstdc++.so.6"))
    script = tmp_path / "codecs.py"
    script.write_text(CODECS_SCRIPT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, str(script), repo, str(tmp_path / "build")],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, LD_PRELOAD=preload, PYTHONMALLOC="malloc",
                 ASAN_OPTIONS="detect_leaks=0",
                 UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1"))
    assert r.returncode == 0, f"sanitized run failed:\n{r.stdout}\n{r.stderr}"
    assert "SANITIZED_OK" in r.stdout
