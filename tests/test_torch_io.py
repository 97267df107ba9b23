"""The port's host IO against the JAX package on the CPU: the native
library (``runtime/native``: the f32 / f64 scanners, the threaded batch
parse, the kd partition), ``data/pcd_io``, the kd build's partition route
at D = 3 and 6, ``runtime/prefetch``, ``data/ply_io``, ``data/binary_io``
and ``data/tum``.

The JAX package's native route is its ctypes wrapper over
``native/icpio.cpp``. Whether its own ``native/libicpio.so`` loads in a
test worker depends on the build race between workers (a worker that
loses it falls back to numpy), so these tests pin that route: JAX's
wrapper runs over the library the port builds from the same unchanged
source with ``native/Makefile``'s flags (the ``jax_native`` fixture).

Tolerances: every comparison is exact (bit for bit), except the numpy
plain reference of the ASCII scanner, which parses in float64 and casts:
equal to the f32 scan on values written as ``%.7g``.
"""

import os

import numpy as np
import pytest
import torch

from icp_variants_tpu.data import binary_io as jbin
from icp_variants_tpu.data import pcd_io as jpcd
from icp_variants_tpu.data import ply_io as jply
from icp_variants_tpu.data import tum as jtum
from icp_variants_tpu.ops import kdtree as jkd
from icp_variants_tpu.runtime import native as jnative
from icp_variants_tpu.runtime import prefetch as jprefetch
from icp_variants_tpu_torch.data import binary_io as tbin
from icp_variants_tpu_torch.data import pcd_io as tpcd
from icp_variants_tpu_torch.data import ply_io as tply
from icp_variants_tpu_torch.data import tum as ttum
from icp_variants_tpu_torch.ops import kdtree as tkd
from icp_variants_tpu_torch.runtime import native as tnative
from icp_variants_tpu_torch.runtime.prefetch import Prefetcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_native(monkeypatch):
    """Pin the JAX package's native route to the library built from the
    same source (see the module docstring)."""
    monkeypatch.setattr(jnative, "_lib", tnative.load())
    monkeypatch.setattr(jnative, "_load_failed", False)
    return jnative


def _ascii_body_np(path, body_offset):
    """The plain reference of the native scanner: numpy's float64 parse of
    an ASCII body."""
    with open(path, "rb") as f:
        f.seek(body_offset)
        text = f.read().decode("ascii", errors="replace")
    return np.array(text.split(), dtype=np.float64)


def _float_cloud(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 3, (n, 3)).astype(np.float32)


def _integer_cloud(n, seed):
    """Coordinates 0-11: many ties at every split plane."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 12, (n, 3)).astype(np.float32)


def test_native_builds_outside_native_dir():
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    tnative.load()
    assert tnative.available()
    assert tnative.LIB_PATH.exists()
    assert tnative.LIB_PATH.parent == tnative.BUILD_DIR
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails is reported with its message; nothing falls
    back to numpy."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "LIB_PATH", tmp_path / "libicpio.so")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="failed"):
        tnative.load()
    assert not (tmp_path / "libicpio.so").exists()


def test_native_concurrent_builds_load_one_whole_library(tmp_path):
    """Six processes started together build into one empty directory: one
    compiles under the file lock, the rest wait and load the renamed
    library; all partition alike and no temporary file is left."""
    import subprocess
    import sys

    code = (
        "import sys, pathlib, numpy as np\n"
        "from icp_variants_tpu_torch.runtime import native as n\n"
        "n.BUILD_DIR = pathlib.Path(sys.argv[1]); n.LIB_PATH = n.BUILD_DIR / 'libicpio.so'\n"
        "pts = np.random.default_rng(0).normal(0, 1, (2000, 3)).astype(np.float32)\n"
        "print(int(n.kd_partition(pts, 5)[0][:64].sum()))\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "b")], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert len({o[0] for o in outs}) == 1
    assert sorted(os.listdir(tmp_path / "b")) == ["libicpio.lock", "libicpio.so"]


@pytest.mark.parametrize("binary", [True, False])
def test_write_pcd_matches_jax_bytes(tmp_path, binary):
    pts = _float_cloud(500, 1)
    jpcd.write_pcd(str(tmp_path / "j.pcd"), pts, binary=binary)
    tpcd.write_pcd(str(tmp_path / "t.pcd"), pts, binary=binary)
    assert (tmp_path / "j.pcd").read_bytes() == (tmp_path / "t.pcd").read_bytes()


@pytest.mark.parametrize("binary", [True, False])
def test_read_pcd_matches_jax(tmp_path, jax_native, binary):
    pts = _float_cloud(3000, 2)
    path = str(tmp_path / "c.pcd")
    jpcd.write_pcd(path, pts, binary=binary)
    got, want = tpcd.read_pcd(path), jpcd.read_pcd(path)
    assert got.dtype == np.float32 and got.shape == (3000, 3)
    np.testing.assert_array_equal(got, want)
    if binary:
        np.testing.assert_array_equal(got, pts)
    else:
        # The numpy plain reference of the scanner (float64, cast).
        header, off = tpcd._read_header(path)
        ref = tpcd._ascii_xyz(_ascii_body_np(path, off), header)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got, pts, rtol=1e-6, atol=1e-6)
    assert tpcd.read_pcd_point_count(path) == jpcd.read_pcd_point_count(path) == 3000


def _write_multifield(path, binary, n=200, seed=3):
    """A float64 intensity before x y z and a two-count uint16 field after
    them: the reader must pick x, y, z out of any layout."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, 1, (n, 3)).astype(np.float32)
    inten = rng.uniform(0, 1, n).astype(np.float64)
    extra = rng.integers(0, 100, (n, 2)).astype(np.uint16)
    header = ("VERSION 0.7\nFIELDS intensity x y z extra\nSIZE 8 4 4 4 2\nTYPE F F F F U\n"
              f"COUNT 1 1 1 1 2\nWIDTH {n}\nHEIGHT 1\nPOINTS {n}\n"
              f"DATA {'binary' if binary else 'ascii'}\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            rec = np.empty(n, dtype=[("i", "<f8"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                     ("e", "<u2", (2,))])
            rec["i"], rec["x"], rec["y"], rec["z"], rec["e"] = inten, *xyz.T, extra
            f.write(rec.tobytes())
        else:
            for k in range(n):
                f.write(f"{inten[k]:.9g} {xyz[k, 0]:.9g} {xyz[k, 1]:.9g} {xyz[k, 2]:.9g} "
                        f"{extra[k, 0]} {extra[k, 1]}\n".encode())
    return xyz


@pytest.mark.parametrize("binary", [True, False])
def test_read_pcd_field_layouts_match_jax(tmp_path, jax_native, binary):
    path = str(tmp_path / "m.pcd")
    xyz = _write_multifield(path, binary)
    got = tpcd.read_pcd(path)
    np.testing.assert_array_equal(got, jpcd.read_pcd(path))
    np.testing.assert_array_equal(got, xyz)


def test_read_pcd_batch_matches_jax_and_single_reads(tmp_path, jax_native):
    paths = []
    for i in range(5):
        p = str(tmp_path / f"s{i}.pcd")
        tpcd.write_pcd(p, _float_cloud(700 + 50 * i, 10 + i), binary=i % 2 == 0)
        paths.append(p)
    mp = str(tmp_path / "multi.pcd")
    _write_multifield(mp, False)
    paths.append(mp)
    got = tpcd.read_pcd_batch(paths, n_threads=3)
    want = jpcd.read_pcd_batch(paths, n_threads=3)
    for g, w, p in zip(got, want, paths):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, tpcd.read_pcd(p))


def test_pcd_errors(tmp_path):
    bad = tmp_path / "trunc.pcd"
    bad.write_bytes(b"VERSION 0.7\nFIELDS x y z\n")
    with pytest.raises(ValueError, match="EOF"):
        tpcd.read_pcd(str(bad))
    with pytest.raises(ValueError, match="EOF"):
        tpcd.read_pcd_point_count(str(bad))
    short = tmp_path / "short.pcd"
    short.write_bytes(b"FIELDS x y z\nCOUNT 1 1 1\nPOINTS 3\nDATA ascii\n1 2 3\n4 5 6\n")
    with pytest.raises(ValueError, match="header says 9"):
        tpcd.read_pcd(str(short))
    with pytest.raises(IOError):
        tnative.parse_floats(str(tmp_path / "missing"), 0, 3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_parse_matches_jax_and_numpy(tmp_path, jax_native, dtype):
    rng = np.random.default_rng(4)
    vals = rng.normal(0, 100, 5000)
    path = tmp_path / "v.txt"
    path.write_text("head\n" + "\n".join(f"{v:.17g}" for v in vals) + "\n")
    got = tnative.parse_floats(str(path), 5, 6000, dtype=dtype)
    np.testing.assert_array_equal(got, jnative.parse_floats(str(path), 5, 6000, dtype=dtype))
    np.testing.assert_array_equal(got, vals.astype(dtype))
    specs = [(str(path), 5, 100), (str(path), 5, 6000)]
    batch = tnative.parse_floats_f32_batch(specs, n_threads=2)
    for b, j in zip(batch, jnative.parse_floats_f32_batch(specs, n_threads=2)):
        np.testing.assert_array_equal(b, j)
    np.testing.assert_array_equal(batch[0], vals[:100].astype(np.float32))


@pytest.mark.parametrize("cloud", ["float", "integer"])
@pytest.mark.parametrize("depth", [1, 4, 7])
def test_kd_partition_matches_jax(jax_native, cloud, depth):
    """The native partition equals JAX's native route (perm and blocks),
    and the numpy one JAX's numpy one."""
    pts = (_float_cloud if cloud == "float" else _integer_cloud)(4800, 5 + depth)
    perm, blocks = tnative.kd_partition(pts, depth)
    jperm, jblocks = jnative.kd_partition(pts, depth)
    np.testing.assert_array_equal(perm, jperm)
    assert blocks == jblocks
    nperm, nblocks = tkd.kd_partition_np(pts, depth)
    jnp_perm, jnp_blocks = jkd.kd_partition_np(pts, depth)
    np.testing.assert_array_equal(nperm, jnp_perm)
    assert nblocks == jnp_blocks == blocks          # equal-count halves either way
    assert sorted(perm.tolist()) == list(range(len(pts)))


@pytest.mark.parametrize("cloud", ["float", "integer"])
def test_build_kd_index_d3_is_jax_native_route(jax_native, cloud):
    """At D = 3 the port's index equals the JAX package's native-route index
    field for field (perm, hence pages and block_orig, in the same order);
    on tied integer clouds the numpy route differs, so the route matters."""
    pts = (_float_cloud if cloud == "float" else _integer_cloud)(4800, 7)
    pts = np.concatenate([pts, np.full((64, 3), 2.0e6, np.float32)])   # padded rows
    tidx = tkd.build_kd_index(pts, block_target=256, device="cpu")
    jidx = jkd.build_kd_index(pts, block_target=256)
    for name in ("block_pts", "block_orig", "block_min", "block_max", "pages", "page_orig",
                 "pages_packed"):
        np.testing.assert_array_equal(getattr(tidx, name).numpy(), np.asarray(getattr(jidx, name)),
                                      err_msg=name)
    if cloud == "integer":
        rows = np.flatnonzero(np.abs(pts).max(1) < 1e5)
        depth = tkd.kd_depth_for(len(pts), 256)
        nperm, _ = tkd.kd_partition_np(pts[rows], depth)
        perm, _ = tnative.kd_partition(pts[rows], depth)
        assert not np.array_equal(nperm, perm)


def test_build_kd_index_d6_keeps_numpy_route(jax_native, monkeypatch):
    """At D = 6 both packages partition with numpy (the native splitter
    reads xyz only); the port never calls the native partition there."""
    rng = np.random.default_rng(8)
    feats = np.concatenate([_integer_cloud(3000, 9), rng.uniform(0, 1, (3000, 3))],
                           axis=1).astype(np.float32)
    calls = []
    monkeypatch.setattr(tnative, "kd_partition", lambda *a: calls.append(a))
    tidx = tkd.build_kd_index(feats, block_target=256, device="cpu")
    jidx = jkd.build_kd_index(feats, block_target=256)
    assert calls == []
    np.testing.assert_array_equal(tidx.block_orig.numpy(), np.asarray(jidx.block_orig))
    np.testing.assert_array_equal(tidx.pages.numpy(), np.asarray(jidx.pages))


def test_prefetcher_order_and_reraise():
    def fn(x):
        if x == 3:
            raise KeyError("three")
        return x * 10

    for cls in (Prefetcher, jprefetch.Prefetcher):
        it = cls(range(6), fn, depth=2)
        out = [next(it), next(it), next(it)]
        with pytest.raises(KeyError, match="three"):
            next(it)
        out += list(it)
        assert out == [0, 10, 20, 40, 50]
        with pytest.raises(StopIteration):
            next(it)
        with pytest.raises(StopIteration):
            next(it)
        it._thread.join(timeout=10)
        assert not it._thread.is_alive()


def test_prefetcher_cpu_device_has_no_stream():
    it = Prefetcher([torch.ones(2)], lambda t: (t * 2, {"x": t}), device="cpu")
    value, extra = next(it)
    assert it._stream is None and torch.equal(value, torch.full((2,), 2.0))
    assert list(it) == []


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("fields", ["points", "all"])
def test_ply_round_trip_matches_jax(tmp_path, binary, fields):
    rng = np.random.default_rng(12)
    n = 300
    kw = dict(points=rng.normal(0, 1, (n, 3)).astype(np.float32))
    if fields == "all":
        kw.update(normals=rng.normal(0, 1, (n, 3)).astype(np.float32),
                  colors=rng.integers(0, 256, (n, 3)).astype(np.uint8),
                  intensity=rng.uniform(0, 1, n).astype(np.float32))
    tply.write_ply(str(tmp_path / "t.ply"), binary=binary, **kw)
    jply.write_ply(str(tmp_path / "j.ply"), binary=binary, **kw)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    got, want = tply.read_ply(str(tmp_path / "j.ply")), jply.read_ply(str(tmp_path / "t.ply"))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    if binary:
        for k in kw:
            np.testing.assert_array_equal(got[k], kw[k])


@pytest.mark.parametrize("double", [False, True])
def test_binary_cloud_round_trip_matches_jax(tmp_path, double):
    rng = np.random.default_rng(13)
    pts = rng.normal(0, 1, (250, 3))
    nrm = rng.normal(0, 1, (250, 3))
    tbin.write_binary_cloud(str(tmp_path / "t.bin"), pts, nrm, double=double)
    jbin.write_binary_cloud(str(tmp_path / "j.bin"), pts, nrm, double=double)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    for a, b in zip(tbin.read_binary_cloud(str(tmp_path / "j.bin")),
                    jbin.read_binary_cloud(str(tmp_path / "t.bin"))):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _write_tum(root, n_frames=3, h=24, w=32):
    from PIL import Image

    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    rng = np.random.default_rng(14)
    lines = {"depth.txt": [], "rgb.txt": [], "groundtruth.txt": []}
    for i in range(n_frames):
        ts = 10.0 + 0.1 * i
        depth = rng.integers(0, 20000, (h, w)).astype(np.uint16)
        depth[0, :5] = 0
        Image.fromarray(depth).save(os.path.join(root, f"depth/{i}.png"))
        mode = "RGBA" if i % 2 else "RGB"
        rgb = rng.integers(0, 256, (h, w, len(mode)), dtype=np.uint8)
        Image.fromarray(rgb, mode).save(os.path.join(root, f"rgb/{i}.png"))
        lines["depth.txt"].append(f"{ts} depth/{i}.png")
        lines["rgb.txt"].append(f"{ts + 0.01} rgb/{i}.png")
        q = rng.normal(0, 1, 4)
        lines["groundtruth.txt"].append(
            f"{ts + 0.003} {0.1 * i} {-0.2 * i} 0.3 {q[0]} {q[1]} {q[2]} {q[3]}")
    for name, rows in lines.items():
        with open(os.path.join(root, name), "w") as f:
            f.write("# a\n# b\n# c\n" + "\n".join(rows) + "\n")


def test_virtual_sensor_matches_jax(tmp_path):
    _write_tum(str(tmp_path))
    t = ttum.VirtualSensor(str(tmp_path), increment=2, width=32, height=24)
    j = jtum.VirtualSensor(str(tmp_path), increment=2, width=32, height=24)
    assert len(t) == len(j) == 3
    np.testing.assert_array_equal(t.intrinsics, j.intrinsics)
    np.testing.assert_array_equal(t.trajectory, j.trajectory)
    np.testing.assert_array_equal(ttum.default_intrinsics(), jtum.default_intrinsics())
    for _ in range(3):
        tf, jf = t.process_next_frame(), j.process_next_frame()
        if jf is None:
            assert tf is None
            break
        assert tf.index == jf.index
        np.testing.assert_array_equal(tf.depth, jf.depth)
        np.testing.assert_array_equal(tf.color, jf.color)
        np.testing.assert_array_equal(tf.trajectory, jf.trajectory)
        assert np.isneginf(tf.depth[0, :5]).all()
    assert t.process_frame_index(7) is None
