"""plslam_torch.native (the prefetching TUM loader with its own PNG decoder)
against the JAX package's libpng / libjpeg loader, OpenCV and PIL.

- The library builds here, at first use, into plslam_torch/_build/.
- ``TumLoader`` frames equal ``plslam_tpu.native.TumLoader``'s on the same
  5-frame directory, with PNG color images and with JPEG ones: depth and
  timestamps exactly; gray to 2 ulp, because the JAX package's library is
  built with ``-march=native`` and its compiler fuses the gray sum into
  fma(0.114, B, fma(0.299, R, 0.587 G)), which rounds twice where numpy
  rounds each product and each sum (4 pixels in 5 agree), where the port
  builds with ``-ffp-contract=off``: its gray equals numpy's float32
  0.299 R + 0.587 G + 0.114 B bit for bit.
- The decoder equals OpenCV / PIL on gray, gray+alpha, RGB, RGBA, palette
  with and without tRNS, bit depths 1, 2, 4, 8 and 16, Adam7 interlacing,
  zlib levels 0, 1 and 9 and several IDAT chunks; and on streams made to
  reach the inflate's edges: 258-byte matches (length code 285), distances
  past 24576 (distance code 29), stored blocks split across IDAT chunks,
  Paeth on the first row, interlace passes of images smaller than 8 pixels.
  A preset dictionary, literal/length codes 286 / 287 and distance codes
  30 / 31 are refused, as zlib refuses them.
- A truncated or damaged frame is skipped and the rest keep their order, as
  in the JAX loader; a build without libjpeg refuses a JPEG association at
  construction.
- ``python -m plslam_torch.utils.run_tum --native-loader`` on a 10-frame
  directory writes 10 rows.
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from plslam_tpu.native import TumLoader as JaxTumLoader  # noqa: E402
from plslam_torch.native import TumLoader, loader, native_available, read_png  # noqa: E402
from plslam_torch.utils import png_io  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tum_dir(root, n=5, ext="png", shape=(120, 160), seed=0):
    """A TUM-format directory of random RGB + 16-bit depth frames (cv2)."""
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        ts = 1000.0 + i * 0.033
        rgb = rng.integers(0, 255, shape + (3,), np.uint8)
        depth = (rng.uniform(0.5, 4.0, shape) * 5000).astype(np.uint16)
        cv2.imwrite(str(root / "rgb" / f"{ts:.6f}.{ext}"), rgb)
        cv2.imwrite(str(root / "depth" / f"{ts:.6f}.png"), depth)
        lines.append(f"{ts:.6f} rgb/{ts:.6f}.{ext} {ts:.6f} depth/{ts:.6f}.png\n")
    with open(root / "assoc.txt", "w") as f:
        f.writelines(lines)
    return root


def _frames(cls, root, **kw):
    ld = cls(str(root / "assoc.txt"), width=160, height=120, **kw)
    out = list(ld)
    ld.close()
    return out


def _assert_frames_equal(ours, jax_frames):
    assert len(ours) == len(jax_frames)
    for (ga, da, ta), (gb, db, tb) in zip(ours, jax_frames):
        assert ta == tb
        np.testing.assert_array_equal(da, db)
        assert (np.abs(ga.view(np.int32) - gb.view(np.int32)) <= 2).all()  # 2 ulp


def _gray_plain(path):
    """numpy's float32 0.299 R + 0.587 G + 0.114 B of a color file."""
    rgb = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1].astype(np.float32)
    f = np.float32
    return f(0.299) * rgb[..., 0] + f(0.587) * rgb[..., 1] + f(0.114) * rgb[..., 2]


def test_library_builds():
    assert native_available()
    assert loader.lib_path().exists()
    assert loader.lib_path().parent.name == "_build"


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_frames_equal_jax_loader(tmp_path, ext):
    root = _tum_dir(tmp_path, ext=ext)
    ours = _frames(TumLoader, root)
    assert len(ours) == 5 and ours[0][0].shape == (120, 160)
    _assert_frames_equal(ours, _frames(JaxTumLoader, root))
    assert [f[2] for f in ours] == sorted(f[2] for f in ours)
    for (gray, _, ts), name in zip(ours, sorted(os.listdir(root / "rgb"))):
        np.testing.assert_array_equal(gray, _gray_plain(root / "rgb" / name))


def test_damaged_frames_are_skipped_in_order(tmp_path):
    root = _tum_dir(tmp_path, n=6)
    names = sorted(os.listdir(root / "rgb"))
    data = (root / "rgb" / names[1]).read_bytes()
    (root / "rgb" / names[1]).write_bytes(data[: len(data) // 2])      # truncated
    dpath = root / "depth" / sorted(os.listdir(root / "depth"))[3]
    data = bytearray(dpath.read_bytes())
    data[len(data) // 2] ^= 0x5A                                       # CRC breaks
    dpath.write_bytes(bytes(data))
    ours = _frames(TumLoader, root, n_threads=3, prefetch=2)
    assert len(ours) == 4
    _assert_frames_equal(ours, _frames(JaxTumLoader, root))
    with pytest.raises(ValueError):
        read_png(str(root / "rgb" / names[1]))


def test_frame_of_another_size_raises(tmp_path):
    root = _tum_dir(tmp_path, n=2)
    ld = TumLoader(str(root / "assoc.txt"), width=80, height=60)
    with pytest.raises(ValueError, match="160x120"):
        next(iter(ld))
    ld.close()


def test_jpeg_association_raises_without_libjpeg(tmp_path, monkeypatch):
    root = _tum_dir(tmp_path, n=2, ext="jpg")
    monkeypatch.setattr(loader, "_has_jpeg", False)
    monkeypatch.setattr(loader, "_lib", None)  # the build without JPEG
    with pytest.raises(RuntimeError, match="libjpeg"):
        TumLoader(str(root / "assoc.txt"), width=160, height=120)
    assert "-DPLSLAM_NO_JPEG" in loader._jpeg_flags()


# ---------------------------------------------------------------- the decoder
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2)]


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _pack_rows(samples, bd):
    """(h, w * channels) samples -> (h, row bytes) uint8, big-endian."""
    if bd == 16:
        return samples.astype(">u2").view(np.uint8)
    if bd == 8:
        return samples.astype(np.uint8)
    h, n = samples.shape
    per = 8 // bd
    padded = np.zeros((h, -(-n // per) * per), np.uint8)
    padded[:, :n] = samples
    shifts = (8 - bd * (np.arange(per) + 1)).astype(np.uint8)
    return (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _filter(rows, bpp, ftype):
    """Rows filtered with one PNG filter type each (``ftype`` per row)."""
    x = rows.astype(np.int32)
    up = np.vstack([np.zeros_like(x[:1]), x[:-1]])
    left = np.hstack([np.zeros_like(x[:, :bpp]), x[:, :-bpp]])
    ul = np.hstack([np.zeros_like(up[:, :bpp]), up[:, :-bpp]])
    pred = [0 * x, left, up, (left + up) >> 1, png_io._paeth(left, up, ul)]
    out = np.stack([(x - pred[f])[i] for i, f in enumerate(ftype)]) & 0xFF
    return np.hstack([np.asarray(ftype)[:, None], out]).astype(np.uint8)


def make_png(samples, bd, ct, interlace=False, palette=None, trns=None, level=6,
             idat=1 << 15, filters=range(5), stream=None):
    """A PNG of (h, w, channels) samples, every option of the format under
    the test's control; ``stream`` replaces the zlib stream."""
    h, w, ch = samples.shape
    bpp = max(1, ch * bd // 8)
    passes = [(0, 0, 1, 1)] if not interlace else ADAM7
    body = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub.reshape(sub.shape[0], -1), bd)
        ftype = [list(filters)[i % len(list(filters))] for i in range(len(rows))]
        body += _filter(rows, bpp, ftype).tobytes()
    z = zlib.compress(body, level) if stream is None else stream
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bd, ct, 0, 0,
                                                             int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    for i in range(0, max(len(z), 1), idat):
        out += _chunk(b"IDAT", z[i:i + idat])
    return out + _chunk(b"IEND", b"")


def _decode_both(tmp_path, data):
    p = tmp_path / "t.png"
    p.write_bytes(data)
    return read_png(str(p)), cv2.imread(str(p), cv2.IMREAD_UNCHANGED), Image.open(p)


def _cv2_order(img):
    """OpenCV's BGR(A) as RGB(A), with a channel axis."""
    if img.ndim == 2:
        return img[..., None]
    return img[..., [2, 1, 0, 3][: img.shape[2]]] if img.shape[2] >= 3 else img


CASES = [  # (color type, channels, bit depth)
    (0, 1, 1), (0, 1, 2), (0, 1, 4), (0, 1, 8), (0, 1, 16),
    (4, 2, 8), (4, 2, 16), (2, 3, 8), (2, 3, 16), (6, 4, 8), (6, 4, 16),
]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ct,ch,bd", CASES, ids=[f"ct{c}-{b}bit" for c, _, b in CASES])
def test_decoder_matches_opencv_and_pil(tmp_path, ct, ch, bd, interlace):
    rng = np.random.default_rng(bd * 10 + ct)
    s = rng.integers(0, 1 << bd, (13, 21, ch)).astype(np.uint16)
    got, ref_cv, ref_pil = _decode_both(tmp_path, make_png(s, bd, ct, interlace,
                                                           level=9, idat=37))
    want = s if bd >= 8 else (s * (255 // ((1 << bd) - 1)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == (np.uint16 if bd == 16 else np.uint8)
    if ch != 2:  # OpenCV drops the alpha of gray+alpha
        np.testing.assert_array_equal(got, _cv2_order(ref_cv))
    if bd == 8:
        np.testing.assert_array_equal(got[..., 0], np.asarray(ref_pil)[..., 0]
                                      if ch > 1 else np.asarray(ref_pil))


@pytest.mark.parametrize("bd", [1, 2, 4, 8])
@pytest.mark.parametrize("with_trns", [False, True], ids=["rgb", "trns"])
def test_palette_matches_pil(tmp_path, bd, with_trns):
    rng = np.random.default_rng(bd)
    n = 1 << bd
    idx = rng.integers(0, n, (9, 17, 1)).astype(np.uint16)
    pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    alpha = rng.integers(0, 256, n - 1).astype(np.uint8)  # the last entry stays opaque
    got, ref_cv, ref_pil = _decode_both(tmp_path, make_png(
        idx, bd, 3, palette=pal, trns=alpha.tobytes() if with_trns else None))
    want = pal[idx[..., 0]]
    if with_trns:
        want = np.concatenate([want, np.append(alpha, 255)[idx]], -1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(ref_pil.convert("RGBA" if with_trns
                                                                  else "RGB")))


@pytest.mark.parametrize("ct,bd", [(0, 4), (0, 8), (0, 16), (2, 8), (2, 16)])
def test_trns_becomes_alpha(tmp_path, ct, bd):
    ch = 1 if ct == 0 else 3
    s = np.random.default_rng(bd).integers(0, 1 << bd, (11, 7, ch)).astype(np.uint16)
    key = s[3, 4].copy()
    got, _, ref_pil = _decode_both(tmp_path, make_png(
        s, bd, ct, trns=b"".join(struct.pack(">H", int(v)) for v in key)))
    clear = (s == key).all(-1, keepdims=True)
    top = 65535 if bd == 16 else 255
    color = s if bd >= 8 else s * (255 // ((1 << bd) - 1))
    np.testing.assert_array_equal(got, np.concatenate([color, np.where(clear, 0, top)], -1))
    if bd == 8:
        np.testing.assert_array_equal(got, np.asarray(ref_pil.convert("LA" if ct == 0
                                                                      else "RGBA")))


@pytest.mark.parametrize("level", [0, 1, 9])
@pytest.mark.parametrize("idat", [7, 1000, 1 << 20], ids=["idat7", "idat1000", "one-idat"])
def test_levels_and_idat_chunks(tmp_path, level, idat):
    """zlib levels 0 (stored blocks, split across IDAT chunks), 1 and 9."""
    s = np.random.default_rng(level).integers(0, 256, (40, 30, 3)).astype(np.uint16)
    got, ref_cv, _ = _decode_both(tmp_path, make_png(s, 8, 2, level=level, idat=idat))
    np.testing.assert_array_equal(got, s)
    np.testing.assert_array_equal(got, _cv2_order(ref_cv))


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (7, 2), (2, 9)])
def test_adam7_small_images_and_paeth_first_row(tmp_path, shape):
    s = np.random.default_rng(shape[0]).integers(0, 65536, shape + (4,)).astype(np.uint16)
    for filters in ([4], [3], [1, 2]):
        got, ref_cv, _ = _decode_both(tmp_path, make_png(s, 16, 6, True, filters=filters))
        np.testing.assert_array_equal(got, s)
        np.testing.assert_array_equal(got, _cv2_order(ref_cv))


def test_long_matches_and_far_distances(tmp_path):
    """Runs of zeros (258-byte matches, length code 285) and rows repeated
    more than 24576 bytes later (distance code 29)."""
    rng = np.random.default_rng(7)
    top = rng.integers(0, 256, (130, 200, 1))
    s = np.concatenate([top, np.zeros((20, 200, 1)), top]).astype(np.uint16)
    data = make_png(s, 8, 0, level=9, filters=[0])
    got, ref_cv, _ = _decode_both(tmp_path, data)
    np.testing.assert_array_equal(got, s)
    np.testing.assert_array_equal(got, _cv2_order(ref_cv))


class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value, n):  # least significant bit first
        self.bits += [(value >> i) & 1 for i in range(n)]

    def put_code(self, code, n):  # Huffman codes: most significant bit first
        self.bits += [(code >> (n - 1 - i)) & 1 for i in range(n)]

    def bytes(self):
        b = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, b[i:i + 8][::-1])), 2) for i in range(0, len(b), 8))


def _fixed_stream(symbols, payload=b"\x00\x07"):
    """A zlib stream of one fixed-Huffman block: the literals of
    ``payload``, then ``symbols`` (("lit", v) / ("dist", code)), end of
    block, and the payload's Adler-32."""
    w = _BitWriter()
    w.put(1, 1)
    w.put(1, 2)

    def lit(v):
        if v < 144:
            w.put_code(0x30 + v, 8)
        elif v < 256:
            w.put_code(0x190 + v - 144, 9)
        elif v < 280:
            w.put_code(v - 256, 7)
        else:
            w.put_code(0xC0 + v - 280, 8)

    for b in payload:
        lit(b)
    for kind, v in symbols:
        if kind == "lit":
            lit(v)
        else:
            w.put_code(v, 5)
    lit(256)
    return b"\x78\x01" + w.bytes() + struct.pack(">I", zlib.adler32(payload))


@pytest.mark.parametrize("bad", [[("lit", 286)], [("lit", 287)],
                                 [("lit", 257), ("dist", 30)], [("lit", 257), ("dist", 31)],
                                 "fdict", None], ids=["lit286", "lit287", "dist30", "dist31",
                                                      "fdict", "valid"])
def test_invalid_codes_are_refused(tmp_path, bad):
    s = np.array([[[7]]], np.uint16)
    if bad == "fdict":
        z = zlib.compress(b"\x00\x07")
        cmf = z[0]
        flg = 0x20 | (31 - ((cmf << 8) | 0x20) % 31) % 31
        stream = bytes([cmf, flg]) + b"\x00\x00\x00\x01" + z[2:]
    else:
        stream = _fixed_stream(bad or [])
    got_path = tmp_path / "t.png"
    got_path.write_bytes(make_png(s, 8, 0, stream=stream))
    if bad is None:
        np.testing.assert_array_equal(read_png(str(got_path)), s)
        assert cv2.imread(str(got_path), cv2.IMREAD_UNCHANGED) is not None
        return
    with pytest.raises(ValueError):
        read_png(str(got_path))
    assert cv2.imread(str(got_path), cv2.IMREAD_UNCHANGED) is None


def test_plain_decoder_reads_the_writer(tmp_path):
    """png_io's writer and plain decoder (the card's reference) against the
    native decoder and OpenCV: 8-bit RGB and 16-bit depth."""
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (23, 31, 3)).astype(np.uint8)
    depth = rng.integers(0, 65536, (23, 31)).astype(np.uint16)
    for img, name in ((rgb, "c.png"), (depth, "d.png")):
        p = str(tmp_path / name)
        png_io.write_png(p, img, idat_bytes=100)
        want = img if img.ndim == 3 else img[..., None]
        np.testing.assert_array_equal(png_io.decode_plain([p])[0], want)
        np.testing.assert_array_equal(read_png(p), want)
        np.testing.assert_array_equal(_cv2_order(cv2.imread(p, cv2.IMREAD_UNCHANGED)), want)


def test_run_tum_native_loader_writes_a_row_per_frame(tmp_path):
    """10 rendered frames written with utils.png_io, no OpenCV, at 320x240:
    the smallest size the port's ORB extraction takes (at 160x120 its
    per-level keypoint budgets exceed the pyramid's candidates)."""
    from plslam_torch.geometry.projection import Camera
    from plslam_torch.utils import tum_io
    from plslam_torch.utils.synthetic import RoomScene, smooth_trajectory

    cam = Camera(fx=262.5, fy=262.5, cx=159.5, cy=119.5, bf=40.0, width=320, height=240)
    scene = RoomScene(0)
    frames = [scene.render(cam, R, t) for R, t in smooth_trajectory(300)[:10]]
    seq = tmp_path / "seq"
    tum_io.write_sequence(str(seq), [np.clip(g, 0, 255).astype(np.uint8) for g, _ in frames],
                          [np.clip(d * 5000, 0, 65535).astype(np.uint16) for _, d in frames],
                          1000.0 + np.arange(10) / 30.0, cam)
    out = tmp_path / "out"
    # two intra-op threads, as tests/torch_parity.py gives in-process tests: the
    # tier-1 run puts 6 test processes on the machine's cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "plslam_torch.utils.run_tum",
                        str(seq / "settings.yaml"), str(seq / "associate.txt"), "--out",
                        str(out), "--device", "cpu", "--native-loader", "--sync", "--no-loop"],
                       capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rows = np.loadtxt(out / "CameraTrajectory.txt", ndmin=2)
    assert rows.shape == (10, 8) and np.isfinite(rows).all()
