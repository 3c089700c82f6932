"""Scene file I/O for the canonical dataset layout without OpenCV
(counterpart of dvmvs_tpu/data/io.py, which reads PNGs with cv2).

Canonical scene (reference: README.md:88-100): ``images/*.png`` RGB,
``depth/*.png`` uint16 millimeters, ``poses.txt`` flattened 4x4
camera-to-world per line, ``K.txt`` 3x3 intrinsics.

PNGs are decoded with ``zlib`` and NumPy alone (``read_png``): the IHDR,
IDAT and IEND chunks (CRCs checked; other chunks skipped), the five scanline
filters, 8-bit gray, RGB and RGBA and 16-bit (big-endian) gray, without
interlacing. Anything else raises ``ValueError`` naming the file.
``write_png`` writes 8-bit RGB and 8/16-bit gray PNGs (filter 0), so scene
folders can be made where there is no OpenCV. ``read_image`` and
``load_image`` also take baseline JPEGs (``data/jpeg.py``), as the raw
datasets the exporters read hold them.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from dvmvs_tpu_torch.data.jpeg import read_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: 0 gray, 2 RGB, 6 RGBA (palette and gray+alpha are not read)
CHANNELS = {0: 1, 2: 3, 6: 4}


def _unfilter(filtered: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo the scanline filters. filtered (H, W, bpp) uint8 bytes, filters
    (H,) filter types -> the image bytes (H, W, bpp) uint8.

    Byte (r, x, k) depends on a = (r, x-1, k), b = (r-1, x, k) and c = (r-1,
    x-1, k), zero outside the image; so the pixels of one anti-diagonal
    r + x = d depend only on earlier diagonals, and each diagonal is decoded
    at once whatever the rows' filters."""
    H, W, bpp = filtered.shape
    out = np.zeros((H + 1, W + 1, bpp), np.int16)  # one row and column of zeros in front
    f = filtered.astype(np.int16)
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        kind = filters[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (f[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """A PNG as stored: (H, W) for gray, (H, W, 3) RGB or (H, W, 4) RGBA;
    uint8, or uint16 for 16-bit gray."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat, pos = None, [], 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4 or \
                struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    width, height, depth, colour, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if colour not in CHANNELS or depth not in (8, 16) or (depth == 16 and colour != 0):
        raise ValueError(f"{path}: PNG colour type {colour} at {depth} bits is not supported "
                         "(8-bit gray, RGB, RGBA and 16-bit gray are)")
    channels = CHANNELS[colour]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, want "
                         f"{height * (width * bpp + 1)}")
    rows = raw.reshape(height, width * bpp + 1)
    filters = rows[:, 0]
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown scanline filter {filters.max()}")
    filtered = rows[:, 1:].reshape(height, width, bpp)
    # rows that all have filter 0 (as write_png stores them) hold the bytes as they are
    image = _unfilter(filtered, filters) if filters.any() else filtered.copy()
    if depth == 16:
        image = image.reshape(height, width * 2).view(">u2").astype(np.uint16)
    image = image.reshape(height, width, channels)
    return image[:, :, 0] if channels == 1 else image


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, image: np.ndarray, level: int = 6):
    """Write an 8-bit RGB (H, W, 3) uint8 or a gray (H, W) uint8 / uint16
    image as a PNG (every scanline filter 0, zlib ``level``): the counterpart
    of ``cv2.imwrite`` for the canonical scene layout, whose RGB frames and
    millimetre depth maps ``read_png`` and cv2 read back unchanged."""
    if image.ndim == 3 and image.shape[2] == 3 and image.dtype == np.uint8:
        colour, depth = 2, 8
    elif image.ndim == 2 and image.dtype in (np.uint8, np.uint16):
        colour, depth = 0, 8 * image.dtype.itemsize
    else:
        raise ValueError(f"write_png: want (H, W, 3) uint8 or (H, W) uint8/uint16, got "
                         f"{image.dtype} {image.shape}")
    height, width = image.shape[:2]
    rows = np.ascontiguousarray(image, image.dtype.newbyteorder(">")).view(np.uint8)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows.reshape(height, -1)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0)
    data = (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(data)


def read_image(path: str) -> np.ndarray:
    """A PNG or JPEG file as stored, told apart by content (as
    ``cv2.imread(path, IMREAD_UNCHANGED)``, then BGR to RGB)."""
    with open(path, "rb") as fh:
        head = fh.read(2)
    return read_jpeg(path) if head == b"\xff\xd8" else read_png(path)


def read_rgb(path: str) -> np.ndarray:
    """RGB uint8 (H, W, 3) (as cv2.imread in colour mode, then BGR to RGB:
    gray is repeated, alpha dropped, 16 bits cut to 8)."""
    image = read_image(path)
    if image.dtype == np.uint16:
        image = (image >> 8).astype(np.uint8)
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)
    return image[:, :, :3]


def load_image(path: str) -> np.ndarray:
    """RGB float32 (H, W, 3), values 0..255 (``read_rgb``)."""
    return read_rgb(path).astype(np.float32)


def load_depth_png(path: str, scaling: float = 1000.0) -> np.ndarray:
    """uint16 millimeter PNG -> float32 meters."""
    return read_png(path).astype(np.float32) / scaling


def read_pfm(path: str):
    """Read a PFM image (reference: dataset/utils.py:68-108): (data (H, W) or
    (H, W, 3) float32, top row first; scale). PFM stores rows bottom-up and
    gives the byte order by the sign of the scale."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        data = np.fromfile(f, ("<" if scale < 0 else ">") + "f")
    shape = (height, width, 3) if header == b"PF" else (height, width)
    return np.flipud(data.reshape(shape)).astype(np.float32), abs(scale)


@dataclass
class Scene:
    name: str
    path: str
    K: np.ndarray  # (3, 3)
    poses: np.ndarray  # (N, 4, 4)
    image_filenames: List[str]
    depth_filenames: Optional[List[str]]


def _pngs(directory: str) -> List[str]:
    return sorted(os.path.join(directory, f) for f in os.listdir(directory) if f.endswith(".png"))


def load_scene(scene_path: str) -> Scene:
    K = np.loadtxt(os.path.join(scene_path, "K.txt")).astype(np.float32)
    poses = np.fromfile(os.path.join(scene_path, "poses.txt"), dtype=float,
                        sep="\n ").reshape(-1, 4, 4)
    depth_dir = os.path.join(scene_path, "depth")
    return Scene(
        name=os.path.basename(os.path.normpath(scene_path)),
        path=scene_path,
        K=K,
        poses=poses,
        image_filenames=_pngs(os.path.join(scene_path, "images")),
        depth_filenames=_pngs(depth_dir) if os.path.isdir(depth_dir) else None,
    )
