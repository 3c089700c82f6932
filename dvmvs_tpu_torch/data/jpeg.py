"""Baseline JPEG decoding without OpenCV or PIL, pixel for pixel what
``cv2.imdecode`` gives (libjpeg-turbo at its defaults).

Scope: sequential Huffman-coded JPEGs (SOF0, SOF1) of 8-bit samples, gray or
three components, sampling factors up to 2x2, one interleaved scan or one
scan per component, restart markers (DRI / RSTn), any image size. A
progressive, arithmetic-coded, lossless or 12-bit file raises
``ValueError`` naming the file.

The markers are parsed here, and each scan's entropy-coded data is decoded
into quantised coefficients by a small C++ routine
(``csrc/jpeg_huffman.cpp``, built with g++ at first use by
``utils/native.py``; a failed build raises ``NativeBuildError``). The rest is
NumPy integer arithmetic over all blocks at once, matching libjpeg-turbo's
defaults as OpenCV runs them: the ISLOW inverse DCT (``jidctint.c``, with
its range-limit table), "fancy" triangular upsampling of subsampled chroma
(``jdsample.c``: h2v1, h1v2, h2v2; edges replicated at the component's
downsampled size; plain replication where a row has 2 samples or fewer),
and fixed-point YCbCr to RGB (``jdcolor.c``).
"""

from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from dvmvs_tpu_torch.utils import native

JPEG_HUFFMAN = native.NativeSource(
    "jpeg_huffman", Path(__file__).resolve().parents[1] / "csrc", ("jpeg_huffman.cpp",))

# zigzag position -> natural (row-major) index: DQT lists tables in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

UNSUPPORTED_SOF = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
                   0xC6: "differential progressive", 0xC7: "differential lossless",
                   0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
                   0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential",
                   0xCE: "arithmetic-coded differential progressive",
                   0xCF: "arithmetic-coded differential lossless"}
SCAN_ERRORS = {-1: "a bad Huffman table", -2: "a Huffman code no table holds",
               -3: "a missing or misnumbered restart marker"}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(native.build(JPEG_HUFFMAN)))
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.jpeg_decode_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, i32, i32,
        np.ctypeslib.ndpointer(np.uint8, flags="C"), np.ctypeslib.ndpointer(np.uint8, flags="C"),
        i32, i32, np.ctypeslib.ndpointer(np.int64, flags="C"),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64]
    lib.jpeg_decode_scan.restype = ctypes.c_int64
    return lib


# ------------------------------------------------------------- inverse DCT

CONST_BITS, PASS1_BITS = 13, 2


def _fix(x: float) -> int:
    return int(x * (1 << CONST_BITS) + 0.5)


def _idct_1d(x: List[np.ndarray], pass1: bool) -> List[np.ndarray]:
    """jidctint.c's 1-D ISLOW inverse DCT of eight int64 arrays (frequencies
    0..7), descaled as its column pass (``pass1``) or its row pass does."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _fix(0.541196100)
    tmp2 = z1 + z3 * -_fix(1.847759065)
    tmp3 = z1 + z2 * _fix(0.765366865)
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _fix(1.175875602)
    tmp0 = tmp0 * _fix(0.298631336)
    tmp1 = tmp1 * _fix(2.053119869)
    tmp2 = tmp2 * _fix(3.072711026)
    tmp3 = tmp3 * _fix(1.501321110)
    z1 = z1 * -_fix(0.899976223)
    z2 = z2 * -_fix(2.562915447)
    z3 = z3 * -_fix(1.961570560) + z5
    z4 = z4 * -_fix(0.390180644) + z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4

    shift = CONST_BITS - PASS1_BITS if pass1 else CONST_BITS + PASS1_BITS + 3
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
        tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)]


@functools.lru_cache(maxsize=1)
def _range_limit() -> np.ndarray:
    """libjpeg's post-IDCT range-limit table, indexed by (value & 1023): x+128
    for x in [-128, 127], 255 above, 0 below, wrapping as the table does."""
    v = np.arange(1024)
    return np.select([v < 128, v < 512, v < 896], [v + 128, 255, 0], v - 896).astype(np.uint8)


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Blocks (N, 64) of quantised coefficients in natural order and their
    quantisation table (64,) -> samples (N, 8, 8) uint8."""
    d = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    cols = _idct_1d([d[:, k, :] for k in range(8)], pass1=True)  # along each column
    ws = np.stack(cols, axis=1)  # (N, row, column frequency)
    rows = _idct_1d([ws[:, :, k] for k in range(8)], pass1=False)
    return _range_limit()[np.stack(rows, axis=2) & 1023]


# -------------------------------------------------------------- upsampling

def _edges(a: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """The neighbour before and after each sample along ``axis``, the edge
    sample standing in for itself."""
    first = np.take(a, [0], axis=axis)
    last = np.take(a, [a.shape[axis] - 1], axis=axis)
    n = a.shape[axis]
    before = np.concatenate([first, np.take(a, np.arange(n - 1), axis=axis)], axis=axis)
    after = np.concatenate([np.take(a, np.arange(1, n), axis=axis), last], axis=axis)
    return before, after


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component plane (its downsampled size) enlarged fh x fv as
    libjpeg-turbo does with fancy upsampling on."""
    p = plane.astype(np.int32)
    fancy_h = fh == 2 and p.shape[1] > 2
    if fh == 2 and fv == 2 and fancy_h:
        above, below = _edges(p, 0)
        sums = [3 * p + above, 3 * p + below]  # output rows 2r and 2r + 1
        out = []
        for s in sums:
            left, right = _edges(s, 1)
            out.append(_interleave((3 * s + left + 8) >> 4, (3 * s + right + 7) >> 4, 1))
        return _interleave(out[0], out[1], 0).astype(np.uint8)
    if fh == 2 and fv == 1 and fancy_h:
        left, right = _edges(p, 1)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 1).astype(np.uint8)
    if fh == 1 and fv == 2:
        above, below = _edges(p, 0)
        return _interleave((3 * p + above + 1) >> 2, (3 * p + below + 2) >> 2, 0).astype(np.uint8)
    return np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)


# ----------------------------------------------------------------- colour

@functools.lru_cache(maxsize=1)
def _ycc_tables() -> Tuple[np.ndarray, ...]:
    """jdcolor.c's build_ycc_rgb_table: (Cr->R, Cb->B, Cr->G, Cb->G)."""
    x = np.arange(256, dtype=np.int32) - 128  # every sum below fits in 32 bits
    fix = lambda f: int(f * (1 << 16) + 0.5)  # noqa: E731
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    yy = y.astype(np.int32)
    rgb = np.stack([yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16), yy + cb_b[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ decode

def _u16(data: bytes, pos: int) -> int:
    return struct.unpack_from(">H", data, pos)[0]


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, or (H, W) uint8 for a gray image
    (as ``cv2.imdecode(..., IMREAD_UNCHANGED)``, then BGR to RGB)."""
    return _output(*decode_coefficients(data, name))


def decode_coefficients(data: bytes, name: str = "<bytes>"):
    """Parse the markers and decode every scan: (frame (height, width,
    [(id, h, v, quantisation table id)]), component id -> quantised
    coefficients (block rows, block columns, 64) int16 in natural order,
    component id -> its quantisation table (64,), the Adobe transform flag
    or None, whether a JFIF marker was seen)."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    quant: Dict[int, np.ndarray] = {}
    tables: Dict[Tuple[int, int], Tuple[bytes, bytes]] = {}
    frame, restart, adobe, jfif = None, 0, None, False
    comp_quant: Dict[int, np.ndarray] = {}
    planes: Dict[int, np.ndarray] = {}
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1  # bytes between segments (the end of a scan's data)
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break  # no EOI: decode what was read, as libjpeg does with a warning
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker in (0x01, 0xD8):
            continue  # stray RSTn, TEM, SOI: no length
        if pos + 2 > len(data):
            raise ValueError(f"{name}: truncated marker 0x{marker:02x}")
        length = _u16(data, pos)
        seg = data[pos + 2:pos + length]
        if len(seg) != length - 2:
            raise ValueError(f"{name}: truncated marker 0x{marker:02x} segment")
        pos += length
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                values = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = values
                quant[tq] = table
                i += 1 + n
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = seg[i + 1:i + 17]
                n = sum(bits)
                tables[(tc, th)] = (bytes([0]) + bits, seg[i + 17:i + 17 + n])
                i += 17 + n
        elif marker in (0xC0, 0xC1):  # baseline, extended sequential Huffman
            precision, height, width, n_comp = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
            if precision != 8:
                raise ValueError(f"{name}: {precision}-bit JPEG samples are not supported "
                                 "(8-bit are)")
            if n_comp not in (1, 3) or height == 0 or width == 0:
                raise ValueError(f"{name}: {n_comp} components at {width}x{height} are not "
                                 "supported (1 or 3 components, a height in the frame header)")
            comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4, seg[7 + 3 * c] & 15, seg[8 + 3 * c])
                     for c in range(n_comp)]
            if any(not (1 <= h <= 2 and 1 <= v <= 2) for _, h, v, _ in comps):
                raise ValueError(f"{name}: sampling factors {[c[1:3] for c in comps]} are not "
                                 "supported (up to 2x2)")
            frame = (height, width, comps)
        elif marker in UNSUPPORTED_SOF:
            raise ValueError(f"{name}: {UNSUPPORTED_SOF[marker]} JPEG (SOF{marker - 0xC0}) is "
                             "not supported (baseline and extended sequential Huffman are)")
        elif marker == 0xDD:  # DRI
            restart = _u16(seg, 0)
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{name}: a scan before the frame header")
            pos = _decode_scan(data, pos, seg, frame, restart, quant, tables, comp_quant,
                               planes, name)
    if frame is None or len(planes) != len(frame[2]):
        raise ValueError(f"{name}: no frame header, or a component without a scan")
    return frame, planes, comp_quant, adobe, jfif


def _frame_geometry(frame):
    height, width, comps = frame
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcus = (-(-width // (8 * hmax)), -(-height // (8 * vmax)))
    return height, width, comps, hmax, vmax, mcus


def _decode_scan(data, start, seg, frame, restart, quant, tables, comp_quant, planes, name):
    """Decode the scan whose SOS segment is ``seg`` into ``planes`` (component
    id -> (block rows, block columns, 64) int16); returns the offset after
    its entropy-coded data."""
    height, width, comps, hmax, vmax, (mcus_x, mcus_y) = _frame_geometry(frame)
    by_id = {c[0]: c for c in comps}
    n = seg[0]
    scan = [(seg[1 + 2 * i], seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15) for i in range(n)]
    ss, se, ahal = seg[1 + 2 * n], seg[2 + 2 * n], seg[3 + 2 * n]
    if (ss, se, ahal) != (0, 63, 0):
        raise ValueError(f"{name}: a scan of spectral range {ss}..{se} / approximation {ahal} "
                         "is not sequential")
    bits = np.zeros((8, 17), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    for (tc, th), (b, v) in tables.items():
        if tc < 2 and th < 4:
            bits[4 * tc + th] = np.frombuffer(b, np.uint8)
            vals[4 * tc + th, :len(v)] = np.frombuffer(v, np.uint8)
    dc, ac, h, v, stride, ptrs = [], [], [], [], [], []
    for cid, td, ta in scan:
        if cid not in by_id:
            raise ValueError(f"{name}: a scan names component {cid}, which the frame lacks")
        if (0, td) not in tables or (1, ta) not in tables:
            raise ValueError(f"{name}: component {cid} uses an undefined Huffman table")
        _, ch, cv, tq = by_id[cid]
        if tq not in quant:
            raise ValueError(f"{name}: component {cid} uses undefined quantisation table {tq}")
        comp_quant[cid] = quant[tq].copy()  # latched at the component's scan, as libjpeg does
        plane = planes.setdefault(cid, np.zeros((mcus_y * cv, mcus_x * ch, 64), np.int16))
        interleaved = n > 1
        dc.append(td)
        ac.append(ta)
        h.append(ch if interleaved else 1)
        v.append(cv if interleaved else 1)
        stride.append(plane.shape[1])
        ptrs.append(plane.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    if n == 1:  # one block an MCU, over the component's own size
        _, ch, cv, _ = by_id[scan[0][0]]
        mcus_x = -(-(-(-width * ch // hmax)) // 8)
        mcus_y = -(-(-(-height * cv // vmax)) // 8)
    end = _library().jpeg_decode_scan(
        data, len(data), start, n, np.array(dc, np.int32), np.array(ac, np.int32),
        bits, vals, np.array(h, np.int32), np.array(v, np.int32), np.array(stride, np.int64),
        (ctypes.POINTER(ctypes.c_int16) * n)(*ptrs), mcus_x, mcus_y, restart)
    if end < 0:
        raise ValueError(f"{name}: corrupt scan data ({SCAN_ERRORS.get(end, end)})")
    return end


def _output(frame, planes, comp_quant, adobe, jfif) -> np.ndarray:
    height, width, comps, hmax, vmax, _ = _frame_geometry(frame)
    full = []
    for cid, h, v, _ in comps:
        coef = planes[cid]
        bh, bw = coef.shape[:2]
        samples = idct_islow(coef.reshape(-1, 64), comp_quant[cid])
        plane = samples.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        dh, dw = -(-height * v // vmax), -(-width * h // hmax)
        full.append(upsample(plane[:dh, :dw], hmax // h, vmax // v)[:height, :width])
    if len(full) == 1:
        return full[0]
    # libjpeg's guess of the colour space: JFIF means YCbCr, else an Adobe
    # marker's transform flag (0: RGB), else component ids "R", "G", "B"
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = tuple(c[0] for c in comps) == (82, 71, 66)
    if rgb:
        return np.stack(full, axis=-1)
    return ycc_to_rgb(*full)


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file as ``decode_jpeg`` gives it."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
