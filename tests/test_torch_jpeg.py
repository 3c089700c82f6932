"""The port's JPEG decoder (dvmvs_tpu_torch/data/jpeg.py) against
cv2.imdecode, which the JAX ScanNet exporter calls (libjpeg-turbo at its
defaults: ISLOW inverse DCT, fancy upsampling, fixed-point YCbCr).

Tolerance: none. Every case here decodes bit for bit equal to cv2: qualities
50, 75 and 95; 4:2:0, 4:2:2, 4:4:0 and 4:4:4 sampling and gray; sizes that
are not a multiple of the MCU (down to 2x3, where fancy upsampling falls
back to replication); restart intervals; one scan per component. A
progressive, arithmetic-coded or 12-bit file raises ValueError naming the
file. The committed 1296x968 fixtures of data/synth_scannet.py decode to
the pixels whose digests were taken from cv2.
"""

import struct

import cv2
import numpy as np
import pytest

from dvmvs_tpu_torch.data import jpeg, synth_scannet
from dvmvs_tpu_torch.data.io import load_image, read_image

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
# (height, width): MCU-aligned, ragged, odd, and tiny (chroma rows of <= 2 samples)
SIZES = [(32, 48), (37, 53), (17, 9), (2, 3)]


def textured(rs, h, w, channels=3):
    """Smooth structure plus noise: every DCT frequency gets energy, and
    colours vary, so the chroma planes and the upsampler are exercised."""
    base = cv2.resize(rs.rand(h // 4 + 2, w // 4 + 2, channels).astype(np.float32) * 255,
                      (w, h), interpolation=cv2.INTER_CUBIC)
    img = np.clip(base.reshape(h, w, channels) + rs.randn(h, w, channels) * 12, 0, 255)
    return img.astype(np.uint8).squeeze()


def cv2_decode(data: bytes) -> np.ndarray:
    out = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return out if out.ndim == 2 else cv2.cvtColor(out, cv2.COLOR_BGR2RGB)


def encode(img, *params) -> bytes:
    ok, data = cv2.imencode(".jpg", img, list(params))
    assert ok
    return data.tobytes()


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_colour_decode_equals_cv2(quality, sampling):
    rs = np.random.RandomState(quality + len(sampling))
    for h, w in SIZES:
        for restart in (0, 2):
            data = encode(textured(rs, h, w), cv2.IMWRITE_JPEG_QUALITY, quality,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                          cv2.IMWRITE_JPEG_RST_INTERVAL, restart)
            got, want = jpeg.decode_jpeg(data), cv2_decode(data)
            assert got.shape == want.shape == (h, w, 3)
            assert np.array_equal(got, want), (h, w, restart, int((got != want).sum()))


@pytest.mark.parametrize("quality", [50, 95])
def test_gray_decode_equals_cv2(quality):
    rs = np.random.RandomState(quality)
    for h, w in SIZES:
        data = encode(textured(rs, h, w, 1), cv2.IMWRITE_JPEG_QUALITY, quality)
        got = jpeg.decode_jpeg(data)
        assert got.shape == (h, w) and np.array_equal(got, cv2_decode(data))
        # colour mode (as the ScanNet exporter reads) repeats the gray plane
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert np.array_equal(np.repeat(got[:, :, None], 3, axis=2), bgr[:, :, ::-1])


def _huffman_codes(bits: bytes, vals: bytes) -> dict:
    """symbol -> (code, length) of a DHT table (T.81 Annex C)."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)  # byte stuffing
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with ones
        return bytes(self.out)


def _encode_blocks(blocks: np.ndarray, dc: dict, ac: dict) -> bytes:
    """Baseline Huffman coding of (N, 64) natural-order blocks, one
    component's scan (T.81 F.1.2)."""
    zigzag = jpeg.ZIGZAG
    w, pred = _BitWriter(), 0

    def magnitude(v):
        size = int(abs(v)).bit_length()
        return size, (v if v >= 0 else v + (1 << size) - 1)

    for block in blocks.astype(np.int64):
        z = block[zigzag]
        size, bits = magnitude(int(z[0]) - pred)
        pred = int(z[0])
        w.put(*dc[size])
        w.put(bits, size)
        run = 0
        last = max([k for k in range(1, 64) if z[k]], default=0)
        for k in range(1, last + 1):
            if z[k] == 0:
                run += 1
                continue
            while run > 15:
                w.put(*ac[0xF0])
                run -= 16
            size, bits = magnitude(int(z[k]))
            w.put(*ac[(run << 4) | size])
            w.put(bits, size)
            run = 0
        if last < 63:
            w.put(*ac[0x00])
    return w.flush()


def _one_scan_per_component(data: bytes) -> bytes:
    """Rewrite a baseline 4:4:4 JPEG of one interleaved scan as three scans
    of one component each (same tables, same coefficients)."""
    frame, planes, _, _, _ = jpeg.decode_coefficients(data)
    height, width, comps = frame
    sos = data.index(b"\xff\xda")
    head = data[:sos]
    tables, i = {}, head.index(b"\xff\xc4")
    while head[i:i + 2] == b"\xff\xc4":
        length = struct.unpack(">H", head[i + 2:i + 4])[0]
        seg, j = head[i + 4:i + 2 + length], 0
        while j < len(seg):
            n = sum(seg[j + 1:j + 17])
            tables[(seg[j] >> 4, seg[j] & 15)] = _huffman_codes(seg[j + 1:j + 17],
                                                                seg[j + 17:j + 17 + n])
            j += 17 + n
        i += 2 + length
    n_scan = data[sos + 4]
    selectors = {data[sos + 5 + 2 * c]: data[sos + 6 + 2 * c] for c in range(n_scan)}
    out = bytearray(head)
    for cid, _, _, _ in comps:
        sel = selectors[cid]
        bh, bw = -(-height // 8), -(-width // 8)
        blocks = planes[cid][:bh, :bw].reshape(-1, 64)
        out += b"\xff\xda" + struct.pack(">HB", 8, 1) + bytes([cid, sel, 0, 63, 0])
        out += _encode_blocks(blocks, tables[(0, sel >> 4)], tables[(1, sel & 15)])
    return bytes(out + b"\xff\xd9")


def test_one_scan_per_component_equals_cv2():
    """A sequential JPEG may hold a scan per component; cv2 decodes the
    rewritten file to the original's pixels, and so must the port."""
    for h, w in ((37, 53), (16, 24)):
        data = encode(textured(np.random.RandomState(h), h, w), cv2.IMWRITE_JPEG_QUALITY, 90,
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"])
        split = _one_scan_per_component(data)
        assert split.count(b"\xff\xda") == 3
        want = cv2_decode(split)
        assert np.array_equal(want, cv2_decode(data))
        assert np.array_equal(jpeg.decode_jpeg(split), want)


def test_restart_markers_and_stuffed_bytes_survive_a_high_quality_noisy_image():
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (61, 77, 3)).astype(np.uint8)  # 0xFF bytes in the scan
    data = encode(img, cv2.IMWRITE_JPEG_QUALITY, 100, cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    assert b"\xff\x00" in data and b"\xff\xd7" in data
    assert np.array_equal(jpeg.decode_jpeg(data), cv2_decode(data))


def _replace_sof(data: bytes, marker: int) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:]


def test_unsupported_kinds_raise_naming_the_file(tmp_path):
    img = textured(np.random.RandomState(0), 24, 24)
    progressive = encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    path = tmp_path / "progressive.jpg"
    path.write_bytes(progressive)
    with pytest.raises(ValueError, match="progressive.jpg: progressive JPEG"):
        jpeg.read_jpeg(str(path))
    baseline = encode(img)
    with pytest.raises(ValueError, match="frame.jpg: arithmetic-coded sequential"):
        jpeg.decode_jpeg(_replace_sof(baseline, 0xC9), "frame.jpg")
    i = baseline.index(b"\xff\xc0") + 4
    twelve_bit = baseline[:i] + bytes([12]) + baseline[i + 1:]
    with pytest.raises(ValueError, match="frame.jpg: 12-bit"):
        jpeg.decode_jpeg(twelve_bit, "frame.jpg")
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG\r\n", "frame.jpg")


def test_extended_sequential_sof1_decodes_as_baseline():
    data = encode(textured(np.random.RandomState(5), 40, 56), cv2.IMWRITE_JPEG_QUALITY, 80)
    assert np.array_equal(jpeg.decode_jpeg(_replace_sof(data, 0xC1)), cv2_decode(data))


def test_readers_take_jpeg_by_content(tmp_path):
    data = encode(textured(np.random.RandomState(6), 20, 30))
    path = tmp_path / "frame.png"  # the suffix does not decide
    path.write_bytes(data)
    assert np.array_equal(read_image(str(path)), cv2_decode(data))
    assert np.array_equal(load_image(str(path)), cv2_decode(data).astype(np.float32))


def test_committed_fixtures_decode_to_the_cv2_digests():
    """data/fixtures/synth_scannet: each JPEG's cv2 pixels hash to its
    committed digest, the port's decoder gives the same pixels, and the
    files are what tests/make_synth_scannet.py writes (1296x968, 4:2:0)."""
    digests = synth_scannet.digests()
    paths = synth_scannet.jpeg_paths()
    assert len(digests) == len(paths) == synth_scannet.N_FRAMES
    total = 0
    for path, digest in zip(paths, digests):
        data = path.read_bytes()
        total += len(data)
        want = cv2_decode(data)
        assert want.shape == (968, 1296, 3)
        assert synth_scannet.pixel_digest(want) == digest
        got = jpeg.decode_jpeg(data, str(path))
        assert synth_scannet.pixel_digest(got) == digest
        sof = data.index(b"\xff\xc0")
        assert struct.unpack(">HH", data[sof + 5:sof + 9]) == (968, 1296)
        assert data[sof + 11] == 0x22  # luma 2x2: 4:2:0
    assert total < 1 << 20
