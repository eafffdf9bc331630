"""The JPEG entropy decode that runs on the card (``ops/jpeg_decode_cuda.py``,
``csrc/jpeg_decode.cu``), through its plain PyTorch version on the CPU,
against the C scan decoder (``native/jpeg_scan_decode.c``), and
``JpegDecoder.decode_to_uyvy``'s card route (here with the plain version
in the kernel's place) against its C route.

q must equal the C decoder's coefficients exactly (integers, widened to
float32 in ``packed_coefficients``' layout); the pixels of the two routes
must be equal byte for byte (the same q, the same product).  The card
test of the kernel itself is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from ultragrid_tpu_torch.ops import jpeg
from ultragrid_tpu_torch.ops import jpeg_decode_cuda as jd
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame, vc_get_linesize
from ultragrid_tpu_torch.utils import profiler


@pytest.fixture
def trace():
    """The profiler on, its records cleared before and after."""
    saved = profiler.enabled
    profiler.enabled = True
    profiler._events.clear()
    yield profiler._events
    profiler.enabled = saved
    profiler._events.clear()


def uyvy(w, h, seed, noise=False):
    ls = vc_get_linesize(w, Codec.UYVY)
    rng = np.random.default_rng(seed)
    if noise:
        return rng.integers(0, 256, (h, ls), dtype=np.uint8)
    base = np.linspace(0, 255, ls, dtype=np.float32)[None, :] + rng.normal(0, 8, (h, ls))
    return base.clip(16, 235).astype(np.uint8)


def encode(w, h, q=80, ri=None, noise=False):
    return bytes(jpeg.JpegEncoder(w, h, quality=q, restart_interval=ri).encode(uyvy(w, h, q, noise), device="cpu"))


def c_coefficients(data):
    """The C decoder's int16 blocks, widened into q's layout."""
    hdr, (cy, cu, cv), nmcux, nmcuy = jpeg.entropy_decode_422(data)
    nmcu = nmcux * nmcuy
    return torch.cat([torch.as_tensor(cy).view(nmcu, 128), torch.as_tensor(cu), torch.as_tensor(cv)], 1).float()


def plain_decode(data):
    hdr = jpeg._parse_headers(data)
    nmcu = ((hdr["w"] + 15) // 16) * ((hdr["h"] + 7) // 8)
    file = torch.zeros(len(data) + jd.PAD, dtype=torch.uint8)
    file[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    tables = torch.as_tensor(jd.huffman_tables(hdr["htabs"]))
    q, status = jd.segment_decode(file, len(data), hdr["scan_start"], tables,
                                  tuple(c["td"] for c in hdr["scan"]), nmcu, hdr["ri"])
    return q, status.tolist(), nmcu, -(-nmcu // hdr["ri"])


def card_route_decoder():
    """A CPU decoder that takes the card route, the plain version in the
    kernel's place."""
    dec = jpeg.JpegDecoder("cpu")
    dec._card = True
    return dec


def without_dri(data):
    i = data.index(b"\xff\xdd")
    return data[:i] + data[i + 6:]


def corrupt_segment(data, seg):
    """Segment ``seg``'s bytes overwritten with stuffed 0xFF: all-ones bits,
    no code of the Annex K tables."""
    hdr = jpeg._parse_headers(data)
    rst = [i for i in range(hdr["scan_start"], len(data) - 1)
           if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    out = bytearray(data)
    for i in range(rst[seg - 1] + 2, rst[seg] - 1, 2):
        out[i: i + 2] = b"\xff\x00"
    return bytes(out)


def extra_marker(data):
    """A stuffed 0x00 after a 0xFF of the scan's middle turned into 0xD3: one
    RST marker more than the restart interval gives."""
    hdr = jpeg._parse_headers(data)
    i = next(i for i in range((hdr["scan_start"] + len(data)) // 2, len(data) - 1)
             if data[i] == 0xFF and data[i + 1] == 0x00)
    return data[: i + 1] + b"\xd3" + data[i + 2:]


def trim_segments(data):
    """(``data`` with the last byte of every segment dropped where the C
    decoder still decodes it, so that only its last symbol's extension is
    cut and reads as 0; those segments; ``data`` with the last byte of one
    other segment dropped, which the C decoder refuses)"""
    hdr = jpeg._parse_headers(data)
    rst = [i for i in range(hdr["scan_start"], len(data) - 1)
           if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    cut, refused = [], None
    for r in rst:
        if data[r - 2] == 0xFF:  # a stuffed 0xFF 0x00 before the marker
            continue
        try:
            jpeg.entropy_decode_422(data[: r - 1] + data[r:])
            cut.append(r)
        except ValueError:
            refused = refused or data[: r - 1] + data[r:]
    out = bytearray(data)
    for r in reversed(cut):
        del out[r - 1]
    return bytes(out), [rst.index(r) for r in cut], refused


def outcome(fn):
    try:
        return fn().data
    except (ValueError, EOFError, IndexError) as exc:
        return repr(exc)


STREAMS = [(w, h, q, ri) for w, h in ((1920, 1080), (208, 56)) for q in (50, 80, 95) for ri in (None, 1)]
CASES = ([pytest.param("stream", s, id=f"{s[0]}x{s[1]}-q{s[2]}-ri{s[3] or 'default'}") for s in STREAMS]
         + [pytest.param(kind, None, id=kind)
            for kind in ("exceptions", "no DRI", "corrupt", "marker count", "last extension")])


@pytest.mark.parametrize("kind,stream", CASES)
def test_segment_decode_equals_c_decoder(kind, stream, trace):
    if kind == "stream":
        w, h, q, ri = stream
        data = encode(w, h, q, ri)
    elif kind == "exceptions":
        w, h = 512, 128
        data = encode(w, h, 100, noise=True)
        assert jpeg.entropy_decode_422_packed(data) is None  # more than _EXC_CAP coefficients above 127
    elif kind == "no DRI":
        w, h = 208, 56
        data = without_dri(encode(w, h, 80, ri=91))  # one segment; without DRI the C path decodes it
        assert jpeg._parse_headers(data)["ri"] == 0
    elif kind == "corrupt":
        w, h = 208, 56
        good = encode(w, h, 80)
        data = corrupt_segment(good, 40)
    elif kind == "marker count":
        w, h = 208, 56
        good = encode(w, h, 95, noise=True)
        data = extra_marker(good)
    else:
        w, h = 208, 56
        whole = encode(w, h, 100, ri=1, noise=True)  # coefficient 63 of many segments' last block is set
        data, cut, refused = trim_segments(whole)
        assert len(cut) >= 10
        q, status, nmcu, nseg = plain_decode(refused)
        assert status[0] == 1 and status[1] == nmcu - 1
        with pytest.raises(ValueError):
            card_route_decoder().decode_to_uyvy(refused)
        with pytest.raises(ValueError):
            jpeg.JpegDecoder("cpu").decode_to_uyvy(refused)
        trace.clear()

    dec = card_route_decoder()
    fallbacks = lambda: [r.args["reason"] for r in trace if r[0] == "decompress.fallback"]  # noqa: E731
    if kind == "no DRI":
        got = dec.decode_to_uyvy(data)
        assert dec.host_scans == 1 and fallbacks() == ["no DRI"]
        assert torch.equal(got[0], jpeg.JpegDecoder("cpu").decode_to_uyvy(data)[0])
        return

    q, status, nmcu, nseg = plain_decode(data)
    if kind in ("corrupt", "marker count"):
        if kind == "corrupt":
            assert status[0] >= 1 and status[1] < nmcu and status[2] == nseg - 1
        else:
            assert status == [0, 0, nseg, 0]
        # the card route refuses the scan, as the C route does
        refused = jd.REFUSED.count
        with pytest.raises(ValueError):
            dec.decode_to_uyvy(data)
        with pytest.raises(ValueError):
            jpeg.JpegDecoder("cpu").decode_to_uyvy(data)
        kept = dec._stream
        frame = VideoFrame(VideoDesc(w, h, Codec.JPEG, 60.0), [np.frombuffer(data, np.uint8)])
        got = outcome(lambda: jpeg.decode_jpeg_to_frame(frame, Codec.UYVY, dec))
        want = outcome(lambda: jpeg.decode_jpeg_to_frame(frame, Codec.UYVY, jpeg.JpegDecoder("cpu")))
        assert dec.host_scans == 0 and jd.REFUSED.count == refused + 2
        assert fallbacks() == 2 * ["status" if kind == "corrupt" else "offset count"]
        assert type(got) is type(want) and (got == want if isinstance(got, str) else torch.equal(got, want))
        # the good stream before the corruption goes through, with the same kept header
        assert torch.equal(dec.decode_to_uyvy(good)[0], jpeg.JpegDecoder("cpu").decode_to_uyvy(good)[0])
        assert dec.host_scans == 0 and dec._stream is kept
        return

    assert status == [0, nmcu, nseg - 1, 0]
    assert torch.equal(q, c_coefficients(data))
    if kind == "last extension":  # the cut extensions read as 0, as in the C decoder
        assert torch.nonzero(q != c_coefficients(whole)).tolist() == [[m, 255] for m in cut]
    if w * h <= 512 * 128:
        got = dec.decode_to_uyvy(data)
        want = jpeg.JpegDecoder("cpu").decode_to_uyvy(data)
        assert got[1:] == want[1:] == (h, w) and torch.equal(got[0], want[0])
        assert dec.host_scans == 0 and not fallbacks()
