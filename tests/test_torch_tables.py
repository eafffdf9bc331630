"""The port's spec tables and per-session matrices equal the reference's.

The port transcribes the JPEG Annex K tables and the LDGM matrix builder once
more (the reference modules import jax, which the card's machine lacks), so
these tests hold every transcription to the reference bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ultragrid_tpu.ops import fec as ref_fec  # noqa: E402
from ultragrid_tpu.ops import jpeg as ref_jpeg  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu_torch.ops import fec as port_fec  # noqa: E402
from ultragrid_tpu_torch.ops import jpeg as port_jpeg  # noqa: E402
from ultragrid_tpu_torch.types import Codec  # noqa: E402


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", [
    "ZIGZAG", "QUANT_LUMA", "QUANT_CHROMA",
    "DC_LUMA_BITS", "DC_LUMA_VALS", "DC_CHROMA_BITS", "DC_CHROMA_VALS",
    "AC_LUMA_BITS", "AC_LUMA_VALS", "AC_CHROMA_BITS", "AC_CHROMA_VALS",
])
def test_annex_k_table(name):
    assert _bits_equal(getattr(port_jpeg, name), getattr(ref_jpeg, name))


@pytest.mark.parametrize("kind", ["DC_LUMA", "DC_CHROMA", "AC_LUMA", "AC_CHROMA"])
def test_build_huffman(kind):
    args = (getattr(ref_jpeg, kind + "_BITS"), getattr(ref_jpeg, kind + "_VALS"))
    for a, b in zip(port_jpeg.build_huffman(*args), ref_jpeg.build_huffman(*args)):
        assert _bits_equal(a, b)


def test_scale_quant_table_all_qualities():
    for q in range(0, 102):
        for base in (ref_jpeg.QUANT_LUMA, ref_jpeg.QUANT_CHROMA):
            assert _bits_equal(port_jpeg.scale_quant_table(base, q), ref_jpeg.scale_quant_table(base, q))


def test_dct_matrix_64():
    assert _bits_equal(port_jpeg.dct_matrix_64(), ref_jpeg.dct_matrix_64())


MEGA_CASES = [
    (codec, sub, q)
    for codec, sub in ((Codec.UYVY, None), (Codec.YUYV, None), (Codec.UYVY, "420"),
                       (Codec.YUYV, "420"), (Codec.RGB, None), (Codec.RGBA, None))
    for q in (80, 95)
]


@pytest.mark.parametrize("codec,sub,q", MEGA_CASES)
def test_mega_matrix_and_state(codec, sub, q):
    ref = ref_jpeg.JpegEncoder(64, 32, in_codec=RefCodec(codec), quality=q, subsampling=sub)
    enc = port_jpeg.JpegEncoder(64, 32, in_codec=codec, quality=q, subsampling=sub)
    W, const, bpr = ref._mega
    assert _bits_equal(enc.state["W"], W)
    assert _bits_equal(enc.state["const"], const)
    assert enc.bpr == bpr
    assert _bits_equal(enc.state["quant_luma"], ref.qtab_luma)
    assert _bits_equal(enc.state["quant_chroma"], ref.qtab_chroma)
    for key, attr in (("dc_luma", "_dc_l"), ("dc_chroma", "_dc_c"), ("ac_luma", "_ac_l"), ("ac_chroma", "_ac_c")):
        for a, b in zip(enc.state[key], getattr(ref, attr)):
            assert _bits_equal(a, b)


# |S_g| of each 64-column block group: the bytes that feed the block
SUPPORT = {(Codec.UYVY, None): [64] * 4, (Codec.YUYV, None): [64] * 4,
           (Codec.UYVY, "420"): [64] * 4 + [128] * 2, (Codec.YUYV, "420"): [64] * 4 + [128] * 2,
           (Codec.RGB, None): [192] * 3, (Codec.RGBA, None): [192] * 3}


@pytest.mark.parametrize("codec,sub,q", MEGA_CASES)
def test_support_plan(codec, sub, q):
    """The compact front end's plan: S_g ascending, every skipped row of W
    zero in that group, Wc_g = W[S_g, group], equal Wc_g stored once."""
    enc = port_jpeg.JpegEncoder(64, 32, in_codec=codec, quality=q, subsampling=sub)
    W = enc.state["W"]
    rows, groups, wc = port_jpeg.support_plan(W)
    assert groups[:, 2].tolist() == SUPPORT[(codec, sub)]
    distinct = set()
    for g, (ro, wo, n) in enumerate(groups):
        s = rows[ro: ro + n]
        assert np.all(np.diff(s) > 0)
        cols = W[:, 64 * g: 64 * g + 64]
        assert not cols[np.setdiff1d(np.arange(W.shape[0]), s)].any()
        assert (cols[s] != 0).any(axis=1).all()
        assert _bits_equal(wc[wo: wo + n], cols[s])
        distinct.add(wo)
    assert len(wc) == sum(int(groups[groups[:, 1] == wo][0, 2]) for wo in distinct)
    assert len(distinct) == (3 if codec in (Codec.RGB, Codec.RGBA) else 2)


@pytest.mark.parametrize("w,h,codec,q,ri,sub", [
    (64, 16, Codec.UYVY, 80, None, None),
    (80, 16, Codec.UYVY, 80, 3, None),
    (64, 32, Codec.YUYV, 95, 2, "420"),
    (64, 16, Codec.RGB, 85, 4, None),
    (1920, 1080, Codec.UYVY, 80, None, None),
])
def test_header_bytes(w, h, codec, q, ri, sub):
    ref = ref_jpeg.JpegEncoder(w, h, in_codec=RefCodec(codec), quality=q, restart_interval=ri, subsampling=sub)
    enc = port_jpeg.JpegEncoder(w, h, in_codec=codec, quality=q, restart_interval=ri, subsampling=sub)
    assert enc.restart_interval == ref.restart_interval
    assert enc.nseg == ref.nseg
    assert enc._header == ref._header


def test_geometry_without_mega_matrix_raises():
    # UYVY forced to 4:4:4 has no mega formulation in the reference either:
    # both take the per-plane front end (tests/test_torch_session.py holds
    # its files to the reference's stages), and its header is the reference's
    ref = ref_jpeg.JpegEncoder(64, 16, in_codec=RefCodec.UYVY, subsampling="444")
    assert ref._mega is None
    enc = port_jpeg.JpegEncoder(64, 16, in_codec=Codec.UYVY, subsampling="444")
    assert enc.per_plane and enc.plan is None and enc._header == ref._header
    # 4:2:0 from RGB has no front end at all: both raise the same error
    with pytest.raises(ValueError, match="4:2:0 encode supports UYVY/YUYV input"):
        ref_jpeg.JpegEncoder(64, 16, in_codec=RefCodec.RGB, subsampling="420")
    with pytest.raises(ValueError, match="4:2:0 encode supports UYVY/YUYV input"):
        port_jpeg.JpegEncoder(64, 16, in_codec=Codec.RGB, subsampling="420")


@pytest.mark.parametrize("k,m,c", [(8, 4, 3), (32, 6, 4), (32, 16, 5), (64, 12, 3), (256, 26, 5), (1500, 240, 5)])
def test_ldgm_matrix(k, m, c):
    assert _bits_equal(port_fec.build_ldgm_matrix(k, m, c, 1), ref_fec.build_ldgm_matrix(k, m, c, 1))


def test_rand_pmms_sequence():
    a, b = port_fec.RandPmms(12345), ref_fec.RandPmms(12345)
    assert [a.rand(1000) for _ in range(200)] == [b.rand(1000) for _ in range(200)]
