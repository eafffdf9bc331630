"""The port's multi-device path (``ultragrid_tpu_torch/parallel``) against the
JAX reference's (``ultragrid_tpu/parallel``).

The reference runs on JAX's 8 virtual CPU devices (``tests/conftest.py``),
the port on ``make_mesh(8, device="cpu")``: eight bands on the CPU, each
computed where a card would compute it.  One test here for each of the 12 in
``tests/test_parallel.py``, on the same seeded numpy inputs, and a few for
what the port adds (the block helpers, K2 over a sliced mask, the
column-sharded parity of the dry run).

Tolerance: byte-equal, with one bound.  Below 64 MCUs XLA's CPU dot sums in
another order than the fused multiply-add chain that the port and the
reference's larger frames use (``tests/test_torch_jpeg.py``,
``test_front_end_summation_order_bound``): the reference's own sizes (bands
of 12 to 32 MCUs) are held to that bound, coefficients off by at most one and
the blocks that differ exactly those whose coefficients do; bands of 64 MCUs
and more are held to byte equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ultragrid_tpu.ops import jpeg as ref_jpeg  # noqa: E402
from ultragrid_tpu.ops import pixfmt as ref_pixfmt  # noqa: E402
from ultragrid_tpu.ops import postprocess as ref_post  # noqa: E402
from ultragrid_tpu.ops.fec import build_ldgm_matrix as ref_ldgm_matrix  # noqa: E402
from ultragrid_tpu.ops.fec import gf2_matmul as ref_gf2_matmul  # noqa: E402
from ultragrid_tpu.parallel import mesh as ref_mesh  # noqa: E402
from ultragrid_tpu.parallel import sharded_h264 as ref_h264  # noqa: E402
from ultragrid_tpu.parallel import sharded_jpeg as ref_sj  # noqa: E402
from ultragrid_tpu.parallel import sharded_post as ref_sp  # noqa: E402
from ultragrid_tpu.types import Codec, vc_get_linesize  # noqa: E402
from ultragrid_tpu_torch import types as port_types  # noqa: E402
from ultragrid_tpu_torch.ops import fec as port_fec  # noqa: E402
from ultragrid_tpu_torch.ops import h264_dec as port_h264_dec  # noqa: E402
from ultragrid_tpu_torch.ops import jpeg as port_jpeg  # noqa: E402
from ultragrid_tpu_torch.ops import pixfmt as port_pixfmt  # noqa: E402
from ultragrid_tpu_torch.ops import postprocess as port_post  # noqa: E402
from ultragrid_tpu_torch.parallel import Mesh, make_mesh, replicated, shard_batch, shard_frame_rows  # noqa: E402
from ultragrid_tpu_torch.parallel import sharded_h264 as port_h264  # noqa: E402
from ultragrid_tpu_torch.parallel import sharded_jpeg as port_sj  # noqa: E402
from ultragrid_tpu_torch.parallel import sharded_post as port_sp  # noqa: E402
from ultragrid_tpu_torch.parallel.dryrun import column_sharded_parity, dryrun_multichip  # noqa: E402

NSH = 8


def cpu_mesh(n=NSH, data=1):
    return make_mesh(n, data=data, device="cpu")


def gather(blocks) -> np.ndarray:
    """Test-only: the row blocks of one frame, concatenated on the host."""
    return np.concatenate([b.cpu().numpy() for b in blocks])


def uyvy(w, h, seed, kind="noise"):
    ls = vc_get_linesize(w, Codec.UYVY)
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, ls), dtype=np.uint8)
    base = np.linspace(16, 235, ls, dtype=np.float32)[None, :] + rng.normal(0, 6, (h, ls))
    return base.clip(16, 235).astype(np.uint8)


def band_coefficients_agree(frame, ref_local, port_local, nsh=NSH):
    """The summation-order bound, band by band: the reference's XLA dot and
    the port's chain give coefficients off by at most one.  Returns, per
    band, the blocks (luma, Cb, Cr indices) whose coefficients differ."""
    W, const, bpr = ref_local._mega
    lh = frame.shape[0] // nsh
    differ = []
    for s in range(nsh):
        band = frame[s * lh:(s + 1) * lh]
        mb = band[:, : ref_local.nmcux * bpr].reshape(ref_local.nmcuy, 8, ref_local.nmcux, bpr)
        mb = mb.transpose(0, 2, 1, 3).reshape(ref_local.nmcu, 8 * bpr)
        q_ref = np.asarray(jnp.round(jnp.dot(jnp.asarray(mb, jnp.float32), jnp.asarray(W)) - jnp.asarray(const)))
        q_port = port_local.front_end(torch.as_tensor(band)).numpy()
        d = np.abs(q_ref - q_port)
        assert d.max() <= 1
        # per component, blocks in encode order: [nblocks, 64]
        comps = (d[:, :128].reshape(-1, 64), d[:, 128:192], d[:, 192:])
        # a block's slots change with its coefficients, and the next block's
        # with its DC (the next block codes the DC difference)
        differ.append(tuple(set(np.flatnonzero((c != 0).any(1))) | set(np.flatnonzero(c[:, 0] != 0) + 1)
                            for c in comps))
    return differ


def assert_slots_match(ref_parts, port_bands, differ=None):
    """The port's per-band (ys, ybits, us, ubits, vs, vbits), concatenated,
    against the reference's global arrays: equal, or (with ``differ``, the
    sub-64-MCU bound) equal outside the blocks whose coefficients differ."""
    for i in range(6):
        p = np.concatenate([b[i].numpy() for b in port_bands])
        r = np.asarray(ref_parts[i])
        r = r.view(np.int32) if r.dtype == np.uint32 else r.astype(np.int32)
        assert p.shape == r.shape, i
        rows = (p != r) if p.ndim == 1 else (p != r).any(1)
        bad = set(np.flatnonzero(rows))
        if differ is None:
            assert not bad, f"part {i}: {len(bad)} blocks differ"
            continue
        per_band = len(p) // len(differ)
        allowed = {s * per_band + j for s, d in enumerate(differ) for j in d[i // 2]}
        assert bad <= allowed, f"part {i}: blocks {sorted(bad - allowed)} differ with equal coefficients"


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_creation():
    mesh = cpu_mesh(8, data=2)
    assert mesh.shape == {"data": 2, "spatial": 4} == dict(ref_mesh.make_mesh(8, data=2).shape)
    # hashable and equal by its devices
    assert mesh == cpu_mesh(8, data=2) and hash(mesh) == hash(cpu_mesh(8, data=2))
    assert mesh != cpu_mesh(8, data=1)
    rep = make_mesh(devices=["cpu"] * 4)
    assert rep.shape == {"data": 1, "spatial": 4} and rep.spatial == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="mesh 3x"):
        make_mesh(8, data=3, device="cpu")


def test_block_helpers_split_without_gathering():
    mesh = cpu_mesh(8, data=2)
    frames = np.arange(2 * 16 * 6, dtype=np.uint8).reshape(2, 16, 6)
    blocks = shard_batch(frames, mesh)
    assert len(blocks) == 2 and all(len(row) == 4 for row in blocks)
    for d in range(2):
        assert np.array_equal(np.concatenate([b.numpy() for b in blocks[d]], axis=1), frames[d:d + 1])
    rows = shard_frame_rows(frames[0], cpu_mesh())
    assert [b.shape for b in rows] == [(2, 6)] * 8 and np.array_equal(gather(rows), frames[0])
    assert len(replicated(frames[0], mesh)) == 8
    with pytest.raises(ValueError, match="do not split"):
        shard_frame_rows(frames[0][:15], cpu_mesh())


def test_sharded_conversion_matches_single():
    w, h = 192, 128
    frame = uyvy(w, h, 1, "content")
    ref = np.asarray(ref_pixfmt.convert_frame(frame, w, Codec.UYVY, Codec.RGB))
    bands = shard_frame_rows(frame, cpu_mesh())
    out = [port_pixfmt.convert_frame(b, w, port_types.Codec.UYVY, port_types.Codec.RGB) for b in bands]
    assert np.array_equal(gather(out), ref)
    # data x spatial: each frame of a batch over its row of devices
    mesh = cpu_mesh(8, data=2)
    batch = np.stack([frame, uyvy(w, h, 2, "content")])
    for d, row in enumerate(shard_batch(batch, mesh)):
        got = np.concatenate([port_pixfmt.convert_frame(b[0], w, port_types.Codec.UYVY,
                                                        port_types.Codec.RGB).numpy() for b in row])
        assert np.array_equal(got, np.asarray(ref_pixfmt.convert_frame(batch[d], w, Codec.UYVY, Codec.RGB)))


# ---------------------------------------------------------------------------
# sharded JPEG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w,h,kind", [(192, 128, "content"), (256, 256, "noise")])
def test_sharded_jpeg_bit_identical(w, h, kind):
    """The sharded file equals the port's single-device encode with the same
    restart interval, and the reference's sharded file (192x128: bands of 24
    MCUs, held to the bound; 256x256: bands of 64 MCUs, byte-equal)."""
    frame = uyvy(w, h, 3, kind)
    port = port_sj.ShardedJpegEncoder(w, h, cpu_mesh(), quality=85)
    got = port.encode(frame)
    single = port_jpeg.JpegEncoder(w, h, quality=85, restart_interval=port.local.restart_interval)
    assert np.array_equal(got, single.encode(frame, device="cpu"))
    ref = ref_sj.ShardedJpegEncoder(w, h, ref_mesh.make_mesh(8, data=1), in_codec=Codec.UYVY, quality=85)
    assert ref.local.restart_interval == port.local.restart_interval
    if port.local.nmcu >= 64:
        assert np.array_equal(got, ref.encode(frame))
    else:
        differ = band_coefficients_agree(frame, ref.local, port.local)
        assert_slots_match(ref.encode_device(jnp.asarray(frame)), port.encode_device(frame), differ)


def test_sharded_jpeg_escalates_on_overflow():
    """Noise at a narrow slot window overflows: the encoder doubles the window
    until the file fits, and still equals the single-device encode."""
    w, h = 256, 256
    frame = uyvy(w, h, 4)
    port = port_sj.ShardedJpegEncoder(w, h, cpu_mesh(), quality=95)
    port.local.wwords = 2
    got = port.encode(frame)
    assert port.local.wwords > 2
    single = port_jpeg.JpegEncoder(w, h, quality=95, restart_interval=port.local.restart_interval)
    assert np.array_equal(got, single.encode(frame, device="cpu"))
    ref = ref_sj.ShardedJpegEncoder(w, h, ref_mesh.make_mesh(8, data=1), in_codec=Codec.UYVY, quality=95)
    assert np.array_equal(got, ref.encode(frame))


def test_sharded_jpeg_decodes():
    """The sharded file decodes with the port's decoder and, where Pillow is
    present, with Pillow (the reference test's decoder) to the same picture
    size."""
    w, h = 192, 128
    frame = uyvy(w, h, 5, "content")
    data = port_sj.ShardedJpegEncoder(w, h, cpu_mesh(), quality=90).encode(frame)
    uyvy_out, dh, dw = port_jpeg.JpegDecoder("cpu").decode_to_uyvy(data.tobytes())
    assert (dh, dw) == (h, w) and uyvy_out.shape == (h, 2 * w)
    assert float(np.abs(uyvy_out.numpy().astype(int) - frame.astype(int)).mean()) < 4
    try:
        from PIL import Image
    except ImportError:
        return
    import io

    img = Image.open(io.BytesIO(data.tobytes()))
    img.load()
    assert img.size == (w, h)


@pytest.mark.parametrize("w,h", [(256, 128), (256, 1024)])
def test_sharded_jpeg_decode_bit_identical(w, h):
    """ShardedJpegDecoder's bands, concatenated, equal the single-device
    decode byte for byte, and the reference's sharded decode (256x128: bands
    of 32 MCUs, held to the bound of the reverse product; 256x1024: 128
    MCUs, byte-equal)."""
    rng = np.random.default_rng(5)
    frame = (np.linspace(16, 235, 2 * w, dtype=np.float32)[None, :]
             + rng.normal(0, 6, (h, 2 * w))).clip(16, 235).astype(np.uint8)
    jpeg = bytes(port_jpeg.JpegEncoder(w, h, quality=85).encode(frame, device="cpu"))
    single = port_jpeg.JpegDecoder("cpu").decode_to_uyvy(jpeg)
    bands, dh, dw = port_sj.ShardedJpegDecoder(cpu_mesh()).decode_to_uyvy(jpeg)
    assert (dh, dw) == (h, w) and len(bands) == NSH
    got = gather(bands)
    assert np.array_equal(got, single[0].numpy())
    ref = np.asarray(ref_sj.ShardedJpegDecoder(ref_mesh.make_mesh()).decode_to_uyvy(jpeg)[0])
    assert got.shape == ref.shape
    d = np.abs(got.astype(int) - ref.astype(int))
    if (h // 8 // NSH) * (w // 16) >= 64:
        assert not d.any()
    else:
        assert d.max() <= 1 and (d != 0).mean() <= 0.001


def test_sharded_decoder_takes_the_single_path_where_rows_do_not_split():
    w, h = 64, 24  # 3 MCU rows over 8 bands
    frame = uyvy(w, h, 6, "content")
    jpeg = bytes(port_jpeg.JpegEncoder(w, h, quality=80).encode(frame, device="cpu"))
    bands, dh, dw = port_sj.ShardedJpegDecoder(cpu_mesh()).decode_to_uyvy(jpeg)
    assert len(bands) == 1 and torch.equal(bands[0], port_jpeg.JpegDecoder("cpu").decode_to_uyvy(jpeg)[0])


# ---------------------------------------------------------------------------
# sharded H.264
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_h264_au():
    """The reference's sharded access unit of 96x128 noise over 8 devices
    (one macroblock row each; one graph of XLA's, compiled once)."""
    w, h = 96, 128
    frame = np.random.default_rng(7).integers(0, 256, (h, 2 * w), dtype=np.uint8)
    return frame, bytes(ref_h264.ShardedH264Encoder(w, h, ref_mesh.make_mesh(8, data=1), qp=26).encode(frame))


def test_sharded_h264_bit_identical_and_conformant(ref_h264_au):
    """One slice per band: the access unit equals the reference's sharded
    one byte for byte and decodes with the port's own decoder."""
    frame, ref = ref_h264_au
    w, h = 96, 128
    bs = port_h264.ShardedH264Encoder(w, h, cpu_mesh(), qp=26).encode(frame)
    assert bs == ref
    oy, _, _ = port_h264_dec.IntraDecoder().decode(bs)
    assert oy.shape == (h, w)
    src = frame[:, 1::2].astype(np.float64)
    assert ((oy.astype(np.float64) - src) ** 2).mean() < 400


def test_sharded_h264_escalates_on_overflow(ref_h264_au):
    """A window of 2 words cannot hold a noise macroblock: the encoder
    doubles it until nothing overflows, and gives the same access unit."""
    frame, ref = ref_h264_au
    enc = port_h264.ShardedH264Encoder(96, 128, cpu_mesh(), qp=26, wwords=2)
    assert enc.encode(frame) == ref
    assert enc.wwords > 2


def test_multislice_decodes_with_own_decoder():
    """Three bands of two macroblock rows (96x96, qp 30) against one slice:
    slice resets change prediction, so the pictures differ slightly, but
    both decode close to the source with the own decoder.  The three-band
    access unit equals the reference's over three devices."""
    w, h = 96, 96
    frame = np.random.default_rng(3).integers(0, 256, (h, 2 * w), dtype=np.uint8)
    multi = port_h264.ShardedH264Encoder(w, h, cpu_mesh(3), qp=30).encode(frame)
    single = port_h264.ShardedH264Encoder(w, h, cpu_mesh(1), qp=30).encode(frame)
    ref = ref_h264.ShardedH264Encoder(w, h, ref_mesh.make_mesh(3, data=1), qp=30).encode(frame)
    assert multi == bytes(ref)
    src = frame[:, 1::2].astype(np.float64)
    for bs in (single, multi):
        y, _, _ = port_h264_dec.IntraDecoder().decode(bs)
        assert y.shape == (h, w)
        assert ((y.astype(np.float64) - src) ** 2).mean() < 400


# ---------------------------------------------------------------------------
# the halo deinterlace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["blend", "linear"])
@pytest.mark.parametrize("codec", [Codec.UYVY, Codec.v210, Codec.RG48])
def test_sharded_deinterlace_bit_identical(kind, codec):
    """Halo deinterlace over 8 bands == the whole-frame op in the port and
    the reference's sharded op."""
    w, h = 96, 8 * 4
    frame = np.random.default_rng(3).integers(0, 256, (h, vc_get_linesize(w, codec)), dtype=np.uint8)
    pc = port_types.Codec(codec)
    whole = (port_post.deinterlace_blend if kind == "blend" else port_post.deinterlace_linear)(
        torch.as_tensor(frame), pc)
    bands = port_sp.sharded_deinterlace(frame, pc, cpu_mesh(), kind=kind)
    assert len(bands) == NSH
    got = gather(bands)
    assert np.array_equal(got, whole.numpy())
    assert np.array_equal(got, ref_sp.sharded_deinterlace(frame, codec, ref_mesh.make_mesh(8, data=1), kind=kind))
    host = ref_post.deinterlace_blend(frame, codec) if kind == "blend" else ref_post.deinterlace_linear(frame, codec)
    assert np.array_equal(got, np.asarray(host))


@pytest.mark.parametrize("kind", ["blend", "linear"])
def test_make_sharded_deinterlace_equals_the_reference(kind):
    """The cached callable over the row blocks: the same object for the same
    mesh, codec and kind, as the reference's ``lru_cache``, and bands equal
    to the reference's callable over its sharded array."""
    from jax.sharding import NamedSharding, PartitionSpec

    w, h = 96, 8 * 4
    frame = np.random.default_rng(5).integers(0, 256, (h, vc_get_linesize(w, Codec.UYVY)), dtype=np.uint8)
    mesh, pc = cpu_mesh(), port_types.Codec.UYVY
    fn = port_sp.make_sharded_deinterlace(mesh, pc, kind)
    assert port_sp.make_sharded_deinterlace(mesh, pc, kind) is fn
    got = gather(fn(shard_frame_rows(frame, mesh)))
    rmesh = ref_mesh.make_mesh(8, data=1)
    sharded = jax.device_put(jnp.asarray(frame), NamedSharding(rmesh, PartitionSpec("spatial", None)))
    assert np.array_equal(got, np.asarray(ref_sp.make_sharded_deinterlace(rmesh, Codec.UYVY, kind)(sharded)))
    with pytest.raises(ValueError, match="row blocks"):
        fn(shard_frame_rows(frame, mesh)[:-1])


def test_sharded_deinterlace_rejects_odd_blocks():
    frame = np.zeros((8 * 3, 64), np.uint8)  # 3 rows a block: odd
    with pytest.raises(ValueError, match="even-height"):
        port_sp.sharded_deinterlace(frame, port_types.Codec.UYVY, cpu_mesh())


def test_sharded_deinterlace_over_one_device_named_four_times():
    """Four bands on one device, as on one card: each band's halo is the
    next band's first row, and the bands are the whole-frame op's rows."""
    w, h = 96, 4 * 6
    frame = torch.as_tensor(np.random.default_rng(4).integers(0, 256, (h, 2 * w), dtype=np.uint8))
    mesh = make_mesh(devices=["cpu"] * 4)
    for kind, whole in (("blend", port_post.deinterlace_blend), ("linear", port_post.deinterlace_linear)):
        bands = port_sp.sharded_deinterlace(frame, port_types.Codec.UYVY, mesh, kind=kind)
        assert [b.shape[0] for b in bands] == [h // 4] * 4
        assert torch.equal(torch.cat(bands), whole(frame, port_types.Codec.UYVY))


# ---------------------------------------------------------------------------
# the sender and receiver steps
# ---------------------------------------------------------------------------


def host_ldgm(mask, sym, m):
    """Independent host LDGM (staircase) over a band's [k, ps] container."""
    expect = np.zeros((m, sym.shape[1]), np.uint8)
    for i in range(m):
        acc = np.zeros(sym.shape[1], np.uint8)
        for j in np.nonzero(mask[i])[0]:
            acc ^= sym[j]
        if i:
            acc ^= expect[i - 1]
        expect[i] = acc
    return expect


@pytest.mark.parametrize("w,h", [(96, 128), (256, 256)])
def test_sharded_sender_step_per_shard_byte_identity(w, h):
    """Every band's slots and parity equal a single-device encode of the
    band plus host LDGM over its container, and the reference's sharded
    step (96x128: bands of 12 MCUs, the bound; 256x256: 64 MCUs, equal)."""
    k, m, c = 16, 6, 3
    frame = uyvy(w, h, 8)
    step = port_sj.ShardedSenderStep(w, h, cpu_mesh(), quality=80, k=k, m=m, c=c)
    bands = step(frame)
    assert len(bands) == NSH
    local = step.base.local
    ref_enc = port_jpeg.JpegEncoder(w, h // NSH, quality=80, restart_interval=local.restart_interval)
    mask = port_fec.build_ldgm_matrix(k, m, c, 1)
    for s, band in enumerate(bands):
        src = torch.as_tensor(frame[s * (h // NSH):(s + 1) * (h // NSH)])
        want = ref_enc.encode_plain(src)
        assert not bool(want[-1]) and not bool(band[7])
        for a, b in zip(band[:6], want[:6]):
            assert torch.equal(a, b)
        sym = port_sj.band_symbols(band, step.row_counts, step.ps, k)
        assert np.array_equal(band[6].numpy(), host_ldgm(mask, sym[:k], m))
    ref = ref_sj.ShardedSenderStep(w, h, ref_mesh.make_mesh(8, data=1), quality=80, k=k, m=m, c=c)
    assert (ref.ps, list(ref.row_counts)) == (step.ps, step.row_counts)
    ref_out = ref(frame)
    if local.nmcu >= 64:
        assert_slots_match(ref_out, bands)
        assert np.array_equal(np.concatenate([b[6].numpy() for b in bands]), np.asarray(ref_out[6]))
    else:
        differ = band_coefficients_agree(frame, ref.base.local, local)
        assert_slots_match(ref_out, bands, differ)
        ref_par = np.asarray(ref_out[6]).reshape(NSH, m, step.ps)
        for s in range(NSH):
            if not any(differ[s]):
                assert np.array_equal(bands[s][6].numpy(), ref_par[s])


def test_sliced_mask_parity_equals_reference_gf2_matmul():
    """K2's plain version over the parts with the mask cut to the parts'
    rows equals the reference's ``gf2_matmul`` (staircase on) over the whole
    zero-padded [k, ps] container, the rows past the parts zero (LDGM
    256:26:5, the flagship code: 12 such rows)."""
    w, h, k, m, c = 256, 256, 256, 26, 5
    step = port_sj.ShardedSenderStep(w, h, cpu_mesh(), quality=80, k=k, m=m, c=c)
    assert sum(step.row_counts) < k
    for band in step(uyvy(w, h, 9)):
        sym = port_sj.band_symbols(band, step.row_counts, step.ps, k)[:k]
        want = np.asarray(ref_gf2_matmul(jnp.asarray(ref_ldgm_matrix(k, m, c, 1).astype(np.float32)),
                                         jnp.asarray(sym), True))
        assert np.array_equal(band[6].numpy(), want)


def test_column_sharded_parity_equals_reference():
    """The dry run's step 1b: the whole frame's container with its symbol
    columns over 8 devices, each strip's parity by K2's plain version; the
    strips, concatenated, equal the reference's ``gf2_matmul``."""
    w, h, k, m, c = 96, 128, 8, 4, 3
    frame = uyvy(w, h, 10)
    enc = port_sj.ShardedJpegEncoder(w, h, cpu_mesh(), quality=80)
    parts = enc.encode_device(frame)
    strips, ps = column_sharded_parity(parts, cpu_mesh(), k, m, c)
    got = np.concatenate([s.numpy() for s in strips], axis=1).view(np.uint8)
    payload = np.concatenate([np.concatenate([p[i].numpy().reshape(-1) for p in parts]).view(np.uint8)
                              for i in range(6)])
    data = np.zeros(k * ps, np.uint8)
    data[4: 4 + payload.size] = payload
    want = np.asarray(ref_gf2_matmul(jnp.asarray(ref_ldgm_matrix(k, m, c, 1).astype(np.float32)),
                                     jnp.asarray(data.reshape(k, ps)), True))
    assert np.array_equal(got, want)


def _peels(matrix, k, m, have):
    """Host check that the data rows are recoverable."""
    rows = []
    for i in range(m):
        cols = [int(j) for j in np.nonzero(matrix[i])[0]] + [k + i] + ([k + i - 1] if i else [])
        rows.append(cols)
    changed = True
    while changed and not have[:k].all():
        changed = False
        for cols in rows:
            missing = [j for j in cols if not have[j]]
            if len(missing) == 1:
                have[missing[0]] = True
                changed = True
    return bool(have[:k].all())


@pytest.mark.parametrize("w,h", [(96, 128), (256, 256)])
def test_sharded_receiver_step_recovers_and_matches_single_chip(w, h):
    """Per-band erasures within the code's reach: every band comes back and
    equals a single-device decode of that band's stream, and the reference's
    receiver step on the same symbols (96x128: bands of 12 MCUs, the
    bound of the reverse product; 256x256: equal).  A band beyond reach is
    decoded from zero coefficients and flagged; the others are unchanged."""
    k, m, c = 16, 6, 3
    frame = uyvy(w, h, 11)
    step = port_sj.ShardedSenderStep(w, h, cpu_mesh(), quality=80, k=k, m=m, c=c)
    sym = np.stack([port_sj.band_symbols(b, step.row_counts, step.ps, k) for b in step(frame)])
    mask = port_fec.build_ldgm_matrix(k, m, c, 1)
    rng = np.random.default_rng(7)
    present = np.ones((NSH, k + m), bool)
    for s in range(NSH):
        for _ in range(50):
            pr = np.ones(k + m, bool)
            pr[rng.choice(k + m, size=2 + (s % 3), replace=False)] = False
            if not pr[:k].all() and _peels(mask, k, m, pr.copy()):
                present[s] = pr
                break
        else:
            pytest.fail("no recoverable loss pattern found")
    lossy = sym.copy()
    lossy[~present] = 0
    rx = port_sj.ShardedReceiverStep(w, h, cpu_mesh(), quality=80, k=k, m=m, c=c,
                                     wwords=step.base.local.wwords)
    bands, ok = rx(lossy, present)
    assert ok.all() and len(bands) == NSH and max(rx.rounds) >= 1
    out = gather(bands)
    lh = h // NSH
    enc = port_jpeg.JpegEncoder(w, lh, quality=80, restart_interval=step.base.local.restart_interval)
    dec = port_jpeg.JpegDecoder("cpu")
    for s in range(NSH):
        band_file = bytes(enc.encode(frame[s * lh:(s + 1) * lh], device="cpu"))
        assert np.array_equal(out[s * lh:(s + 1) * lh], dec.decode_to_uyvy(band_file)[0].numpy())
    ref_rx = ref_sj.ShardedReceiverStep(w, h, ref_mesh.make_mesh(8, data=1), quality=80, k=k, m=m, c=c,
                                        wwords=step.base.local.wwords)
    ref_uyvy, ref_ok = ref_rx(lossy, present)
    assert ref_ok.all()
    d = np.abs(out.astype(int) - np.asarray(ref_uyvy).astype(int))
    if step.base.local.nmcu >= 64:
        # the sender's symbols came from the port: equal coefficients, and
        # the reverse product in the chain order on both sides
        assert not d.any()
    else:
        assert d.max() <= 1 and (d != 0).mean() <= 0.001

    present2 = present.copy()
    present2[3, : m + 1] = False
    present2[3, k:] = False
    lossy2 = sym.copy()
    lossy2[~present2] = 0
    bands2, ok2 = rx(lossy2, present2)
    assert not ok2[3] and ok2[np.arange(NSH) != 3].all()
    out2 = gather(bands2)
    keep = np.r_[0:3 * lh, 4 * lh:h]
    assert np.array_equal(out2[keep], out[keep])
    ref2, ref_ok2 = ref_rx(lossy2, present2)
    assert np.array_equal(ref_ok2, ok2)
    zero = port_jpeg.JpegDecoder("cpu")._make_mega_uyvy_fn(
        port_jpeg._parse_headers(band_file), w // 16, lh // 8)(
        torch.zeros(w // 16 * lh // 8 * 2, 64, dtype=torch.int16),
        torch.zeros(w // 16 * lh // 8, 64, dtype=torch.int16), torch.zeros(w // 16 * lh // 8, 64, dtype=torch.int16))
    assert np.array_equal(out2[3 * lh:4 * lh], zero.numpy())
    assert np.array_equal(out2[3 * lh:4 * lh], np.asarray(ref2)[3 * lh:4 * lh])


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,devices", [(8, None), (4, ["cpu"] * 4), (3, None)])
def test_dryrun_multichip(n, devices):
    """The port's dry run, all seven steps and their asserts, on 8 CPU
    entries, on four bands of one device named four times, and on an odd
    count (the data axis then 1)."""
    dryrun_multichip(n, device="cpu", devices=devices)


def test_mesh_is_a_value():
    mesh = Mesh(((torch.device("cpu"),) * 2,))
    assert mesh == cpu_mesh(2) and {mesh: 1}[cpu_mesh(2)] == 1
