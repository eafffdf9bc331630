"""The port stands alone: it imports neither JAX nor the JAX package (nor
Pillow, which the reference's JPEG 2000 decoder falls back to).

A subprocess blocks ``jax`` and ``ultragrid_tpu`` in ``sys.modules`` (so any
import of either, direct or indirect, fails) and drives the port with its own
types, down to a live session over 127.0.0.1, the H.264 codec, the wavelet and
intra codecs, audio with its record and replay (``audio/``, ``tools/``), and
standards mode, RTSP capture, the duplex call, the preview socket and
thumbnailgen, the multi-device path (``parallel/``: the mesh, the sharded
JPEG + LDGM sender and receiver steps, sharded H.264, the halo deinterlace
and the dry run), ``-e`` (``utils/crypto.py``), the file modules
(``modules/file_io.py``), the bench tools (``tools/bench_*.py``), the X11
client (``net/x11.py``) and the screen, v4l2, ``ug_input`` and hardware-stub
captures, and the last slice (the x11 and gl displays, libavcodec, the
libavcodec audio codecs, ``convert``, NAT traversal and its helper,
``~/.ug.rc``; the drm display, mpegts and the other tools imported) on the
CPU.  A source scan rejects any ``import`` of any of them in
the port (``audio/`` and ``tools/`` included), ``chip_smoke.py``,
``chip_profile.py``, ``chip_phases.py`` and the jax-free mock X server
``tests/torch_x11_mock.py``.
"""

import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["ultragrid_tpu"] = None
import numpy as np
import torch
import ultragrid_tpu_torch
from ultragrid_tpu_torch import Codec, VideoDesc, VideoFrame, get_device
from ultragrid_tpu_torch.models.encode import BatchedJpegLdgmPipeline, EncodeConfig, EncodePipeline
from ultragrid_tpu_torch.modules.video_compress import DxtCompress, JpegCompress, NoneCompress, UyvyCompress
from ultragrid_tpu_torch.modules.video_decompress import (DxtDecompress, I420Decompress, JpegDecompress,
                                                          JpegToDxtDecompress)
from ultragrid_tpu_torch.ops import _kutils, color, dxt, fec, jpeg_cuda, pixfmt, planar, postprocess
from ultragrid_tpu_torch.ops.jpeg import JpegBatchEncoder
from ultragrid_tpu_torch.ops.fec import LdgmSession, RsSession, fec_from_spec
from ultragrid_tpu_torch.ops.jpeg import JpegDecoder, decode_jpeg_device, decode_jpeg_to_frame
import ultragrid_tpu_torch.modules
from ultragrid_tpu_torch.modules import extra_displays, filters, registry, stitch, video_capture, video_display
from ultragrid_tpu_torch.modules.video_capture import TestcardCapture, initialize_video_capture
from ultragrid_tpu_torch.pipeline.loop import run_local_pipeline
from ultragrid_tpu_torch.utils import capabilities, log, pattern, tiling
from ultragrid_tpu_torch.ops import (h264, h264_8x8, h264_bslice, h264_cabac, h264_cabac_tables, h264_deblock,
                                     h264_dec, h264_device, h264_fast, h264_transcode)
from ultragrid_tpu_torch.modules.video_compress import H264Compress, SessionTranscoder
from ultragrid_tpu_torch.modules.video_decompress import OwnH264Decompress

assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
if not torch.cuda.is_available():
    try:
        get_device("cuda")
    except RuntimeError:
        pass
    else:
        raise SystemExit("get_device('cuda') did not raise")
assert get_device("cpu") == torch.device("cpu")

desc = VideoDesc(64, 32, Codec.UYVY, 30.0)
frame = np.random.default_rng(0).integers(0, 256, (32, 128), dtype=np.uint8)
if not torch.cuda.is_available():
    # the entry points select the card by default
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
    sess = LdgmSession(32, 16, 5)
    sym = np.zeros((48, 8), np.uint8)
    for make in (lambda: EncodePipeline(desc, EncodeConfig(compress="jpeg")),
                 lambda: JpegCompress("80"), lambda: JpegEncoder(64, 32).encode(frame),
                 lambda: JpegDecompress(), lambda: JpegDecoder(),
                 lambda: sess.decode_device(sym, np.ones(48, bool)),
                 lambda: sess.encode_device(sym[:32]), lambda: RsSession(4, 6).encode(sym[0]),
                 lambda: pixfmt.convert_frame(frame, 64, Codec.UYVY, Codec.RGB),
                 lambda: DxtCompress("DXT1"), lambda: DxtDecompress(), lambda: JpegToDxtDecompress(),
                 lambda: BatchedJpegLdgmPipeline(desc, 2),
                 lambda: JpegBatchEncoder(64, 32, 2).encode(np.stack([frame, frame])),
                 lambda: TestcardCapture("s=64x32"), lambda: initialize_video_capture("testcard:s=64x32"),
                 lambda: run_local_pipeline("testcard:s=64x32:f=1000", "dummy", 1),
                 lambda: h264_device.Intra16EncoderDevice(64, 32), lambda: h264_device.InterEncoderDevice(64, 32),
                 lambda: H264Compress("accel=device").compress(VideoFrame(desc, [frame])),
                 lambda: OwnH264Decompress()):
        try:
            make()
        except RuntimeError:
            pass
        else:
            raise SystemExit("an entry point ran without a card on its default device")
out = EncodePipeline(desc, EncodeConfig(compress="jpeg", fec="ldgm:32:16:5"), device="cpu")(frame)
assert len(out) == 8 and tuple(out[6].shape)[0] == 16
jpg = JpegCompress("80", device="cpu").compress(VideoFrame(desc, [frame])).data
assert bytes(jpg[:2]) == b"\xff\xd8" and bytes(jpg[-2:]) == b"\xff\xd9"
# the receive path on the CPU: LDGM over the file, two symbols lost, the
# peel, the decode to UYVY and to RGB
sess = fec_from_spec("ldgm:32:16:5")
buf, fd = sess.encode(jpg)
sym = buf.reshape(48, fd.symbol_size).copy()
present = np.ones(48, bool)
present[[1, 7]] = False
sym[~present] = 0
rec = sess.decode_device(sym, present, device="cpu")
assert np.array_equal(rec, jpg)
uyvy = JpegDecompress(device="cpu").decompress(VideoFrame(desc.with_(color_spec=Codec.JPEG), [rec]), Codec.UYVY)
assert tuple(uyvy.data.shape) == (32, 128) and uyvy.data.dtype == torch.uint8
rgb = decode_jpeg_to_frame(VideoFrame(desc.with_(color_spec=Codec.JPEG), [rec]), Codec.RGB, device="cpu")
assert tuple(rgb.data.shape) == (32, 192)
assert decode_jpeg_device(bytes(rec), device="cpu")[1:3] == (32, 64)
# the rest of the sender graph on the CPU: conversion, DXT with LDGM and
# RS, the batched JPEG + LDGM step, DXT and JPEG -> DXT decompression
rgb = pixfmt.convert_frame(frame, 64, Codec.UYVY, Codec.RGB, device="cpu")
assert tuple(rgb.shape) == (32, 192)
for spec in ("ldgm:8:4:3", "rs:8:12"):
    data, par = EncodePipeline(desc, EncodeConfig(compress="dxt1", fec=spec), device="cpu")(frame)
    assert data.numel() == 64 * 32 // 2 and par.shape[0] == 4
outs = BatchedJpegLdgmPipeline(desc, 2, fec="ldgm:8:4:3", device="cpu")(np.concatenate([frame, frame]))
assert tuple(outs[6].shape)[:2] == (2, 4)
d1 = DxtCompress("DXT1", device="cpu").compress(VideoFrame(desc.with_(color_spec=Codec.RGB), [rgb]))
back = DxtDecompress(device="cpu").decompress(d1, Codec.RGB)
assert tuple(back.data.shape) == (32, 192)
jd = JpegToDxtDecompress(device="cpu").decompress(VideoFrame(desc.with_(color_spec=Codec.JPEG), [rec]), Codec.DXT5)
assert jd.data.numel() == 64 * 32
# the local loop on the CPU: testcard -> filters -> postprocess -> display
got = []
extra_displays.register_pipe_delegate("iso", got.append)
n = run_local_pipeline("testcard:s=96x64:f=1000:c=UYVY", "pipe:iso", 3,
                       "deinterlace:blend,mirror,border", "scale:48x32", device="cpu")
assert n == 3 and len(got) == 4 and got[-1] is None and tuple(got[0].data.shape) == (32, 96)
assert capabilities.get_capabilities()["backend"] == "torch-cuda"
# the live session: every new module, the CLI, a loopback and a sender ->
# receiver pair over 127.0.0.1 on the CPU; each defaults to the card
import threading, time
from ultragrid_tpu_torch import cli, native
from ultragrid_tpu_torch.modules import messaging, video_compress, video_decompress
from ultragrid_tpu_torch.net import pbuf, rtcp, rtp, rtp_types, transmit, video_rx, vrx_fast
from ultragrid_tpu_torch.pipeline import loopback, receiver, sender
from ultragrid_tpu_torch.utils import control_socket, crash, keyboard, params, profiler, ratectl
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
if not torch.cuda.is_available():
    for make in (lambda: sender.VideoSender("testcard:s=64x32", "127.0.0.1"),
                 lambda: receiver.VideoReceiver("dummy", rx_port=0),
                 lambda: loopback.LoopbackRxTx("testcard:s=64x32", "dummy"),
                 lambda: video_compress.CompressDriver("jpeg"),
                 lambda: cli.main(["-t", "testcard:s=64x32", "-d", "dummy", "-x", "loopback", "--frames", "1"])):
        try:
            make()
        except RuntimeError:
            pass
        else:
            raise SystemExit("a live-session entry point ran without a card on its default device")
native.udp_tx_lib(); native.udp_rx_lib(); native.video_rx_fast_lib()
assert JpegEncoder(64, 32, in_codec=Codec.UYVY, subsampling="444").encode(frame, device="cpu")[:2].tobytes() == b"\xff\xd8"
assert cli.main(["-t", "testcard:s=64x32:f=1000:c=UYVY", "-d", "dummy", "-x", "loopback", "-c", "jpeg:80:rate=1M",
                 "--frames", "2", "--device", "cpu"]) == 0
import socket
while True:  # a UDP port p with p + 1 free too (RTP and RTCP)
    a, b = socket.socket(socket.AF_INET, socket.SOCK_DGRAM), socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    a.bind(("", 0))
    port = a.getsockname()[1]
    try:
        b.bind(("", port + 1))
        break
    except OSError:
        pass
    finally:
        a.close()
        b.close()
params.set_commandline_param("ldgm-device", "device")
rx = receiver.VideoReceiver("dummy", rx_port=port, frame_limit=2, timeout=20.0, device="cpu")
t = threading.Thread(target=rx.run, daemon=True)
t.start()
sender.VideoSender("testcard:s=64x32:f=60:c=UYVY:still=1", "127.0.0.1", compress_spec="jpeg", fec_spec="ldgm:8:4:3",
                   tx_port=port, frame_limit=12, device="cpu").run()
t.join(timeout=20)
assert rx.frames_displayed >= 2 and rx.rx_state.fec_jobs >= 2, (rx.frames_displayed, rx.rx_state.fec_jobs)
assert jpeg_cuda.LAUNCHES.count == 0 and jpeg_cuda.PLANE_LAUNCHES.count == 0 and fec.LAUNCHES.count == 0
# the H.264 codec on the CPU: the device encoders, the compress module with
# CABAC, the own decoder, and a loopback of the inter codec
enc = h264_device.InterEncoderDevice(64, 32, gop=2, device="cpu")
dec = OwnH264Decompress(device="cpu")
for _ in range(3):
    au = enc.encode_uyvy(frame)
    shown = dec.decompress(VideoFrame(desc.with_(color_spec=Codec.H264), [np.frombuffer(au, np.uint8)]), Codec.UYVY)
    assert torch.equal(shown.data[:, 1::2], enc.ref[0][:32, :64])
cabac = H264Compress("mode=inter:accel=device:entropy=cabac", device="cpu")
assert cabac.compress(VideoFrame(desc, [frame])).desc.color_spec == Codec.H264
cabac.done()
assert h264_device.Intra16EncoderDevice(64, 32, device="cpu").encode_uyvy(frame)[:4] == b"\x00\x00\x00\x01"
assert cli.main(["-t", "testcard:s=64x32:f=1000:c=UYVY", "-d", "dummy", "-x", "loopback", "-c",
                 "h264:mode=inter:accel=device", "--frames", "2", "--device", "cpu"]) == 0
# the wavelet and intra codecs on the CPU; each module defaults to the card
from ultragrid_tpu_torch.ops import apv, cfhd_bitstream, cfhd_tables, cineform, j2k, jpegxs
from ultragrid_tpu_torch.modules.video_compress import ApvCompress, CineformCompress, J2kCompress, JpegXsCompress
from ultragrid_tpu_torch.modules.video_decompress import (ApvDecompress, CineformDecompress, J2kDecompress,
                                                          JpegXsDecompress)
if not torch.cuda.is_available():
    for make in (JpegXsCompress, CineformCompress, ApvCompress, JpegXsDecompress, CineformDecompress,
                 ApvDecompress, J2kDecompress, lambda: J2kCompress().compress(VideoFrame(desc, [frame]))):
        try:
            make()
        except RuntimeError:
            pass
        else:
            raise SystemExit("a codec module ran without a card on its default device")
for comp, dec, out in ((JpegXsCompress("100", device="cpu"), JpegXsDecompress(device="cpu"), Codec.UYVY),
                       (CineformCompress("100", device="cpu"), CineformDecompress(device="cpu"), Codec.UYVY),
                       (ApvCompress("0", device="cpu"), ApvDecompress(device="cpu"), Codec.UYVY),
                       (J2kCompress("100", device="cpu"), J2kDecompress(device="cpu"), Codec.RGB)):
    shown = dec.decompress(comp.compress(VideoFrame(desc, [frame])), out)
    assert shown.data.dtype == torch.uint8 and shown.data.shape[0] == 32, type(comp).__name__
# audio in the live session, -E and -I, astat: every audio module and tool;
# the Tx and the import capture default to the card
import io, tempfile, wave
from ultragrid_tpu_torch.audio import (aes67, alsa, capture, codecs, echo, filters, midi_synth, playback,
                                       resampler, volume)
from ultragrid_tpu_torch.net import audio_rx
from ultragrid_tpu_torch.tools import astat
from ultragrid_tpu_torch.utils import export
rec = tempfile.mkdtemp()
sender.VideoSender("testcard:s=64x32:f=60:c=UYVY", "127.0.0.1", tx_port=port, frame_limit=6, audio_capture="testcard",
                   record=rec, device="cpu").run()
if not torch.cuda.is_available():
    for make in (transmit.Tx, lambda: export.ImportCapture(rec)):
        try:
            make()
        except RuntimeError:
            pass
        else:
            raise SystemExit("an audio entry point ran without a card on its default device")
from ultragrid_tpu_torch.audio import lavc_codecs
if native.lavc_headers_present():
    opus = codecs.get_audio_codec("Opus")
    pkts = [p for _ in range(3) for p in opus.compress_multi(capture.TestcardAudioCapture().read(1920))]
    assert pkts and opus.decompress(pkts[0]).desc.codec == "PCM"
else:
    try:
        codecs.get_audio_codec("Opus")
    except ValueError as e:
        assert "libavcodec" in str(e)
    else:
        raise SystemExit("a libavcodec audio codec was built without libavcodec")
played = []
rx = receiver.VideoReceiver("dummy", rx_port=port, timeout=20.0, audio_playback="dummy", device="cpu")
put = rx.audio_playback.put_frame
rx.audio_playback.put_frame = lambda f: (played.append(f), put(f))
t = threading.Thread(target=rx.run, daemon=True)
t.start()
assert cli.main(["-I", rec, "-f", "A:rs:16:24", "-P", str(port), "-n", "0", "--device", "cpu", "127.0.0.1"]) == 0
time.sleep(0.3)
rx.should_exit = True
t.join(timeout=20)
with wave.open(rec + "/sound.wav", "rb") as wf:
    wav = wf.readframes(wf.getnframes())
got = b"".join(f.to_interleaved().tobytes() for f in played)
assert rx.frames_displayed >= 1 and got and got == wav[:len(got)], (rx.frames_displayed, len(got), len(wav))
ctl = control_socket.ControlServer(messaging.Module("root"), 0)
threading.Timer(0.3, lambda: ctl.report_stats("stats ARECV volrms0 -18.0 volpeak0 -12.0")).start()
assert astat.run("127.0.0.1", ctl.port, seconds=1.0, out=io.StringIO()) == {0: (-18.0, -12.0)}
ctl.close()
# standards mode, RTSP, the duplex call, the preview socket and
# thumbnailgen, iHDTV: every module and tool of them; each entry point
# defaults to the card
import functools, os
from ultragrid_tpu_torch.modules import ipc_display, rtsp_capture
from ultragrid_tpu_torch.net import rtpdec_h264, rtpdec_jpeg, rtsp, rtsp_client
from ultragrid_tpu_torch.pipeline import duplex, ihdtv
from ultragrid_tpu_torch.tools import ipc_frame_dump, thumbnailgen
from ultragrid_tpu_torch.utils import sdp
if not torch.cuda.is_available():
    for make in (lambda: thumbnailgen.write_thumbnail(16, 8, bytes(384), os.devnull),
                 lambda: ihdtv.run_ihdtv_receiver("dummy", 0), lambda: ihdtv.run_ihdtv_sender("testcard", "x", 0),
                 lambda: rtsp_capture.RtspCapture("rtsp://127.0.0.1:9/x"),
                 lambda: cli.main(["-t", "testcard:s=64x32", "-d", "dummy", "127.0.0.1", "-n", "0", "--frames", "1"])):
        try:
            make()
        except RuntimeError:
            pass
        else:
            raise SystemExit("a standards-mode, duplex or preview entry point ran without a card")
sender.SdpHttpServer = functools.partial(sdp.SdpHttpServer, port=0)
sender.RtspServer = functools.partial(rtsp.RtspServer, port=0)
rx = receiver.VideoReceiver("dummy", rx_port=port, frame_limit=2, timeout=20.0, device="cpu")
t = threading.Thread(target=rx.run, daemon=True)
t.start()
sender.VideoSender("testcard:s=64x32:f=60:c=UYVY:still=1", "127.0.0.1", compress_spec="jpeg", tx_port=port,
                   frame_limit=12, rtp_standard=True, device="cpu").run()
t.join(timeout=20)
assert rx.frames_displayed >= 2, rx.frames_displayed
rtsp_tx = sender.VideoSender("testcard:s=64x32:f=60:c=UYVY", None, compress_spec="jpeg", tx_port=port, rtsp=True,
                             rtp_standard=True, device="cpu")
t = threading.Thread(target=rtsp_tx.run, daemon=True)
t.start()
cap = rtsp_capture.RtspCapture(f"rtsp://127.0.0.1:{rtsp_tx.rtsp_server.port}/ug", device="cpu")
got = None
for _ in range(40):
    got = cap.grab()[0]
    if got is not None:
        break
cap.done()
rtsp_tx.should_exit.set()
t.join(timeout=20)
assert got is not None and tuple(got.data.shape) == (32, 128)
assert cli.main(["-t", "testcard:s=64x32:f=60:c=UYVY", "-d", "dummy", "127.0.0.1", "-P", str(port), "-n", "0",
                 "--frames", "3", "--device", "cpu"]) == 0
sock = os.path.join(rec, "preview.sock")
reader = ipc_display.IpcFrameReader(sock)
disp = ipc_display.UnixSockDisplay(f"path={sock}", device="cpu")
reader.accept()
desc_rgb = VideoDesc(64, 32, Codec.RGB, 30.0)
for _ in range(6):
    disp.put_frame(VideoFrame(desc_rgb, [torch.zeros(32, 192, dtype=torch.uint8)]))
w, h, color, data = reader.read_frame()
disp.done()
reader.close()
thumbnailgen.write_thumbnail(w, h, data, os.path.join(rec, "t.jpg"), device="cpu")
assert open(os.path.join(rec, "t.jpg"), "rb").read(2) == b"\xff\xd8"
# the multi-device path on a mesh of four CPU entries, -e, and the file modules
from ultragrid_tpu_torch.parallel import make_mesh, shard_frame_rows
from ultragrid_tpu_torch.parallel.dryrun import dryrun_multichip
from ultragrid_tpu_torch.parallel.sharded_h264 import ShardedH264Encoder
from ultragrid_tpu_torch.parallel.sharded_jpeg import (ShardedJpegDecoder, ShardedJpegEncoder, ShardedReceiverStep,
                                                       ShardedSenderStep, band_symbols)
from ultragrid_tpu_torch.parallel.sharded_post import sharded_deinterlace
if not torch.cuda.is_available():
    try:
        make_mesh(2)
    except RuntimeError:
        pass
    else:
        raise SystemExit("make_mesh() did not raise without a card")
dryrun_multichip(4, device="cpu")
mesh = make_mesh(devices=["cpu"] * 4)
f8k = np.random.default_rng(3).integers(0, 256, (64, 2 * 96), dtype=np.uint8)
step = ShardedSenderStep(96, 64, mesh, k=16, m=6, c=3)
outs = step(shard_frame_rows(f8k, mesh))
syms = np.stack([band_symbols(o, step.row_counts, step.ps, step.k) for o in outs])
have = np.ones(syms.shape[:2], bool)
have[:, 1] = False
bands, ok = ShardedReceiverStep(96, 64, mesh, k=16, m=6, c=3)(syms, have)
assert ok.all() and len(bands) == 4
assert ShardedJpegDecoder(mesh).decode_to_uyvy(bytes(ShardedJpegEncoder(96, 64, mesh).encode(f8k)))[1:] == (64, 96)
assert len(sharded_deinterlace(f8k, Codec.UYVY, mesh, kind="linear")) == 4
assert ShardedH264Encoder(96, 64, mesh).encode(f8k)[:4] == b"\x00\x00\x00\x01"
from ultragrid_tpu_torch.utils.crypto import PacketCrypto
pc = PacketCrypto("k:cipher=cbc")
assert pc.decrypt(pc.encrypt(b"payload", b"hdr"), b"hdr") == b"payload"
from ultragrid_tpu_torch.modules import file_io
y4m = os.path.join(rec, "t.y4m")
run_local_pipeline("testcard:s=64x32:f=1000:c=UYVY", "y4m:" + y4m, 2, device="cpu")
cap = initialize_video_capture("file:" + y4m, device="cpu")
assert cap.grab()[0].data.numel() == 64 * 32 * 3 // 2
cap.done()
mix = initialize_video_capture("swmix:64:32:30#testcard:s=64x32:c=UYVY#testcard:s=64x32:c=RGB", device="cpu")
assert mix.grab()[0].data.shape == (32, 192)
# the bench tools, the X11 client and the remaining captures on the CPU;
# each tool and capture defaults to the card
import glob
from ultragrid_tpu_torch.net import x11
from ultragrid_tpu_torch.modules import hw_stubs, screen_capture, ug_input, v4l2_capture
from ultragrid_tpu_torch.tools import (bench_h264_enc_dev, bench_jpeg_dev, bench_latency, bench_northstar,
                                       bench_pipeline, bench_receiver, bench_scan_decode)
from tests import torch_x11_mock
srv = torch_x11_mock.MockXServer(os.path.join(rec, "X0"))
if not torch.cuda.is_available():
    for make in (bench_pipeline.main, bench_northstar.main, bench_jpeg_dev.main, bench_scan_decode.main,
                 bench_h264_enc_dev.main, bench_latency.main, bench_receiver.main,
                 lambda: screen_capture.ScreenCapture("display=" + srv.path),
                 lambda: v4l2_capture.V4l2Capture(""), lambda: ug_input.UgInputCapture("port=0")):
        try:
            make()
        except RuntimeError:
            pass
        else:
            raise SystemExit("a bench tool or capture ran without a card on its default device")
cpu = torch.device("cpu")
rows = bench_pipeline.run(cpu, {"1080p": (64, 32), "4K": (64, 32), "8K": (64, 32)})
assert len(rows) == 10 and all(r.seconds > 0 for r in rows)
assert bench_northstar.run(128, 64, 1, cpu)["out"][6].shape[0] == 26
assert bench_jpeg_dev.timeit(JpegEncoder(64, 32).encode_device, bench_jpeg_dev.make_frame(64, 32, cpu), 1, 1) > 0
assert sorted(bench_scan_decode.run(64, 32, 80, 1, cpu)) == [1, 2, 4, 8]
assert len(bench_h264_enc_dev.run(32, 32, 26, cpu, iters=1, batches=1)["stage_outputs"]) == 5
bench_latency.warm_graphs(64, 32, "jpeg", cpu, decode_side=True)
assert bench_receiver.run(64, 32, 3, cpu, port=port)["frames"] >= 3
cap = screen_capture.ScreenCapture("display=" + srv.path, device="cpu")
assert np.array_equal(cap.grab()[0].data.numpy().reshape(32, 64, 3), srv.fb_rgb)
cap.done()
srv.close()
if not glob.glob("/dev/video*"):
    try:
        v4l2_capture.V4l2Capture("", device="cpu")
    except RuntimeError as e:
        assert "no /dev/video" in str(e)
    else:
        raise SystemExit("v4l2 opened a device that is not there")
for name in ("decklink", "ndi", "aja"):
    try:
        registry.load_library(name, registry.LibraryClass.VIDEO_CAPTURE)("")
    except RuntimeError as e:
        assert name in str(e)
cap = ug_input.UgInputCapture(f"port={port}", device="cpu")
sender.VideoSender("testcard:s=64x32:f=30:c=UYVY:still=1", "127.0.0.1", tx_port=port, frame_limit=4,
                   device="cpu").run()
got = cap.grab()[0]
cap.done()
assert got is not None and tuple(got.data.shape) == (32, 128)
# the last slice: the windowed displays against the mock X server (gl where
# Mesa's EGL makes a context), libavcodec with mpegts, NAT traversal,
# ~/.ug.rc and the remaining tools; each entry point defaults to the card
from ultragrid_tpu_torch.modules import drm_display, gl_display, lavc, x11_display
from ultragrid_tpu_torch.net import nat
from ultragrid_tpu_torch.pipeline import mpegts
from ultragrid_tpu_torch.tools import (bench_h264_decode, convert, extract_cabac_tables, hd_rum, hd_rum_translator,
                                       mux_ivf, nat_helper, uyvy2yuv422p, webui)
from ultragrid_tpu_torch.utils import config_file, glctx
raw = os.path.join(rec, "in.uyvy")
frame.tofile(raw)
if not torch.cuda.is_available():
    makers = [lambda: convert.main(["64x32", "UYVY", raw, "RGB", raw + ".rgb"]),
              lambda: hd_rum_translator.HdRumTranslator(0, [])]
    if native.lavc_headers_present():
        makers += [lambda: lavc.LavcCompress("codec=H.264"), lambda: lavc.LavcDecompress(),
                   lambda: mpegts.MpegTsReceiver("dummy", 0)]
    for make in makers:
        try:
            make()
        except RuntimeError:
            pass
        else:
            raise SystemExit("a slice-13 entry point ran without a card on its default device")
assert convert.main(["64x32", "UYVY", raw, "RGB", raw + ".rgb", "--device", "cpu"]) == 0
assert os.path.getsize(raw + ".rgb") == 32 * 192
if native.lavc_headers_present():
    enc = lavc.LavcCompress("codec=H.264:bitrate=1M", device="cpu")
    au = enc.compress(VideoFrame(desc, [torch.as_tensor(frame)]))
    shown = lavc.LavcDecompress(device="cpu").decompress(au, Codec.UYVY)
    assert shown.data.device.type == "cpu" and tuple(shown.data.shape) == (32, 128)
    enc.done()
else:
    try:
        lavc.LavcCompress("codec=H.264", device="cpu")
    except ValueError as e:
        assert "libavcodec" in str(e)
    else:
        raise SystemExit("LavcCompress was built without libavcodec")
srv = torch_x11_mock.MockXServer(os.path.join(rec, "X1"))
disp = x11_display.X11Display(f"display={srv.path}", device="cpu")
disp.reconfigure(desc_rgb)
disp.put_frame(VideoFrame(desc_rgb, [torch.full((32, 192), 7, dtype=torch.uint8)]))
assert (next(iter(srv.windows.values())) == 7).all()
disp.done()
srv.close()
try:
    gl = gl_display.GlDisplay("", device="cpu")
except RuntimeError as e:
    assert "gl" in str(e)
else:
    gl.reconfigure(desc_rgb)
    gl.put_frame(VideoFrame(desc_rgb, [torch.full((32, 192), 9, dtype=torch.uint8)]))
    assert (gl.last_rgb() == 9).all()
    gl.done()
cf_path = os.path.join(rec, "ug.rc")
with open(cf_path, "w") as fh:
    fh.write("alias capture camera testcard:s=64x32\n")
assert config_file.ConfigFile(cf_path).resolve_device("capture", "camera") == ("testcard:s=64x32", None)
assert nat.parse_holepunch_conf("holepunch:room=r:server=127.0.0.1")["room"] == "r"
hub = nat_helper.NatHelperServer(port=0, host="127.0.0.1")
hub.start()
hub.close()
loaded = [m for m, mod in sys.modules.items()
          if m.split(".")[0] in ("jax", "ultragrid_tpu", "PIL") and mod is not None]
assert not loaded, loaded
print("ISOLATED-OK")
"""


def test_port_imports_and_encodes_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "ISOLATED-OK" in res.stdout


# Pillow may render text, and encode the web UI's preview JPEG, where the
# JAX package does so with Pillow too, each with its fallback where Pillow is
# absent: the text filter's label, testcard2's banner and the web UI's
# preview, (file, function).  Nothing else of the port imports it.
PIL_OPTIONAL = {("modules/filters.py", "_render_mask"), ("modules/video_capture.py", "_banner"),
                ("tools/webui.py", "_encode")}


def test_port_sources_never_name_jax():
    pkg = ROOT / "ultragrid_tpu_torch"
    # build/ holds compiled kernels (and may hold an unpacked checkout)
    sources = [p for p in pkg.rglob("*.py") if "build" not in p.relative_to(pkg).parts]
    sources += [ROOT / "chip_smoke.py", ROOT / "chip_profile.py", ROOT / "chip_phases.py",
                ROOT / "tests" / "torch_x11_mock.py"]
    walked = {p.relative_to(pkg).parts[0] for p in sources if pkg in p.parents}
    assert {"audio", "tools", "net", "utils", "ops", "modules", "pipeline", "parallel"} <= walked, walked
    pil_at = set()
    for path in sources:
        where = ""
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["def"], ["class"]):
                where = words[1].split("(")[0].rstrip(":")
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] in ("jax", "ultragrid_tpu")), f"{path}: {line}"
            if words[:1] in (["import"], ["from"]) and len(words) > 1 and words[1].split(".")[0] == "PIL":
                rel = path.relative_to(pkg).as_posix() if pkg in path.parents else path.name
                assert line.startswith(" "), f"{path}: Pillow imported at module level"
                pil_at.add((rel, where))
    assert pil_at <= PIL_OPTIONAL, pil_at
