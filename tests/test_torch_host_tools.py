"""The port's remaining tools and ``~/.ug.rc`` against the JAX package's, on
the CPU.

Every case of ``tests/test_tools.py`` (``convert``, ``hd_rum_translator`` and
its slow client, ``webui``), ``tests/test_aux.py::test_hd_rum_reflector`` and
``::test_config_file_aliases``, ``tests/test_extra_modules.py::test_mux_ivf*``
and ``::test_uyvy2yuv422p_tool``, run across the two packages on the same
seeded inputs with no tolerance: files, datagrams, frames and parsed values
equal byte for byte.  Also the port's own parts of the slice: the CLI's
``~/.ug.rc`` aliases (``-t camera``), ``extract_cabac_tables`` over the
port's tables, and ``bench_h264_decode``'s frames and streams.
"""

import io
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference on the CPU)

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.modules.video_compress import compress_init as ref_compress_init  # noqa: E402
from ultragrid_tpu.ops import pixfmt as ref_pixfmt  # noqa: E402
from ultragrid_tpu.tools import mux_ivf as ref_mux_ivf  # noqa: E402
from ultragrid_tpu.tools import uyvy2yuv422p as ref_uyvy2yuv422p  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402
from ultragrid_tpu.utils.config_file import ConfigFile as RefConfigFile  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch import cli  # noqa: E402
from ultragrid_tpu_torch.modules import extra_displays  # noqa: E402
from ultragrid_tpu_torch.modules.lavc import lavc_available  # noqa: E402
from ultragrid_tpu_torch.modules.registry import LibraryClass, load_library  # noqa: E402
from ultragrid_tpu_torch.net.pbuf import PlayoutBuffer  # noqa: E402
from ultragrid_tpu_torch.net.rtp import RtpSession  # noqa: E402
from ultragrid_tpu_torch.net.transmit import Tx  # noqa: E402
from ultragrid_tpu_torch.net.video_rx import VideoRxState  # noqa: E402
from ultragrid_tpu_torch.ops import postprocess  # noqa: E402
from ultragrid_tpu_torch.tools import convert, hd_rum, mux_ivf, uyvy2yuv422p  # noqa: E402
from ultragrid_tpu_torch.tools.hd_rum_translator import HdRumTranslator  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame, vc_get_linesize  # noqa: E402
from ultragrid_tpu_torch.utils.config_file import ConfigFile  # noqa: E402
from ultragrid_tpu_torch.utils.pattern import generate_pattern  # noqa: E402

from chip_smoke import free_port_pair  # noqa: E402


def _pattern(w, h, codec=Codec.UYVY, name="bars"):
    return generate_pattern(w, h, codec, name, device="cpu").numpy()


def _host(data):
    return data.numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


@pytest.mark.parametrize("out_name", ["RGB", "v210"])
def test_convert_tool(tmp_path, out_name):
    """Two frames through the port's ``convert`` on the CPU: the reference
    tool's output file, byte for byte (and the reference test's check)."""
    from ultragrid_tpu.tools.convert import main as ref_main

    w, h = 192, 128
    src = np.concatenate([_pattern(w, h), _pattern(w, h, name="gradient")])
    in_path, out_path, ref_path = (str(tmp_path / n) for n in ("in.yuv", "out.raw", "ref.raw"))
    src.tofile(in_path)
    assert convert.main([f"{w}x{h}", "UYVY", in_path, out_name, out_path, "--device", "cpu"]) == 0
    assert ref_main([f"{w}x{h}", "UYVY", in_path, out_name, ref_path]) == 0
    out = np.fromfile(out_path, np.uint8)
    assert out.size == 2 * vc_get_linesize(w, Codec[out_name]) * h
    assert np.array_equal(out, np.fromfile(ref_path, np.uint8))
    ref = np.asarray(ref_pixfmt.convert_frame(src[:h], w, RefCodec.UYVY, RefCodec[out_name]))
    assert np.array_equal(out[: ref.size].reshape(h, -1), ref)


def _collect(sessions, want):
    """The first frame each client session reassembles."""
    bufs = [PlayoutBuffer() for _ in sessions]
    states = [VideoRxState(device="cpu") for _ in sessions]
    got = [None] * len(sessions)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and any(g is None for g in got[:want]):
        for i, (sess, pb, st) in enumerate(zip(sessions, bufs, states)):
            pkt = sess.recv(timeout=0.01)
            if pkt:
                pb.insert(pkt)
            if got[i] is None:
                for node in list(pb.frames.values()):
                    if node.mbit_seen and not node.decoded:
                        node.decoded = True
                        got[i] = st.decode_frame(node)
    return got


def test_hd_rum_translator_transcodes():
    """Uncompressed 192x128 in; one client with ``-c jpeg:85`` (K1 on the
    translator's device, here the CPU) and one raw: the JPEG client's file
    equals the reference's ``jpeg:85`` encode of the frame, the raw client's
    frame equals the input."""
    rx_port, out1, out2 = free_port_pair(), free_port_pair(), free_port_pair()
    translator = HdRumTranslator(rx_port, [("127.0.0.1", out1, "jpeg:85"), ("127.0.0.1", out2, "none")],
                                 device="cpu")
    t = threading.Thread(target=translator.run, kwargs={"frame_limit": 2, "timeout": 90}, daemon=True)
    t.start()
    time.sleep(0.2)
    cli1, cli2 = RtpSession(addr=None, rx_port=out1, tx_port=0), RtpSession(addr=None, rx_port=out2, tx_port=0)
    sender = RtpSession(addr="127.0.0.1", rx_port=0, tx_port=rx_port)
    tx = Tx(mtu=1500, device="cpu")
    w, h = 192, 128
    data = _pattern(w, h)
    frame = VideoFrame(VideoDesc(w, h, Codec.UYVY, 30.0), [torch.as_tensor(data)])
    for _ in range(3):
        tx.send_video(sender, frame)
        time.sleep(0.1)
    got1, got2 = _collect([cli1, cli2], 2)
    for s in (cli1, cli2, sender):
        s.close()
    t.join(timeout=5)
    assert got1 is not None and got1.desc.color_spec == Codec.JPEG
    assert got2 is not None and got2.desc.color_spec == Codec.UYVY
    assert np.array_equal(_host(got2.data), data)
    want = ref_compress_init("jpeg:85").compress(RefFrame(RefDesc(w, h, RefCodec.UYVY, 30.0), [data]))
    assert _host(got1.data).tobytes() == np.asarray(want.data).tobytes()


def test_hd_rum_translator_slow_client_does_not_stall_others():
    """Per-client recompress threads: a wedged client drops its own frames
    while the fast client keeps receiving."""
    rx_port, fast_port, slow_port = free_port_pair(), free_port_pair(), free_port_pair()
    translator = HdRumTranslator(rx_port, [("127.0.0.1", fast_port, "none"), ("127.0.0.1", slow_port, "none")],
                                 device="cpu")
    slow = translator.clients[1]
    send = slow.tx.send_video

    def wedged(session, frame):
        time.sleep(0.5)  # a pathological client
        return send(session, frame)

    slow.tx.send_video = wedged
    fast_rx = RtpSession(addr=None, rx_port=fast_port, tx_port=0)
    run_t = threading.Thread(target=lambda: translator.run(timeout=3.0), daemon=True)
    run_t.start()
    tx = RtpSession(addr="127.0.0.1", rx_port=0, tx_port=rx_port)
    sender_tx = Tx(mtu=1500, device="cpu")
    frame = VideoFrame(VideoDesc(64, 32, Codec.UYVY, 30.0), [torch.zeros((32, 128), dtype=torch.uint8)])
    got_fast = 0
    for _ in range(20):
        sender_tx.send_video(tx, frame)
        time.sleep(0.03)
        while fast_rx.recv(timeout=0.01) is not None:
            got_fast += 1
    run_t.join(timeout=10)
    assert got_fast >= 10, f"fast client starved ({got_fast} pkts)"
    assert slow.dropped >= 5
    tx.close()
    fast_rx.close()


def test_hd_rum_reflector():
    """The plain 1 -> N reflector: each datagram to every target, in order."""
    out1, out2, in_port = free_port_pair(), free_port_pair(), free_port_pair()
    rxs = []
    for p in (out1, out2):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", p))
        s.settimeout(5)
        rxs.append(s)
    rum = hd_rum.HdRum(in_port, [f"127.0.0.1:{out1}", f"127.0.0.1:{out2}"])
    t = threading.Thread(target=rum.run, kwargs={"packet_limit": 3}, daemon=True)
    t.start()
    time.sleep(0.2)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for i in range(3):
        tx.sendto(f"packet{i}".encode(), ("127.0.0.1", in_port))
        time.sleep(0.02)
    got = [[r.recv(100) for _ in range(3)] for r in rxs]
    assert got[0] == got[1] == [b"packet0", b"packet1", b"packet2"]
    t.join(timeout=3)
    rum.stop()
    for s in (*rxs, tx):
        s.close()


def test_config_file_aliases(tmp_path):
    """``~/.ug.rc``'s grammar: every query answered as the reference's."""
    rc = tmp_path / "ug.rc"
    rc.write_text("alias capture camera testcard:s=1280x720:c=UYVY\n"
                  "alias display wall conference:1920:1080\n"
                  "capture-filter camera grayscale\n")
    cf, ref = ConfigFile(str(rc)), RefConfigFile(str(rc))
    for call in (lambda c: c.get_alias("capture", "camera"), lambda c: c.get_alias("capture", "nope"),
                 lambda c: c.get_capture_filter_for_alias("camera"), lambda c: c.capture_aliases(),
                 lambda c: c.resolve_device("capture", "camera"), lambda c: c.resolve_device("capture", "camera:f=60"),
                 lambda c: c.resolve_device("display", "wall"), lambda c: c.resolve_device("display", "dummy")):
        assert call(cf) == call(ref)
    assert cf.resolve_device("capture", "camera:f=60")[0] == "testcard:s=1280x720:c=UYVY:f=60"
    assert ConfigFile(str(tmp_path / "missing")).get_alias("capture", "x") is None


def test_cli_resolves_ug_rc_aliases(tmp_path, monkeypatch):
    """``-t camera`` through ``cli.main`` with ``HOME`` holding a ``.ug.rc``
    that aliases it to a testcard with a capture filter: the frames shown are
    the testcard's, mirrored, on the session's device (the CPU here)."""
    (tmp_path / ".ug.rc").write_text("alias capture camera testcard:s=64x32:f=1000:c=UYVY\n"
                                     "capture-filter camera mirror\n"
                                     "alias display screen pipe:ugrc\n")
    monkeypatch.setenv("HOME", str(tmp_path))
    got = []
    extra_displays.register_pipe_delegate("ugrc", got.append)
    assert cli.main(["-t", "camera", "-d", "screen", "--frames", "2", "--device", "cpu"]) == 0
    frames = [f for f in got if f is not None]
    assert len(frames) == 2 and frames[0].data.device.type == "cpu"
    want = postprocess.mirror(torch.as_tensor(_pattern(64, 32)), 64, Codec.UYVY)
    assert torch.equal(frames[0].data, want)


def test_mux_ivf(tmp_path):
    files = []
    for i in range(3):
        p = tmp_path / f"f{i}.vp8"
        p.write_bytes(bytes([i]) * (10 + i))
        files.append(str(p))
    bufs = [io.BytesIO(), io.BytesIO()]
    mux_ivf.mux(64, 32, 30, files, bufs[0])
    ref_mux_ivf.mux(64, 32, 30, files, bufs[1])
    data = bufs[0].getvalue()
    assert data == bufs[1].getvalue()
    assert data[:4] == b"DKIF" and data[8:12] == b"VP80"
    assert struct.unpack("<HHI", data[12:20]) == (64, 32, 30)
    assert struct.unpack("<IQ", data[32:44]) == (10, 0)


def test_mux_ivf_real_vp8_demuxes_with_lavf(tmp_path):
    """VP8 from the port's libavcodec encoder, muxed to IVF, read back by the
    port's libavformat file capture: the frame each package's capture gives
    is the same."""
    if not lavc_available():
        pytest.skip("libavcodec unavailable")
    from ultragrid_tpu.modules.registry import LibraryClass as RefLibraryClass
    from ultragrid_tpu.modules.registry import load_library as ref_load

    try:
        comp = load_library("libavcodec", LibraryClass.VIDEO_COMPRESS)("codec=VP8", device="cpu")
    except ValueError as e:
        pytest.skip(f"no libvpx: {e}")
    w, h = 64, 32
    files = []
    for i in range(3):
        out = comp.compress(VideoFrame(VideoDesc(w, h, Codec.UYVY, 30.0), [torch.as_tensor(_pattern(w, h))]))
        if out is None:
            continue
        p = tmp_path / f"fr{i}.vp8"
        p.write_bytes(_host(out.data).tobytes())
        files.append(str(p))
    if not files:
        pytest.skip("vp8 encoder produced no frames (lagged output)")
    ivf = tmp_path / "out.ivf"
    with open(ivf, "wb") as fh:
        mux_ivf.mux(w, h, 30, files, fh)
    cap = load_library("file", LibraryClass.VIDEO_CAPTURE)(str(ivf), device="cpu")
    frame, _ = cap.grab()
    cap.done()
    ref_cap = ref_load("file", RefLibraryClass.VIDEO_CAPTURE)(str(ivf))
    ref_frame, _ = ref_cap.grab()
    ref_cap.done()
    assert frame is not None and frame.desc.width == w and frame.data.device.type == "cpu"
    assert np.array_equal(_host(frame.data), np.asarray(ref_frame.data))


def test_uyvy2yuv422p_tool():
    w, h = 8, 2
    uyvy = bytes(range(w * h * 2))
    out = uyvy2yuv422p.convert(w, h, uyvy)
    assert out == ref_uyvy2yuv422p.convert(w, h, uyvy)
    y, u, v = out[: w * h], out[w * h: w * h + w * h // 2], out[w * h + w * h // 2:]
    assert y[0] == 1 and y[1] == 3 and u[0] == 0 and v[0] == 2 and len(u) == len(v) == w * h // 2
    rnd = np.random.default_rng(4).integers(0, 256, 64 * 16 * 2, dtype=np.uint8).tobytes()
    assert uyvy2yuv422p.convert(64, 16, rnd) == ref_uyvy2yuv422p.convert(64, 16, rnd)


def test_webui_preview_control_capabilities(tmp_path):
    """The browser GUI's contract: MJPEG preview from the port's preview
    socket (the frame each package's hub encodes is the same JPEG),
    the control-socket bridge, and the port's capabilities JSON."""
    import http.client

    from ultragrid_tpu.tools.webui import PreviewHub as RefPreviewHub

    from ultragrid_tpu_torch.modules.ipc_display import UnixSockDisplay
    from ultragrid_tpu_torch.tools.webui import PreviewHub, make_server

    ctl = socket.socket()
    ctl.bind(("127.0.0.1", 0))
    ctl.listen(2)

    def ctl_loop():
        while True:
            try:
                conn, _ = ctl.accept()
            except OSError:
                return
            line = conn.recv(256).decode()
            conn.sendall(b"stats ITEM 42\r\n" if line.startswith("stats on") else b"200 OK\r\n")

    threading.Thread(target=ctl_loop, daemon=True).start()
    path = str(tmp_path / "prev.sock")
    srv, hub, bridge = make_server(0, path, ctl.getsockname()[1])
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    time.sleep(0.3)
    w, h = 96, 64
    disp = UnixSockDisplay(f"path={path}", device="cpu")
    desc = VideoDesc(w, h, Codec.RGB, 30.0)
    disp.reconfigure(desc)
    rgb = _pattern(w, h, Codec.RGB)
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            disp.put_frame(VideoFrame(desc, [torch.as_tensor(rgb)]))
            time.sleep(0.03)

    threading.Thread(target=pump, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/")
        assert b"preview" in conn.getresponse().read()
        conn.request("GET", "/capabilities")
        caps = json.loads(conn.getresponse().read())
        assert "video_capture" in caps and "testcard" in caps["video_capture"]
        conn.request("GET", "/preview")
        resp = conn.getresponse()
        assert resp.getheader("Content-Type").startswith("multipart/x-mixed-replace")
        data = b""
        deadline = time.time() + 15
        while b"\xff\xd9" not in data and time.time() < deadline:
            data += resp.read(4096)
        jpg = data[data.index(b"\xff\xd8"): data.index(b"\xff\xd9") + 2]
        assert jpg == PreviewHub._encode(w, h, rgb.tobytes()) == RefPreviewHub._encode(w, h, rgb.tobytes())
        conn.close()
        c2 = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        c2.request("POST", "/control", body="compress jpeg:80")
        assert b"200" in c2.getresponse().read()
        deadline = time.time() + 10
        stats = b""
        while b"ITEM 42" not in stats and time.time() < deadline:
            c2.request("GET", "/stats")
            stats = c2.getresponse().read()
            time.sleep(0.2)
        assert b"ITEM 42" in stats
    finally:
        stop.set()
        disp.done()
        srv.shutdown()
        ctl.close()


def test_extract_cabac_tables_checks_the_ports_tables(capsys):
    """The drift check over the port's own CABAC, 8x8 and deblocking tables
    against the installed codec binaries: every table it locates matches,
    and it reports what the reference's run reports."""
    from ultragrid_tpu.tools import extract_cabac_tables as ref_tool

    from ultragrid_tpu_torch.tools import extract_cabac_tables

    rc = extract_cabac_tables.main()
    out = capsys.readouterr().out
    ref_rc = ref_tool.main()
    assert rc == ref_rc and out == capsys.readouterr().out
    if "no codec binaries found" not in out:
        assert rc == 0 and "MISMATCH" not in out and "MATCH" in out


def test_bench_h264_decode_streams_equal_reference():
    """``bench_h264_decode``'s content (frames on the device, here the CPU)
    and the libx264 streams it times are the reference tool's."""
    from ultragrid_tpu.tools import bench_h264_decode as ref_bench

    from ultragrid_tpu_torch.tools import bench_h264_decode

    for kind in ("synthetic", "textured"):
        frames = bench_h264_decode.make_frames(64, 48, 3, kind, device="cpu")
        ref_frames = ref_bench.make_frames(64, 48, 3, kind)
        assert all(np.array_equal(f.data.numpy(), np.asarray(r.data)) for f, r in zip(frames, ref_frames))
    if not lavc_available():
        with pytest.raises(ValueError, match="libavcodec"):
            bench_h264_decode.encode(frames, bench_h264_decode.CONFIGS[0][1], device="cpu")
        return
    name, spec = bench_h264_decode.CONFIGS[0]
    aus = bench_h264_decode.encode(frames, spec, device="cpu")
    from ultragrid_tpu.modules.lavc import LavcCompress as RefLavcCompress

    enc = RefLavcCompress(spec)
    ref_aus = [bytes(np.asarray(c.data)) for c in (enc.compress(f) for f in ref_frames) if c is not None]
    enc.done()
    assert aus == ref_aus
    fps, ms = bench_h264_decode.decode_rate(aus)
    assert fps > 0 and ms > 0
