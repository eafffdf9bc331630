"""The port's zone profiler (``utils/profiler.py``) and the spans of a live
session, on the CPU.

The profiler: nothing recorded and one shared no-op object while off;
records stamped on ``time.monotonic_ns()``; nesting, the frame key a zone
takes from its parent, and the finished-interval record; the four-field
records that readers unpack; the Chrome-trace dump's pid, thread names,
frame keys, clock offset and per-process default path.  The session: a port
sender and a port receiver in one process over 127.0.0.1 with LDGM, one
data packet dropped a frame and the peel on tensors
(``--param ldgm-device=device``, as the benchmark runs it): every span of
the frame's path that the CPU runs appears for each shown frame, keyed by
its RTP timestamp, and the spans that metrics read keep one record a frame.
"""

import json
import os
import queue
import threading
import time
from collections import defaultdict

import pytest

torch = pytest.importorskip("torch")

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch.net.rtp_types import received_rtp_ts  # noqa: E402
from ultragrid_tpu_torch.pipeline import receiver as receiver_mod  # noqa: E402
from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver  # noqa: E402
from ultragrid_tpu_torch.pipeline.sender import VideoSender  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils import params, profiler  # noqa: E402

from tests.test_torch_net import _lossy, free_port_pair  # noqa: E402


@pytest.fixture(autouse=True)
def _profiler_state():
    """Each test starts with the profiler off and empty, and leaves it so."""
    saved = (profiler.enabled, profiler._path)
    profiler.enabled = False
    profiler._events.clear()
    yield
    profiler.enabled, profiler._path = saved
    profiler._events.clear()
    params.reset_params()


def test_off_records_nothing_and_shares_one_no_op():
    a, b = profiler.zone("a"), profiler.zone("b", frame=5)
    assert a is b
    with profiler.zone("work", frame=1) as z:
        assert z is None
    profiler.interval("wait", time.monotonic_ns() - 1000, frame=1)
    profiler.instant("mark")
    assert not profiler._events


def test_records_are_stamped_on_the_monotonic_clock(monkeypatch, tmp_path):
    profiler.enable(str(tmp_path / "t.json"))
    lo = time.monotonic_ns()
    with profiler.zone("real"):
        time.sleep(0.001)
    hi = time.monotonic_ns()
    (name, _tid, t0, dur), = profiler._events
    assert name == "real" and lo <= t0 and t0 + dur <= hi and dur >= 1_000_000
    ticks = iter([1_000, 5_000, 9_000])
    monkeypatch.setattr(time, "monotonic_ns", lambda: next(ticks))
    with profiler.zone("fake"):
        pass
    profiler.instant("mark")
    assert profiler._events[1][0] == "fake" and profiler._events[1][2:] == (1_000, 4_000)
    assert profiler._events[2][2:] == (9_000, 0) and profiler._events[2].instant


def test_nesting_frame_keys_and_finished_intervals(tmp_path):
    profiler.enable(str(tmp_path / "t.json"))
    with profiler.zone("outer", frame=7):
        t_wait = time.monotonic_ns()
        with profiler.zone("inner"):
            with profiler.zone("own", frame=9):
                pass
            time.sleep(0.001)
        profiler.interval("wait", t_wait)
    with profiler.zone("alone"):
        pass
    recs = {r[0]: r for r in profiler._events}
    assert [r[0] for r in profiler._events] == ["own", "inner", "wait", "outer", "alone"]
    outer, inner, own, wait = recs["outer"], recs["inner"], recs["own"], recs["wait"]
    assert outer[2] <= inner[2] and inner[2] + inner[3] <= outer[2] + outer[3]
    assert (inner.parent, inner.frame) == ("outer", 7)
    assert (own.parent, own.frame) == ("inner", 9)
    assert (wait.parent, wait.frame, wait[2]) == ("outer", 7, t_wait)
    assert wait[3] >= inner[3] and wait[2] + wait[3] <= outer[2] + outer[3]
    assert recs["alone"].parent is None and recs["alone"].frame is None


def test_records_keep_four_fields_with_the_frame_as_an_attribute(tmp_path):
    profiler.enable(str(tmp_path / "t.json"))
    with profiler.zone("compress", frame=1234):
        pass
    profiler.instant("rx.drop", frame=1234, args={"queue": "fec"})
    # what ugbench/trace.py's zones_take unpacks
    got = [(n, t0, dur) for n, _tid, t0, dur in profiler._events]
    assert [g[0] for g in got] == ["compress", "rx.drop"]
    assert all(len(r) == 4 for r in profiler._events)
    assert [r.frame for r in profiler._events] == [1234, 1234]
    assert profiler._events[1].args == {"queue": "fec"}


def test_dump_names_the_process_its_threads_and_the_clock(tmp_path, monkeypatch):
    profiler.enable()
    profiler._path = None
    monkeypatch.chdir(tmp_path)

    def work():
        with profiler.zone("rx.fec", frame=42):
            pass
        profiler.instant("rx.drop", frame=43, args={"queue": "decompress"})

    t = threading.Thread(target=work, name="fec")
    t.start()
    t.join(timeout=5)
    assert not t.is_alive()
    out = profiler.dump()
    assert out == f"ugtpu_trace.{os.getpid()}.json" and os.path.exists(tmp_path / out)
    trace = json.load(open(tmp_path / out))
    evs = trace["traceEvents"]
    assert {e["pid"] for e in evs} == {os.getpid()}
    meta = [e for e in evs if e["ph"] == "M"]
    span = next(e for e in evs if e["name"] == "rx.fec")
    drop = next(e for e in evs if e["name"] == "rx.drop")
    assert {"name": "thread_name", "ph": "M", "pid": os.getpid(), "tid": span["tid"],
            "args": {"name": "fec"}} in meta
    assert span["ph"] == "X" and span["args"] == {"frame": 42}
    assert drop["ph"] == "i" and drop["args"] == {"queue": "decompress", "frame": 43}
    offset = trace["otherData"]["wall_minus_monotonic_ns"]
    assert abs(offset - (time.time_ns() - time.monotonic_ns())) < 1_000_000_000
    assert trace["otherData"]["clock"] == "monotonic"
    assert profiler.dump(str(tmp_path / "named.json")) == str(tmp_path / "named.json")


def test_a_full_receiver_queue_marks_the_dropped_frame(tmp_path):
    profiler.enable(str(tmp_path / "t.json"))
    q = queue.Queue(maxsize=1)
    q.put("busy")
    frame = VideoFrame(VideoDesc(16, 16, Codec.UYVY, 30.0), [None], timestamp=12345 / 90000.0)
    with pytest.raises(queue.Full):
        receiver_mod._put(q, frame, "decompress")
    (rec,) = profiler._events
    assert rec[0] == "rx.drop" and rec.frame == 12345 and rec.args == {"queue": "decompress"}


# spans of a frame's path that the CPU session runs, by process side: the
# card's route, K1, the assembly and the LDGM buffer here in their plain
# versions
SENDER_SPANS = ("compress.queue", "compress", "compress.k1", "compress.assemble",
                "send.queue", "fec+tx.send", "tx.fec", "tx.pace")
RECEIVER_SPANS = ("rx.playout", "rx.reassemble", "fec.queue", "rx.fec", "fec.peel.round", "decompress.queue",
                  "rx.decompress", "decompress.scan", "decompress.upload", "decompress.product",
                  "rx.postprocess", "rx.display")
ONE_A_FRAME = ("compress", "fec+tx.send", "rx.fec", "rx.decompress")


def _profiled_session(n_frames=3):
    params.set_commandline_param("ldgm-device", "device")  # the peel on tensors (here the CPU)
    profiler.enable()
    port_no = free_port_pair()
    shown = []
    recv = VideoReceiver("dummy:codec=UYVY", rx_port=port_no, frame_limit=n_frames, timeout=20.0, device="cpu")
    orig = recv.display.put_frame

    def put(frame, blocking=True):
        if frame is not None:
            shown.append(received_rtp_ts(frame.timestamp))
        orig(frame, blocking)

    recv.display.put_frame = put
    t = threading.Thread(target=recv.run, daemon=True)
    t.start()
    time.sleep(0.2)
    sender = VideoSender("testcard:s=128x64:f=30:c=UYVY:still=1", "127.0.0.1", compress_spec="jpeg:80",
                         fec_spec="ldgm:32:16:5", tx_port=port_no, mtu=400, frame_limit=n_frames + 6,
                         device="cpu")
    _lossy(sender.session, 7, 32, 16)
    sender.run()
    t.join(timeout=25)
    assert not t.is_alive(), "the receiver did not stop"
    return shown, recv


def test_a_sessions_frames_carry_every_span_of_their_path(tmp_path):
    profiler._path = str(tmp_path / "session.json")
    for _attempt in range(3):
        profiler._events.clear()
        shown, recv = _profiled_session()
        if len(shown) >= 2:
            break
    assert len(shown) >= 2, f"{len(shown)} frames displayed in 3 attempts"
    assert recv.rx_state.fec_recovered >= len(shown)
    by_frame = defaultdict(lambda: defaultdict(int))
    for rec in list(profiler._events):
        by_frame[rec.frame][rec[0]] += 1
    for key in shown:
        got = by_frame[key]
        missing = [s for s in SENDER_SPANS + RECEIVER_SPANS if not got[s]]
        assert not missing, f"frame {key}: no {missing} (has {dict(got)})"
        assert all(got[s] == 1 for s in ONE_A_FRAME), dict(got)
        assert got["rx.reassemble"] <= 1
    names = {rec[0] for rec in profiler._events}
    # a new encoder and the peel (once a session and device) are built here
    assert {"compress.build", "fec.peel.build"} <= names and not {"rx.drop", "compress.download"} & names
    nested = {rec[0]: rec.parent for rec in profiler._events}
    assert nested["compress.k1"] == nested["compress.assemble"] == "compress"
    assert nested["tx.fec"] == nested["tx.pace"] == "fec+tx.send"
    assert nested["fec.peel.round"] == "rx.fec" and nested["decompress.scan"] == "rx.decompress"
