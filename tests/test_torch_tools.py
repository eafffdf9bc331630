"""The port's bench tools (``ultragrid_tpu_torch/tools/``) against the JAX
package's on the CPU, at small sizes.

Each tool's timed function gives the reference function's output on the same
inputs: ``bench_pipeline``'s ten rows (conversions and the JPEG device half
bit-equal, DXT within the DXT tests' 0.1% block rule, the pipelined JPEG
body and the 8K row's LDGM buffer byte-equal), ``bench_northstar``'s step,
``bench_scan_decode``'s coefficients at every thread count,
``bench_h264_enc_dev``'s five stage outputs.  The printed labels and JSON
keys are the reference's.  The two-process latency bench and the receiver
bench run a session over 127.0.0.1.  A tool started without a card and
without ``--device cpu`` raises.

The sessions run at 320x176, not 320x180: the JPEG encoder of both packages
takes heights that are a multiple of 8 only, so a 320x180 JPEG session shows
no frame in either (held below).
"""

import ast
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ultragrid_tpu.models import encode as ref_encode  # noqa: E402
from ultragrid_tpu.native import jpeg_scan_decode_lib as ref_scan_lib  # noqa: E402
from ultragrid_tpu.ops import dxt as ref_dxt  # noqa: E402
from ultragrid_tpu.ops import h264_tpu  # noqa: E402
from ultragrid_tpu.ops import pixfmt as ref_pixfmt  # noqa: E402
from ultragrid_tpu.ops.fec import LdgmSession as RefLdgmSession  # noqa: E402
from ultragrid_tpu.ops.jpeg import JpegEncoder as RefJpegEncoder  # noqa: E402
from ultragrid_tpu.ops.jpeg import _parse_headers as ref_parse_headers  # noqa: E402
from ultragrid_tpu.types import Codec, VideoDesc  # noqa: E402

from ultragrid_tpu_torch.ops.h264_device import STOP_STAGES  # noqa: E402
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder  # noqa: E402
from ultragrid_tpu_torch.tools import (bench_h264_enc_dev, bench_jpeg_dev, bench_latency,  # noqa: E402
                                       bench_northstar, bench_pipeline, bench_receiver, bench_scan_decode)

from chip_smoke import free_port_pair  # noqa: E402
from tests.torch_h264_helpers import shared_reference_graphs  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_TOOLS = ROOT / "ultragrid_tpu" / "tools"
CPU = torch.device("cpu")
# the reference's 1080p / 4K / 8K rows at sizes a CPU test affords; the JPEG
# rows keep 64 MCUs or more (XLA's CPU dot sums in FMA order from there)
SMALL = {"1080p": (64, 32), "4K": (256, 128), "8K": (256, 128)}
SLOT_NAMES = ("ys", "ybits", "us", "ubits", "vs", "vbits", "overflow")


def assert_parts_equal(ref_out, port_out, names=SLOT_NAMES):
    assert len(ref_out) == len(port_out) == len(names)
    for name, a, b in zip(names, ref_out, port_out):
        a = np.asarray(a)
        b = b.numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), f"{name} differs"


def reference_report_calls(path):
    """The first argument of every ``report(...)`` call in a reference
    tool's source, in order, and the keys of the dict its report prints."""
    tree = ast.parse(path.read_text())
    labels = [n.args[0].value for n in ast.walk(tree)
              if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "report"
              and isinstance(n.args[0], ast.Constant)]
    report = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "report")
    keys = [k.value for n in ast.walk(report) if isinstance(n, ast.Dict) for k in n.keys]
    return sorted(labels, key=lambda s: path.read_text().index(f'"{s}"')), keys


@pytest.fixture(scope="module")
def pipeline_run():
    """The ten rows at the small sizes, and the lines they printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = bench_pipeline.run(CPU, SMALL)
    return {r.config: r for r in rows}, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def pipeline_rows(pipeline_run):
    return pipeline_run[0]


def test_bench_pipeline_labels_and_keys_are_the_reference(pipeline_run):
    rows, lines = pipeline_run
    labels, keys = reference_report_calls(REF_TOOLS / "bench_pipeline.py")
    assert list(bench_pipeline.CONFIGS) == labels and len(labels) == 10
    assert list(rows) == labels
    printed = [json.loads(ln) for ln in lines]
    assert [p["config"] for p in printed] == labels
    assert all(list(p) == keys == ["config", "ms_per_frame", "fps"] for p in printed)
    for p, r in zip(printed, rows.values()):
        assert r.seconds > 0 and p["ms_per_frame"] == round(r.seconds * 1000, 3)
        assert p["fps"] == round(1.0 / r.seconds, 1)


@pytest.mark.parametrize("idx,a,b", [(0, Codec.UYVY, Codec.RGB), (1, Codec.v210, Codec.RG48),
                                     (2, Codec.R10k, Codec.Y416)])
def test_bench_pipeline_conversions_equal_the_reference(pipeline_rows, idx, a, b):
    row = pipeline_rows[bench_pipeline.CONFIGS[idx]]
    w = SMALL["1080p" if idx == 0 else "4K"][0]
    want = np.asarray(ref_pixfmt.convert_frame(row.frame.numpy(), w, a, b))
    assert np.array_equal(row.last.numpy(), want)


@pytest.mark.parametrize("idx,name,bpb", [(3, "dxt1_encode_rgb", 8), (4, "dxt5_ycocg_encode_rgb", 16)])
def test_bench_pipeline_dxt_within_the_block_rule(pipeline_rows, idx, name, bpb):
    """The DXT tests' rule (tests/test_torch_dxt.py): at most 0.1% of the
    blocks differing, which at 64x32 is none."""
    row = pipeline_rows[bench_pipeline.CONFIGS[idx]]
    want = np.asarray(getattr(ref_dxt, name)(row.frame.numpy(), SMALL["1080p"][0])).reshape(-1, bpb)
    got = row.last.numpy().reshape(-1, bpb)
    assert want.shape == got.shape
    assert int((want != got).any(axis=1).sum()) <= int(0.001 * want.shape[0])


@pytest.mark.parametrize("idx,sub", [(5, None), (7, "420"), (9, None)])
def test_bench_pipeline_jpeg_slots_equal_the_reference(pipeline_rows, idx, sub):
    row = pipeline_rows[bench_pipeline.CONFIGS[idx]]
    w, h = SMALL["8K" if idx == 9 else "4K"]
    ref = RefJpegEncoder(w, h, in_codec=Codec.UYVY, quality=80, subsampling=sub)
    assert_parts_equal(ref.encode_device(row.frame.numpy()), row.last)
    assert_parts_equal(ref.encode_device(row.frame.numpy()), row.plain())


def test_bench_pipeline_pipelined_body_equals_the_reference(pipeline_rows):
    row = pipeline_rows[bench_pipeline.CONFIGS[6]]
    ref = RefJpegEncoder(*SMALL["4K"], in_codec=Codec.UYVY, quality=80)
    parts = ref.encode_device(row.frame.numpy())
    want = ref.assemble(*(np.asarray(p) for p in parts[:-1]))
    assert row.last.tobytes() == want.tobytes()


def test_bench_pipeline_8k_row_ldgm_buffer_equals_the_reference(pipeline_rows):
    """The 8K row's recipe at 256x128: JpegEncoder.encode_device ->
    assemble -> LdgmSession(1500, 250, 5).encode, byte for byte."""
    row = pipeline_rows[bench_pipeline.CONFIGS[8]]
    ref = RefJpegEncoder(*SMALL["8K"], in_codec=Codec.UYVY, quality=80)
    parts = ref.encode_device(row.frame.numpy())
    want, _ = RefLdgmSession(1500, 250, 5).encode(ref.assemble(*(np.asarray(p) for p in parts[:-1])))
    assert row.last.tobytes() == np.asarray(want).tobytes()
    assert row.plain().tobytes() == row.last.tobytes()


def test_pipelined_stage_on_the_cpu_hands_the_parts_through():
    enc = JpegEncoder(256, 128)
    frame = torch.from_numpy(bench_pipeline.content(256, 128, np.random.default_rng(3)))
    seconds, body = bench_pipeline.pipelined_full_path(enc, frame, n=2)
    assert seconds > 0
    assert body.tobytes() == enc.assemble(*enc.encode_device(frame)[:-1]).tobytes()


def test_bench_northstar_step_equals_the_reference(capsys):
    w, h = 256, 128
    res = bench_northstar.run(w, h, 2, CPU)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"== {w}x{h} 4:2:2 UYVY->JPEG q80 + LDGM(256,26,5), one EncodePipeline step on cpu"
    assert lines[1].startswith("amortized /frame (k=2):  min ") and lines[1].endswith(" ms")
    assert lines[2].startswith("single dispatch:            min ") and len(lines) == 3
    assert 0 < res["amortized_min_ms"] <= res["amortized_p50_ms"]
    assert 0 < res["single_min_ms"] <= res["single_p50_ms"]
    ref = ref_encode.EncodePipeline(VideoDesc(w, h, Codec.UYVY, 60.0), ref_encode.EncodeConfig(
        in_codec=Codec.UYVY, compress="jpeg", quality=80, subsampling="422", fec="ldgm:256:26:5"))
    assert_parts_equal(ref(res["frame"].numpy()), res["out"],
                       ("ys", "ybits", "us", "ubits", "vs", "vbits", "parity", "overflow"))


def test_bench_northstar_main_prints_its_rows(capsys):
    assert bench_northstar.main(["128x64", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("== 128x64 4:2:2") and out[1].startswith("amortized") and out[2].startswith("single")


def test_bench_jpeg_dev_times_the_reference_device_half(monkeypatch, capsys):
    frame = bench_jpeg_dev.make_frame(256, 128, device="cpu")
    enc = JpegEncoder(256, 128)
    assert bench_jpeg_dev.timeit(enc.encode_device, frame, iters=2, batches=2) > 0
    ref = RefJpegEncoder(256, 128, in_codec=Codec.UYVY, quality=80)
    assert_parts_equal(ref.encode_device(frame.numpy()), enc.encode_device(frame))
    monkeypatch.setattr(bench_jpeg_dev, "SIZE", (256, 128))
    assert bench_jpeg_dev.main(["2", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith("4K UYVY->JPEG encode_device: ") and line.endswith(" fps)")


def test_bench_scan_decode_coefficients_at_every_thread_count(capsys):
    w, h = 256, 128
    res = bench_scan_decode.run(w, h, 80, 2, CPU)
    assert sorted(res) == [1, 2, 4, 8]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"{w}x{h} q80: ") and [ln.split(":")[0] for ln in lines[1:]] == \
        ["threads=1", "threads=2", "threads=4", "threads=8"]
    # the same stream as the reference's encoder, decoded by the reference's
    # recipe (ref bench_scan_decode.py:46-80) to the same coefficients
    data = bench_scan_decode.make_stream(w, h, 80, CPU)
    ref_data = bytes(np.asarray(RefJpegEncoder(w, h, in_codec=Codec.UYVY, quality=80).encode(
        bench_pipeline.content(w, h, np.random.default_rng(0)))))
    assert data == ref_data
    want_hdr, got_hdr = ref_parse_headers(ref_data), bench_scan_decode._parse_headers(data)
    for key in ("scan", "ri", "scan_start", "htabs"):
        assert want_hdr[key] == got_hdr[key], key
    dec = bench_scan_decode.ScanDecoder(data, w, h)
    assert dec.nmcu == (w // 16) * (h // 8)
    dec.lib = ref_scan_lib()  # the reference's build of the same C decoder
    want = [o.copy() for o in dec(1)]
    assert any(np.any(c) for c in want)
    for n in (1, 2, 4, 8):
        assert len(res[n][2]) == len(want) == 3
        for a, b in zip(want, res[n][2]):
            assert np.array_equal(a, b), n


def test_bench_h264_enc_dev_runs_each_stage_as_the_reference(capsys):
    w, h, qp = 64, 48, 26
    res = bench_h264_enc_dev.run(w, h, qp, CPU, iters=1, batches=1)
    assert sorted(res["p"]) == [32, 64, 96] and sorted(res["intra"]) == [40, 80]
    assert list(res["stages"]) == list(STOP_STAGES)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"== P graph {w}x{h} qp{qp} search=8 (ms/frame, min-of-batches)"
    assert f"== intra graph {w}x{h} qp{qp}" in out
    assert [ln.split()[0] for ln in out if "_stop_after=" in ln] == [f"_stop_after={s}" for s in STOP_STAGES]
    args = bench_h264_enc_dev.frames(w, h)
    for stage in STOP_STAGES:
        want = h264_tpu.make_device_encode_p(w, h, qp, 8, wwords=32, _stop_after=stage)(*args)
        got = res["stage_outputs"][stage]
        assert len(want) == len(got)
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), b.numpy()), stage


def test_bench_latency_two_processes_gives_the_reference_keys():
    res = subprocess.run([sys.executable, "-m", "ultragrid_tpu_torch.tools.bench_latency", "320x176", "30", "40",
                          "jpeg", "ldgm:256:26:5", "--json", "--device", "cpu", "--port", str(free_port_pair())],
                         cwd=ROOT, capture_output=True, text=True, timeout=240,
                         env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"})
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    src = (REF_TOOLS / "bench_latency.py").read_text()
    keys = [k.value for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Dict) for k in n.keys
            if isinstance(k, ast.Constant) and k.value.startswith(("config", "frames", "sustained", "latency_"))]
    assert list(out) == keys
    assert out["config"] == "320x176@30 jpeg fec=ldgm:256:26:5 localhost 2-process"
    assert out["frames"] >= 10 and out["sustained_fps"] > 0
    assert 0 < out["latency_min_ms"] <= out["latency_p50_ms"] <= out["latency_p95_ms"] <= out["latency_p99_ms"]


def test_bench_receiver_session_on_the_cpu(capsys):
    res = bench_receiver.run(320, 176, 10, CPU, port=free_port_pair())
    assert res["frames"] >= 10, res
    assert 0 < res["p50_ms"] <= res["p95_ms"] < 10_000
    assert res["playout_delay_ms"] == pytest.approx(32.0)
    assert all(x > 0 for x in res["latencies_ms"])
    assert "latency last-packet->display p50=" in capsys.readouterr().out


def test_the_session_geometry_the_jpeg_encoders_refuse():
    with pytest.raises(ValueError, match="height % 8"):
        RefJpegEncoder(320, 180, in_codec=Codec.UYVY)
    with pytest.raises(ValueError, match="height % 8"):
        JpegEncoder(320, 180)


@pytest.mark.parametrize("tool,argv", [
    (bench_pipeline, []), (bench_northstar, ["64x32", "1"]), (bench_jpeg_dev, ["1"]),
    (bench_scan_decode, ["64x32"]), (bench_h264_enc_dev, ["64x48"]), (bench_latency, ["64x32"]),
    (bench_receiver, ["64x32", "3"]),
])
def test_a_tool_without_a_card_raises(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(argv)
