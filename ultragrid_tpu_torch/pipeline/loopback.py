"""Loopback rxtx: sender output handed straight to the receive side in one
process, no network (ref: src/rxtx/loopback.c, the reference's single-process
end-to-end fixture with a bounded buffer, BUFF_MAX_LEN=2).

The port of ``ultragrid_tpu/pipeline/loopback.py``: capture -> capture
filters -> compress -> decompress -> postprocess -> display, so compression
codecs run end to end without sockets (``--protocol loopback`` on the CLI).
Both threads enter the pipeline's one CUDA stream (the rule of
``pipeline/loop.py``).
"""

from __future__ import annotations

import threading
from typing import Optional

from ultragrid_tpu_torch.device import get_device, pipeline_stream, stream_context
from ultragrid_tpu_torch.modules.filters import FilterChain
from ultragrid_tpu_torch.modules.messaging import Module
from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture
from ultragrid_tpu_torch.modules.video_compress import CompressDriver
from ultragrid_tpu_torch.modules.video_decompress import decompress_init
from ultragrid_tpu_torch.modules.video_display import initialize_video_display
from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.types import VideoFrame, is_codec_opaque
from ultragrid_tpu_torch.utils import profiler
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("loopback")

BUFF_MAX_LEN = 2  # frames queued between the halves (ref: loopback.c:62)


class LoopbackRxTx:
    """capture -> compress -> decompress -> display, all in-process, on
    ``device`` (the card unless the caller names another)."""

    def __init__(
        self,
        capture_spec: str,
        display_spec: str,
        compress_spec: str = "none",
        frame_limit: Optional[int] = None,
        capture_filter: str = "",
        postprocess: str = "",
        device="cuda",
    ):
        self.device = get_device(device)
        self.stream = pipeline_stream(self.device)
        self.capture = initialize_video_capture(capture_spec, device=self.device)
        self.display = initialize_video_display(display_spec, device=self.device)
        self.capture_chain = FilterChain(capture_filter)
        self.postprocess = FilterChain(postprocess)
        self.root = Module("root")
        self.compress = CompressDriver(compress_spec, self.root, self.device, self.stream,
                                       queue_len=BUFF_MAX_LEN)
        self.frame_limit = frame_limit
        self.frames_shown = 0
        self._display_desc = None
        self._decomp = None
        self._decomp_out = None
        self._decomp_in = None
        self._decoder = None
        self._decoder_in = None

    def _capture_thread(self) -> None:
        count = 0
        try:
            with stream_context(self.stream):
                while self.frame_limit is None or count < self.frame_limit:
                    with profiler.zone("capture.grab"):
                        frame, _audio = self.capture.grab()
                    if frame is not None:
                        frame = self.capture_chain.apply(frame)
                    if frame is None:
                        continue
                    count += 1
                    self.compress.enqueue(frame)
        finally:
            self.compress.enqueue(None)

    def _to_displayable(self, frame):
        """Decompress / convert to a codec the display accepts (the same
        selection logic as the network receiver)."""
        if is_codec_opaque(frame.desc.color_spec):
            if self._decomp is None or frame.desc.color_spec != self._decomp_in:
                self._decomp, self._decomp_out = decompress_init(
                    frame.desc.color_spec, self.display.get_property_codecs(), self.device)
                self._decomp_in = frame.desc.color_spec
                if self._decomp is None:
                    log.error(f"no decompressor for {frame.desc.color_spec.name}")
                    return None
            with profiler.zone("rx.decompress"):
                frame = self._decomp.decompress(frame, self._decomp_out)
            if frame is None:
                return None
        codecs = self.display.get_property_codecs()
        if frame.desc.color_spec not in codecs:
            if self._decoder is None or frame.desc.color_spec != self._decoder_in:
                self._decoder, self._decoder_out = pixfmt.get_best_decoder_from(
                    frame.desc.color_spec, codecs)
                self._decoder_in = frame.desc.color_spec
            if self._decoder is None:
                return None
            data = pixfmt.convert_frame(frame.data, frame.desc.width, frame.desc.color_spec,
                                        self._decoder_out)
            frame = VideoFrame(frame.desc.with_(color_spec=self._decoder_out), [data], frame.timestamp)
        return frame

    def run(self) -> int:
        t = threading.Thread(target=self._capture_thread, name="loopback-cap", daemon=True)
        t.start()
        with stream_context(self.stream):
            while True:
                frame = self.compress.pop()
                if frame is None:
                    break
                out = self._to_displayable(frame)
                if out is None:
                    continue
                out = self.postprocess.apply(out)
                if out is None:
                    continue
                for fr in out if isinstance(out, list) else [out]:
                    if self._display_desc != fr.desc:
                        self.display.reconfigure(fr.desc)
                        self._display_desc = fr.desc
                    self.display.put_frame(fr)
                    self.frames_shown += 1
        self.display.put_frame(None)
        self.display.done()  # join display workers before interpreter exit
        self.capture.done()
        t.join(timeout=5)
        return self.frames_shown
