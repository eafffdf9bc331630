"""Local pipeline: capture -> filter -> convert -> display (the minimal end-to-end slice).

Port of ``ultragrid_tpu/pipeline/loop.py``.  Mirrors the reference's
thread-per-stage design (capture thread src/main.cpp:347-397 feeding the
display via queues).  Frames stay on the capture's device from the testcard
ring to the display; only a display that writes files fetches to the host.

On the card both threads enqueue their work on one CUDA stream, the stream
current where the pipeline was built (``device.pipeline_stream``), whichever
stream the thread that calls ``run()`` has: the display thread's conversion
is ordered after the capture thread's filters by the stream itself, so a
frame taken from the queue is never read before it is written.  The queue holds at
most 2 frames, which bounds the memory of a 4K loop.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Optional

from ultragrid_tpu_torch.device import pipeline_stream, stream_context
from ultragrid_tpu_torch.modules.filters import FilterChain
from ultragrid_tpu_torch.modules.video_capture import VideoCapture, initialize_video_capture
from ultragrid_tpu_torch.modules.video_display import VideoDisplay, initialize_video_display
from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.types import Codec, VideoFrame
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("pipeline")

_POISON = object()


class CaptureToDisplayPipeline:
    """capture thread -> [filters] -> queue -> [postprocess, convert] ->
    display, the queue bounded at 2 frames."""

    def __init__(
        self,
        capture: VideoCapture,
        display: VideoDisplay,
        frame_limit: Optional[int] = None,
        capture_filter: str = "",
        postprocess: str = "",
    ):
        self.capture = capture
        self.display = display
        self.frame_limit = frame_limit
        self.capture_chain = FilterChain(capture_filter)
        self.postprocess_chain = FilterChain(postprocess)
        self.queue: "queue.Queue" = queue.Queue(maxsize=2)
        self.should_exit = threading.Event()
        self._decoder = None
        self._out_codec: Optional[Codec] = None
        self._error: Optional[BaseException] = None
        self.frames_captured = 0
        self.stream = pipeline_stream(capture.device)

    def _setup_conversion(self, frame: VideoFrame) -> bool:
        codecs = self.display.get_property_codecs()
        dec, out = pixfmt.get_best_decoder_from(frame.desc.color_spec, codecs)
        if dec is None:
            log.error(f"no conversion from {frame.desc.color_spec.name} to display codecs")
            return False
        self._decoder = dec
        self._out_codec = out
        self.display.reconfigure(frame.desc.with_(color_spec=out))
        log.info(f"decoder: {frame.desc.color_spec.name} -> {out.name}")
        return True

    def _capture_thread(self) -> None:
        try:
            with stream_context(self.stream):
                while not self.should_exit.is_set():
                    if self.frame_limit is not None and self.frames_captured >= self.frame_limit:
                        break
                    frame, _audio = self.capture.grab()
                    if frame is not None:
                        frame = self.capture_chain.apply(frame)
                    if frame is None:
                        continue
                    self.frames_captured += 1
                    self.queue.put(frame)
        except BaseException as exc:  # re-raised by run() in the caller's thread
            self._error = exc
        finally:
            self.queue.put(_POISON)

    def convert(self, frame: VideoFrame) -> VideoFrame:
        """The display-codec conversion of one postprocessed frame."""
        if self._out_codec == frame.desc.color_spec:
            return frame
        converted = pixfmt.convert_frame(frame.data, frame.desc.width, frame.desc.color_spec, self._out_codec)
        out = VideoFrame(frame.desc.with_(color_spec=self._out_codec), [converted])
        out.timestamp = frame.timestamp
        return out

    def _display_loop(self) -> None:
        with stream_context(self.stream):
            while True:
                item = self.queue.get()
                if item is _POISON:
                    break
                result = self.postprocess_chain.apply(item)
                if result is None:
                    continue
                # postprocess may fan one frame out into several (double_framerate)
                for frame in result if isinstance(result, list) else [result]:
                    if self._decoder is None and not self._setup_conversion(frame):
                        self.should_exit.set()
                        break
                    self.display.put_frame(self.convert(frame))
            self.display.put_frame(None)

    def run(self) -> int:
        t = threading.Thread(target=self._capture_thread, name="capture", daemon=True)
        t.start()
        try:
            self._display_loop()
        finally:
            self.should_exit.set()
            # unblock a capture thread waiting on a full queue
            while t.is_alive():
                with contextlib.suppress(queue.Empty):
                    self.queue.get(timeout=0.1)
            t.join()
        if self._error is not None:
            raise self._error
        return self.frames_captured


def run_local_pipeline(
    capture_spec: str,
    display_spec: str,
    frame_limit: Optional[int] = None,
    capture_filter: str = "",
    postprocess: str = "",
    device="cuda",
) -> int:
    """Run capture -> filters -> postprocess -> display until
    ``frame_limit`` frames were captured; frames live on ``device``, the
    card unless the caller names another.  Returns the frames captured."""
    cap = initialize_video_capture(capture_spec, device=device)
    disp = initialize_video_display(display_spec, device=device)
    try:
        return CaptureToDisplayPipeline(cap, disp, frame_limit, capture_filter, postprocess).run()
    finally:
        disp.done()
        cap.done()
