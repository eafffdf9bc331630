"""ug_input capture: grab frames from an embedded receiver.

The port of ``ultragrid_tpu/modules/ug_input.py``, the counterpart of the
reference's ``ug_input`` capture device (ref: src/video_capture/ug_input.c):
it runs the port's receive pipeline in-process on the capture's device (the
card unless the caller names another), routes the displayed frames through
the ``pipe`` display's delegate mechanism into a bounded queue
(MAX_QUEUE_SIZE = 2, dropping with a warning when full -- same policy as
ug_input.c:58-70), and serves them as a capture device.  This chains
UltraGrid instances inside one process: ``-t ug_input:port=5004`` receives a
stream and re-captures it for recompression/retransmission (the in-process
analogue of hd-rum-translator).
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Optional, Tuple

from ultragrid_tpu_torch.modules.extra_displays import register_pipe_delegate
from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_capture import VideoCapture
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("ug_input")

MAX_QUEUE_SIZE = 2  # ref: ug_input.c:33
_seq = itertools.count()


class UgInputCapture(VideoCapture):
    """``ug_input[:port=<rx_port>][:decompress][:timeout=<s>]``"""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        port = 5004
        timeout = None
        for tok in [t for t in cfg.split(":") if t]:
            key, _, val = tok.partition("=")
            if key == "port":
                port = int(val)
            elif key == "timeout":
                timeout = float(val)
            elif key == "decompress":
                pass  # frames are always decoded to a pixfmt by the receiver
            elif key == "help":
                print("ug_input capture: ug_input[:port=<rx_port>][:timeout=<s>]")
        self.q: "queue.Queue" = queue.Queue()
        key = f"__ug_input_{next(_seq)}"

        def delegate(frame) -> None:
            if frame is None:
                self.q.put(None)
                return
            if self.q.qsize() >= MAX_QUEUE_SIZE:
                log.warning("Dropping frame!")  # ref: ug_input.c:66
                return
            self.q.put(frame)

        register_pipe_delegate(key, delegate)
        from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver

        self.receiver = VideoReceiver(
            display_spec=f"pipe:{key}", rx_port=port, timeout=timeout, device=self.device
        )
        self.thread = threading.Thread(target=self.receiver.run, daemon=True)
        self.thread.start()
        log.notice(f"embedded receiver listening on port {port}")

    def grab(self) -> Tuple[Optional[object], Optional[object]]:
        try:
            frame = self.q.get(timeout=5.0)
        except queue.Empty:
            return None, None
        return frame, None

    def done(self) -> None:
        self.receiver.should_exit = True
        self.thread.join(timeout=5.0)


register_module("ug_input", LibraryClass.VIDEO_CAPTURE, UgInputCapture)
