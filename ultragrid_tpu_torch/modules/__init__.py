"""The port's modules: registry, capture, filters, displays (the windowed
x11, gl and drm among them), compression (libavcodec's among them), the
hardware probe stubs, and the import capture and audio devices registered
beside them.

Importing the package registers every built-in module in the port's own
registry (ref: constructor-time REGISTER_MODULE, src/lib_common.h:124-143),
as the JAX package's ``ultragrid_tpu/modules/__init__.py`` does for its own.
"""

from ultragrid_tpu_torch.modules.registry import (  # noqa: F401
    LibraryClass,
    list_modules,
    load_library,
    register_module,
)

import ultragrid_tpu_torch.modules.video_capture  # noqa: E402,F401
import ultragrid_tpu_torch.modules.video_display  # noqa: E402,F401
import ultragrid_tpu_torch.modules.video_compress  # noqa: E402,F401
import ultragrid_tpu_torch.modules.video_decompress  # noqa: E402,F401
import ultragrid_tpu_torch.modules.filters  # noqa: E402,F401
import ultragrid_tpu_torch.modules.extra_displays  # noqa: E402,F401
import ultragrid_tpu_torch.modules.stitch  # noqa: E402,F401
import ultragrid_tpu_torch.modules.ipc_display  # noqa: E402,F401
# libavcodec's modules before the RTSP capture, as in the reference's list
import ultragrid_tpu_torch.modules.lavc  # noqa: E402,F401
import ultragrid_tpu_torch.modules.rtsp_capture  # noqa: E402,F401
import ultragrid_tpu_torch.modules.file_io  # noqa: E402,F401
import ultragrid_tpu_torch.modules.v4l2_capture  # noqa: E402,F401
import ultragrid_tpu_torch.modules.screen_capture  # noqa: E402,F401
import ultragrid_tpu_torch.modules.x11_display  # noqa: E402,F401
import ultragrid_tpu_torch.modules.gl_display  # noqa: E402,F401
import ultragrid_tpu_torch.modules.drm_display  # noqa: E402,F401
# the hardware probe stubs register before the audio devices below, so the
# real ``alsa`` replaces its stub (the reference's order)
import ultragrid_tpu_torch.modules.hw_stubs  # noqa: E402,F401
import ultragrid_tpu_torch.modules.ug_input  # noqa: E402,F401
import ultragrid_tpu_torch.utils.export  # noqa: E402,F401  (registers the 'import' capture device)
# the audio devices register too, so --list-modules sees them; these are
# imports by module name only (audio/capture.py imports its sibling devices
# once AudioCapture exists, so entering through any of them does not cycle)
import ultragrid_tpu_torch.audio.capture  # noqa: E402,F401
import ultragrid_tpu_torch.audio.playback  # noqa: E402,F401
