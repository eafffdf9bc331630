"""Probing stubs for SDK/hardware-bound devices absent in this build.

The port of ``ultragrid_tpu/modules/hw_stubs.py``, with the reference's
names and probe messages.

The reference registers DeckLink/NDI/AJA/screen modules only when their
SDKs are compiled in; here the names stay visible in ``--list-modules`` and
``--capabilities`` and init reports WHY the device is unavailable (missing
SDK library / no device node / no display server), which is the contract a
user probing a machine needs.  Real integrations plug in by replacing the
stub registration (same module API as testcard/v4l2).

ref: src/video_capture/{decklink,ndi,aja,screen_x11}.cpp,
src/video_display/{decklink,ndi}.cpp, src/audio/capture/alsa.c
"""

from __future__ import annotations

import ctypes.util
import os

from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_capture import VideoCapture
from ultragrid_tpu_torch.modules.video_display import VideoDisplay


def _probe_msg(name: str) -> str:
    checks = {
        "decklink": ("libDeckLinkAPI.so SDK library", ctypes.util.find_library("DeckLinkAPI")),
        "ndi": ("libndi.so (NDI SDK)", ctypes.util.find_library("ndi")),
        "aja": ("libajantv2 SDK", ctypes.util.find_library("ajantv2")),
        "screen": ("a running display server (DISPLAY/WAYLAND_DISPLAY)",
                   os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")),
        "sdl": ("libSDL2 + a display server", ctypes.util.find_library("SDL2")),
        "gl": ("OpenGL context (display server)",
               os.environ.get("DISPLAY") if ctypes.util.find_library("GL") else None),
        "openxr_gl": ("an OpenXR runtime (libopenxr_loader) + HMD",
                      ctypes.util.find_library("openxr_loader")),
        "vulkan": ("libvulkan + a display server",
                   ctypes.util.find_library("vulkan")),
        "alsa": ("libasound (ALSA)", ctypes.util.find_library("asound")),
    }
    what, found = checks.get(name, (name, None))
    if found:
        return f"{name}: {what} found but device integration requires hardware not present here"
    return f"{name}: unavailable — needs {what}"


def _make_capture_stub(name: str):
    class _Stub(VideoCapture):
        def __init__(self, cfg: str, device="cuda"):
            raise RuntimeError(_probe_msg(name))

    _Stub.__name__ = f"{name.capitalize()}CaptureStub"
    return _Stub


def _make_display_stub(name: str):
    class _Stub(VideoDisplay):
        def __init__(self, cfg: str, device="cuda"):
            raise RuntimeError(_probe_msg(name))

    _Stub.__name__ = f"{name.capitalize()}DisplayStub"
    return _Stub


# "screen" has a real implementation now (modules/screen_capture.py — pure
# wire-protocol X11 client), and "gl" renders through EGL-surfaceless Mesa
# (modules/gl_display.py); only the SDK-bound cards remain stubs.
for _name in ("decklink", "ndi", "aja"):
    register_module(_name, LibraryClass.VIDEO_CAPTURE, _make_capture_stub(_name))
# openxr_gl = the reference's stereo-HMD viewer
# (src/video_display/openxr_gl.cpp, gated on the OpenXR SDK exactly like
# this); pano_gl covers the mono-360 role natively.
for _name in ("decklink", "ndi", "sdl", "openxr_gl", "vulkan"):
    register_module(_name, LibraryClass.VIDEO_DISPLAY, _make_display_stub(_name))


# audio devices (ref: src/audio/capture/{alsa,pipewire,jack,portaudio,
# coreaudio,wasapi}.c* — each compiled in only with its SDK/daemon).
# Plain classes (no audio.capture import: that module imports the registry,
# and importing it back here would be circular).  The modules package
# imports this module before audio/capture.py, whose ALSA device then
# replaces the ``alsa`` stub, as in the reference.


def _audio_probe_msg(name: str) -> str:
    checks = {
        "alsa": ("libasound + /dev/snd", ctypes.util.find_library("asound")
                 if os.path.exists("/dev/snd") else None),
        "pipewire": ("a PipeWire daemon (libpipewire-0.3)",
                     ctypes.util.find_library("pipewire-0.3")),
        "jack": ("a JACK server (libjack)", ctypes.util.find_library("jack")),
        "portaudio": ("libportaudio", ctypes.util.find_library("portaudio")),
        "pulse": ("a PulseAudio daemon (libpulse)", ctypes.util.find_library("pulse")),
        "coreaudio": ("macOS CoreAudio", None),
        "wasapi": ("Windows WASAPI", None),
        "sdi": ("an SDI capture card with embedded audio "
                "(DeckLink/AJA/Deltacast SDK)", None),
    }
    what, found = checks.get(name, (name, None))
    if found:
        return f"{name}: {what} found but no audio device present in this environment"
    return f"{name}: unavailable — needs {what}"


def _make_audio_stub(name: str):
    class _Stub:
        def __init__(self, cfg: str = ""):
            raise RuntimeError(_audio_probe_msg(name))

    _Stub.__name__ = f"{name.capitalize()}AudioStub"
    return _Stub


for _name in ("alsa", "pipewire", "jack", "portaudio", "pulse", "coreaudio",
              "wasapi", "sdi"):
    _stub = _make_audio_stub(_name)
    register_module(_name, LibraryClass.AUDIO_CAPTURE, _stub)
    register_module(_name, LibraryClass.AUDIO_PLAYBACK, _stub)
