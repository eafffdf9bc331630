"""OpenGL display (``-d gl``): GLSL conversion shaders on a real GL context.

The port of ``ultragrid_tpu/modules/gl_display.py``.  The reference's
principal desktop display converts UYVY / DXT1 / DXT1_YUV / DXT5-YCoCg to
RGB *in fragment shaders* and draws a textured quad (ref:
src/video_display/gl.c:104-340 shader table, display_gl_putf render loop).
This display keeps that design with an EGL-surfaceless context (Mesa,
``utils/glctx.py``; no display server) rendering into an FBO; on-screen
presentation goes through the port's wire-protocol X11 client when asked
(``gl:window``).  Compressed codecs upload as S3TC textures so the *driver*
does the block decode, as in the reference.

A frame on the card comes to the host once, through the displays' download
helper, for the texture upload; the FBO's read-back is the display's output
(:meth:`GlDisplay.last_rgb`).  The EGL context is bound to one thread at a
time: each call makes it current on the calling thread, the pipeline's
display thread (which enters the pipeline's stream).

Config: ``gl[:window][:display=<DISPLAY>][:title=<str>][:deinterlace]``.

The YCbCr->RGB coefficients are the limited-range BT.601/709 constants of
the port's device conversions (``ops/color.py``, its default colour space;
ref: src/color_space.c COEFFS()), substituted into the shader like the
reference's ``*_PLACEHOLDER`` scheme (gl.c:118-139).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np
import torch

from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_display import VideoDisplay, _host_bytes
from ultragrid_tpu_torch.modules.x11_display import rgb_to_zpixmap
from ultragrid_tpu_torch.net.x11 import X11Connection, X11Error
from ultragrid_tpu_torch.ops.color import KB_601, KB_709, KR_601, KR_709, Colorspace, get_default_cs
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
from ultragrid_tpu_torch.utils.glctx import GL, GLContext, GLError
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("gl")

_VERT = """#version 330 core
out vec2 uv;
void main() {
    vec2 p = vec2(float((gl_VertexID << 1) & 2), float(gl_VertexID & 2));
    uv = p;
    gl_Position = vec4(p * 2.0 - 1.0, 0.0, 1.0);
}
"""

# UYVY texel = (U, Y0, V, Y1) as RGBA8 at width/2; texelFetch + parity pick
# replaces the reference's GLSL-1.1 coordinate arithmetic (gl.c:118-139).
_FRAG_UYVY = """#version 330 core
uniform sampler2D image;
uniform vec4 cc;     // y_scaled, r_cr, g_cb, g_cr
uniform float b_cb;
in vec2 uv;
out vec4 frag;
void main() {
    ivec2 sz = textureSize(image, 0);
    int x = int(uv.x * float(sz.x * 2));
    int y = int(uv.y * float(sz.y));
    vec4 t = texelFetch(image, ivec2(x >> 1, y), 0);
    float Y = ((x & 1) == 1) ? t.a : t.g;
    float u = t.r - 0.5;
    float v = t.b - 0.5;
    Y = cc.x * (Y - 0.0625);
    frag = vec4(Y + cc.y * v, Y + cc.z * u + cc.w * v, Y + b_cb * u, 1.0);
}
"""

_FRAG_COPY = """#version 330 core
uniform sampler2D image;
in vec2 uv;
out vec4 frag;
void main() { frag = vec4(texture(image, uv).rgb, 1.0); }
"""

# second pass over the converted RGB: blend each line with the next
# (ref: deinterlace_fp, gl.c:104-116 — same (pix + pix_down)/2 average).
_FRAG_DEINT = """#version 330 core
uniform sampler2D image;
in vec2 uv;
out vec4 frag;
void main() {
    ivec2 sz = textureSize(image, 0);
    ivec2 p = ivec2(int(uv.x * float(sz.x)), int(uv.y * float(sz.y)));
    vec4 a = texelFetch(image, p, 0);
    vec4 b = texelFetch(image, ivec2(p.x, min(p.y + 1, sz.y - 1)), 0);
    frag = (a + b) / 2.0;
}
"""

# S3TC texture holds YUV in RGB channels (ref: fp_display_dxt1_yuv,
# gl.c:277-294 — constants there are hardwired 709; here they ride the
# same uniforms as UYVY).
_FRAG_DXT1_YUV = """#version 330 core
uniform sampler2D image;
uniform vec4 cc;
uniform float b_cb;
in vec2 uv;
out vec4 frag;
void main() {
    vec4 t = texture(image, uv);
    float Y = cc.x * (t.r - 0.0625);
    float u = t.g - 0.5;
    float v = t.b - 0.5;
    frag = vec4(Y + cc.y * v, Y + cc.z * u + cc.w * v, Y + b_cb * u, 1.0);
}
"""

# ref: fp_display_dxt5ycocg, gl.c:304-321 (same scale/offset math; our
# encoder ops/dxt.py:191-307 emits the matching layout: Co=R, Cg=G,
# scale-1 in B's 5-bit field, Y=alpha).
_FRAG_DXT5_YCOCG = """#version 330 core
uniform sampler2D image;
in vec2 uv;
out vec4 frag;
void main() {
    vec4 t = texture(image, uv);
    float scale = (t.b * (255.0 / 8.0)) + 1.0;
    float Co = (t.r - (0.5 * 256.0 / 255.0)) / scale;
    float Cg = (t.g - (0.5 * 256.0 / 255.0)) / scale;
    float Y = t.a;
    frag = vec4(Y + Co - Cg, Y + Cg, Y - Co - Cg, 1.0);
}
"""


def _shader_coeffs(height: int):
    """Float limited-range coefficients — same formulas color_space.c feeds
    COEFFS(), following the session default colorspace so the shader agrees
    with the port's device conversions (ops/color.py get_color_coeffs)."""
    del height
    kr, kb = ((KR_601, KB_601) if get_default_cs() == Colorspace.CS_601
              else (KR_709, KB_709))
    kg = 1.0 - kr - kb
    yl = 219.0 / 255.0
    cl = 224.0 / 255.0
    y_scaled = 1.0 / yl
    r_cr = 2.0 * (1.0 - kr) / cl
    g_cb = (-kb * 2.0 * (kr + kg) / kg) / cl
    g_cr = (-kr * 2.0 * (1.0 - kr) / kg) / cl
    b_cb = 2.0 * (kr + kg) / cl
    return y_scaled, r_cr, g_cb, g_cr, b_cb


class GlDisplay(VideoDisplay):
    """Shader-converting GL display; offscreen FBO, optional X11 window."""

    retains_frames = True  # holds put frames/views past put_frame

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.windowed = False
        self.display_name: Optional[str] = None
        self.title = "ultragrid_tpu"
        self.deinterlace = False
        for tok in filter(None, cfg.split(":")):
            if tok == "window":
                self.windowed = True
            elif tok.startswith("display="):
                self.display_name = tok[8:]
                self.windowed = True
            elif tok.startswith("title="):
                self.title = tok[6:]
            elif tok in ("deinterlace", "d"):  # ref: gl.c "d" option
                self.deinterlace = True
            elif tok == "help":
                raise SystemExit(self.usage())
        try:
            self.ctx = GLContext()
        except GLError as e:
            raise RuntimeError(str(e))
        log.notice(f"[gl] {self.ctx.renderer} (GL {self.ctx.version})")
        self._programs: dict = {}
        self._tex = 0
        self._fbo = 0
        self._fbo_tex = 0
        self._fbo2 = 0
        self._fbo2_tex = 0
        self._last_rgb: Optional[np.ndarray] = None
        self.x11 = None
        self.win = None
        self.gc = None
        if self.windowed:
            self.x11 = X11Connection(self.display_name)

    @staticmethod
    def usage() -> str:
        return ("gl display (EGL surfaceless + GLSL conversions)\n"
                "usage: -d gl[:window][:display=<DISPLAY>][:title=<t>]"
                "[:deinterlace]")

    def get_property_codecs(self) -> List[Codec]:
        codecs = [Codec.UYVY, Codec.RGBA, Codec.RGB]
        if self.ctx.has_s3tc:
            codecs += [Codec.DXT1, Codec.DXT1_YUV, Codec.DXT5]
        return codecs

    # -- lifecycle ----------------------------------------------------------

    def reconfigure(self, desc: VideoDesc) -> bool:
        gl = self.ctx
        gl.ensure_current()
        self.desc = desc
        w, h = desc.width, desc.height
        if self._tex:
            gl.glDeleteTextures(1, ctypes.byref(ctypes.c_uint(self._tex)))
        self._tex = gl.make_texture(
            GL.LINEAR if desc.color_spec in (Codec.DXT1, Codec.DXT1_YUV, Codec.DXT5)
            else GL.NEAREST)
        gl.glPixelStorei(GL.UNPACK_ALIGNMENT, 1)
        cs = desc.color_spec
        if cs == Codec.UYVY:
            gl.glTexImage2D(GL.TEXTURE_2D, 0, GL.RGBA8, (w + 1) // 2, h, 0,
                            GL.RGBA, GL.UNSIGNED_BYTE, None)
        elif cs == Codec.RGB:
            gl.glTexImage2D(GL.TEXTURE_2D, 0, GL.RGB8, w, h, 0,
                            GL.RGB, GL.UNSIGNED_BYTE, None)
        elif cs == Codec.RGBA:
            gl.glTexImage2D(GL.TEXTURE_2D, 0, GL.RGBA8, w, h, 0,
                            GL.RGBA, GL.UNSIGNED_BYTE, None)
        elif cs in (Codec.DXT1, Codec.DXT1_YUV, Codec.DXT5):
            if not self.ctx.has_s3tc:
                log.error("gl: S3TC not supported by this driver")
                return False
            fmt = (GL.COMPRESSED_RGBA_S3TC_DXT5 if cs == Codec.DXT5
                   else GL.COMPRESSED_RGB_S3TC_DXT1)
            bw, bh = (w + 3) // 4 * 4, (h + 3) // 4 * 4
            size = (bw // 4) * (bh // 4) * (16 if cs == Codec.DXT5 else 8)
            gl.glCompressedTexImage2D(GL.TEXTURE_2D, 0, fmt, bw, bh, 0, size,
                                      b"\x00" * size)
        else:
            log.error(f"gl: unsupported codec {cs.name}")
            return False
        gl.check("alloc texture")

        if self._fbo:
            gl.glDeleteFramebuffers(1, ctypes.byref(ctypes.c_uint(self._fbo)))
            gl.glDeleteTextures(1, ctypes.byref(ctypes.c_uint(self._fbo_tex)))
        self._fbo, self._fbo_tex = gl.make_fbo_texture(w, h)
        if self.deinterlace:
            if getattr(self, "_fbo2", 0):
                gl.glDeleteFramebuffers(1, ctypes.byref(ctypes.c_uint(self._fbo2)))
                gl.glDeleteTextures(1, ctypes.byref(ctypes.c_uint(self._fbo2_tex)))
            self._fbo2, self._fbo2_tex = gl.make_fbo_texture(w, h)
            if "deint" not in self._programs:
                self._programs["deint"] = gl.compile_program(_VERT, _FRAG_DEINT)
        gl.glViewport(0, 0, w, h)

        key = cs
        if key not in self._programs:
            frag = {Codec.UYVY: _FRAG_UYVY, Codec.RGB: _FRAG_COPY,
                    Codec.RGBA: _FRAG_COPY, Codec.DXT1: _FRAG_COPY,
                    Codec.DXT1_YUV: _FRAG_DXT1_YUV,
                    Codec.DXT5: _FRAG_DXT5_YCOCG}[cs]
            self._programs[key] = gl.compile_program(_VERT, frag)
        prog = self._programs[key]
        gl.glUseProgram(prog)
        loc = gl.glGetUniformLocation(prog, b"image")
        if loc >= 0:
            gl.glUniform1i(loc, 0)
        ys, r_cr, g_cb, g_cr, b_cb = _shader_coeffs(h)
        loc = gl.glGetUniformLocation(prog, b"cc")
        if loc >= 0:
            gl.glUniform4f(loc, ys, r_cr, g_cb, g_cr)
        loc = gl.glGetUniformLocation(prog, b"b_cb")
        if loc >= 0:
            gl.glUniform1f(loc, b_cb)

        if self.x11 is not None:
            if self.win is not None:
                self.x11.destroy_window(self.win)
            self.win = self.x11.create_window(w, h, self.title)
            self.gc = self.x11.create_gc(self.win)
            self.x11.sync()
        log.notice(f"[gl] reconfigured {w}x{h} {cs.name}")
        return True

    def put_frame(self, frame: Optional[VideoFrame], blocking: bool = True) -> None:
        if frame is None or self.desc is None:
            return
        gl = self.ctx
        gl.ensure_current()
        desc = self.desc
        w, h = desc.width, desc.height
        cs = desc.color_spec
        data = np.ascontiguousarray(_host_bytes(frame.data))
        gl.glBindTexture(GL.TEXTURE_2D, self._tex)
        if cs == Codec.UYVY:
            gl.glTexSubImage2D(GL.TEXTURE_2D, 0, 0, 0, (w + 1) // 2, h,
                               GL.RGBA, GL.UNSIGNED_BYTE,
                               data.ctypes.data_as(ctypes.c_void_p))
        elif cs == Codec.RGB:
            gl.glTexSubImage2D(GL.TEXTURE_2D, 0, 0, 0, w, h,
                               GL.RGB, GL.UNSIGNED_BYTE,
                               data.ctypes.data_as(ctypes.c_void_p))
        elif cs == Codec.RGBA:
            gl.glTexSubImage2D(GL.TEXTURE_2D, 0, 0, 0, w, h,
                               GL.RGBA, GL.UNSIGNED_BYTE,
                               data.ctypes.data_as(ctypes.c_void_p))
        else:  # S3TC codecs: driver-side block decode, like the reference
            fmt = (GL.COMPRESSED_RGBA_S3TC_DXT5 if cs == Codec.DXT5
                   else GL.COMPRESSED_RGB_S3TC_DXT1)
            bw, bh = (w + 3) // 4 * 4, (h + 3) // 4 * 4
            gl.glCompressedTexSubImage2D(
                GL.TEXTURE_2D, 0, 0, 0, bw, bh, fmt, data.size,
                data.ctypes.data_as(ctypes.c_void_p))
        gl.glBindFramebuffer(GL.FRAMEBUFFER, self._fbo)
        gl.glDrawArrays(GL.TRIANGLES, 0, 3)
        if self.deinterlace:
            prog = self._programs[cs]
            gl.glUseProgram(self._programs["deint"])
            gl.glBindTexture(GL.TEXTURE_2D, self._fbo_tex)
            gl.glBindFramebuffer(GL.FRAMEBUFFER, self._fbo2)
            gl.glDrawArrays(GL.TRIANGLES, 0, 3)
            gl.glUseProgram(prog)
        gl.glFinish()
        gl.check("render")

        rgb = np.frombuffer(bytearray(gl.read_rgb(w, h)), np.uint8).reshape(h, w, 3)
        self._last_rgb = rgb
        if self.x11 is not None and self.win is not None:
            self.x11.put_image(self.win, self.gc, 0, 0, w, h,
                               rgb_to_zpixmap(torch.from_numpy(rgb), self.x11.image_byte_order))
            self.x11.sync()
        super().put_frame(frame, blocking)

    def last_rgb(self) -> Optional[np.ndarray]:
        """Rendered output of the most recent frame ([h, w, 3] uint8) —
        the FBO readback (tests, thumbnails, preview taps)."""
        return self._last_rgb

    def done(self) -> None:
        try:
            if self.x11 is not None:
                if self.win is not None:
                    self.x11.destroy_window(self.win)
                    self.x11.sync()
                self.x11.close()
        except (OSError, X11Error):  # the server may already be gone
            pass
        self.ctx.destroy()


register_module("gl", LibraryClass.VIDEO_DISPLAY, GlDisplay)
