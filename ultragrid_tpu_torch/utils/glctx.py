"""Headless OpenGL core-profile context via EGL's surfaceless platform.

Role: the reference drives its OpenGL display through GLFW + an on-screen
window (ref: src/video_display/gl.c:583-700) and refuses to build without
a display stack.  Here the context comes from EGL_MESA_platform_surfaceless
instead — no display server, no window system, the framebuffer object IS
the "window" — which makes the GL path testable in CI and usable for
offscreen work (thumbnails, filters) on any machine with Mesa.

The port's copy of ``ultragrid_tpu/utils/glctx.py`` (jax-free; copied, not
imported, so the port never runs the JAX package's ``__init__``).

Every GL entry point is resolved through ``eglGetProcAddress`` (the only
portable lookup for core-profile functions) with a ``libGL`` dlsym
fallback, and wrapped in ctypes with explicit argtypes.  Only the ~35
functions the display path needs are bound; :meth:`GLContext.fn` resolves
anything else on demand.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

__all__ = ["GLError", "GLContext", "GL"]

# -- EGL constants ----------------------------------------------------------
EGL_PLATFORM_SURFACELESS_MESA = 0x31DD
EGL_OPENGL_API = 0x30A2
EGL_CONTEXT_MAJOR_VERSION = 0x3098
EGL_CONTEXT_MINOR_VERSION = 0x30FB
EGL_CONTEXT_OPENGL_PROFILE_MASK = 0x30FD
EGL_CONTEXT_OPENGL_CORE_PROFILE_BIT = 0x1
EGL_NONE = 0x3038

# -- GL constants (the subset the display uses) -----------------------------
class GL:
    TEXTURE_2D = 0x0DE1
    TEXTURE_MIN_FILTER = 0x2801
    TEXTURE_MAG_FILTER = 0x2800
    TEXTURE_WRAP_S = 0x2802
    TEXTURE_WRAP_T = 0x2803
    NEAREST = 0x2600
    LINEAR = 0x2601
    CLAMP_TO_EDGE = 0x812F
    UNPACK_ALIGNMENT = 0x0CF5
    PACK_ALIGNMENT = 0x0D05
    RGBA8 = 0x8058
    RGB8 = 0x8051
    RGBA = 0x1908
    RGB = 0x1907
    UNSIGNED_BYTE = 0x1401
    FLOAT = 0x1406
    COMPRESSED_RGB_S3TC_DXT1 = 0x83F0
    COMPRESSED_RGBA_S3TC_DXT5 = 0x83F3
    FRAGMENT_SHADER = 0x8B30
    VERTEX_SHADER = 0x8B31
    COMPILE_STATUS = 0x8B81
    LINK_STATUS = 0x8B82
    FRAMEBUFFER = 0x8D40
    COLOR_ATTACHMENT0 = 0x8CE0
    FRAMEBUFFER_COMPLETE = 0x8CD5
    COLOR_BUFFER_BIT = 0x4000
    TRIANGLES = 0x0004
    NUM_EXTENSIONS = 0x821D
    EXTENSIONS = 0x1F03
    VENDOR = 0x1F00
    RENDERER = 0x1F01
    VERSION = 0x1F02
    NO_ERROR = 0


class GLError(RuntimeError):
    pass


_VOID = None
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_SZ = ctypes.c_ssize_t
_P = ctypes.c_void_p
_CP = ctypes.c_char_p

# name -> (restype, argtypes)
_GL_FUNCS = {
    "glGetError": (_U, ()),
    "glGetString": (_CP, (_U,)),
    "glGetStringi": (_CP, (_U, _U)),
    "glGetIntegerv": (_VOID, (_U, _P)),
    "glPixelStorei": (_VOID, (_U, _I)),
    "glGenTextures": (_VOID, (_I, _P)),
    "glDeleteTextures": (_VOID, (_I, _P)),
    "glBindTexture": (_VOID, (_U, _U)),
    "glTexParameteri": (_VOID, (_U, _U, _I)),
    "glTexImage2D": (_VOID, (_U, _I, _I, _I, _I, _I, _U, _U, _P)),
    "glTexSubImage2D": (_VOID, (_U, _I, _I, _I, _I, _I, _U, _U, _P)),
    "glCompressedTexImage2D": (_VOID, (_U, _I, _U, _I, _I, _I, _I, _P)),
    "glCompressedTexSubImage2D": (_VOID, (_U, _I, _I, _I, _I, _I, _U, _I, _P)),
    "glCreateShader": (_U, (_U,)),
    "glShaderSource": (_VOID, (_U, _I, _P, _P)),
    "glCompileShader": (_VOID, (_U,)),
    "glGetShaderiv": (_VOID, (_U, _U, _P)),
    "glGetShaderInfoLog": (_VOID, (_U, _I, _P, _P)),
    "glDeleteShader": (_VOID, (_U,)),
    "glCreateProgram": (_U, ()),
    "glAttachShader": (_VOID, (_U, _U)),
    "glLinkProgram": (_VOID, (_U,)),
    "glGetProgramiv": (_VOID, (_U, _U, _P)),
    "glGetProgramInfoLog": (_VOID, (_U, _I, _P, _P)),
    "glUseProgram": (_VOID, (_U,)),
    "glDeleteProgram": (_VOID, (_U,)),
    "glGetUniformLocation": (_I, (_U, _CP)),
    "glUniform1i": (_VOID, (_I, _I)),
    "glUniform1f": (_VOID, (_I, _F)),
    "glUniform4f": (_VOID, (_I, _F, _F, _F, _F)),
    "glGenFramebuffers": (_VOID, (_I, _P)),
    "glDeleteFramebuffers": (_VOID, (_I, _P)),
    "glBindFramebuffer": (_VOID, (_U, _U)),
    "glFramebufferTexture2D": (_VOID, (_U, _U, _U, _U, _I)),
    "glCheckFramebufferStatus": (_U, (_U,)),
    "glGenVertexArrays": (_VOID, (_I, _P)),
    "glBindVertexArray": (_VOID, (_U,)),
    "glDeleteVertexArrays": (_VOID, (_I, _P)),
    "glViewport": (_VOID, (_I, _I, _I, _I)),
    "glClearColor": (_VOID, (_F, _F, _F, _F)),
    "glClear": (_VOID, (_U,)),
    "glDrawArrays": (_VOID, (_U, _I, _I)),
    "glFinish": (_VOID, ()),
    "glReadPixels": (_VOID, (_I, _I, _I, _I, _U, _U, _P)),
}


class GLContext:
    """EGL-surfaceless core-profile GL context with FBO helpers."""

    def __init__(self) -> None:
        try:
            self._egl = ctypes.CDLL("libEGL.so.1")
            self._libgl = ctypes.CDLL("libGL.so.1")
        except OSError as e:  # pragma: no cover - env without Mesa
            raise GLError(f"gl: Mesa libraries unavailable ({e})")
        egl = self._egl
        egl.eglGetProcAddress.restype = _P
        egl.eglGetProcAddress.argtypes = (_CP,)
        get_plat = egl.eglGetProcAddress(b"eglGetPlatformDisplayEXT")
        if not get_plat:
            raise GLError("gl: eglGetPlatformDisplayEXT unavailable")
        get_plat_fn = ctypes.CFUNCTYPE(_P, _U, _P, _P)(get_plat)
        self._dpy = get_plat_fn(EGL_PLATFORM_SURFACELESS_MESA, None, None)
        if not self._dpy:
            raise GLError("gl: no EGL surfaceless display (Mesa too old?)")
        major, minor = _I(), _I()
        if not egl.eglInitialize(_P(self._dpy), ctypes.byref(major), ctypes.byref(minor)):
            raise GLError("gl: eglInitialize failed")
        if not egl.eglBindAPI(EGL_OPENGL_API):
            raise GLError("gl: desktop OpenGL API not supported")
        egl.eglCreateContext.restype = _P
        self._ctx = None
        for mj, mn in ((4, 5), (3, 3)):
            attribs = (_I * 7)(
                EGL_CONTEXT_MAJOR_VERSION, mj, EGL_CONTEXT_MINOR_VERSION, mn,
                EGL_CONTEXT_OPENGL_PROFILE_MASK, EGL_CONTEXT_OPENGL_CORE_PROFILE_BIT,
                EGL_NONE)
            ctx = egl.eglCreateContext(_P(self._dpy), None, None, attribs)
            if ctx:
                self._ctx = ctx
                break
        if not self._ctx:
            raise GLError("gl: could not create a core-profile context")
        if not egl.eglMakeCurrent(_P(self._dpy), None, None, _P(self._ctx)):
            raise GLError("gl: eglMakeCurrent (surfaceless) failed — "
                          "needs EGL_KHR_surfaceless_context")
        self._fns: dict = {}
        for name, (res, args) in _GL_FUNCS.items():
            setattr(self, name, self._resolve(name, res, args))
        ver = self.glGetString(GL.VERSION)
        self.renderer = (self.glGetString(GL.RENDERER) or b"?").decode()
        self.version = (ver or b"?").decode()
        # Mesa decodes S3TC unconditionally since 20.x; still verify.
        n = _I()
        self.glGetIntegerv(GL.NUM_EXTENSIONS, ctypes.byref(n))
        exts = {self.glGetStringi(GL.EXTENSIONS, i) for i in range(n.value)}
        self.has_s3tc = b"GL_EXT_texture_compression_s3tc" in exts
        # core-profile draws require a bound VAO even with no attributes
        vao = _U()
        self.glGenVertexArrays(1, ctypes.byref(vao))
        self.glBindVertexArray(vao.value)
        self._vao = vao
        # EGL contexts are thread-bound; release now and re-bind lazily on
        # whichever (single) thread drives the display — the pipeline's
        # decode thread is not the constructing thread.
        egl.eglMakeCurrent(_P(self._dpy), None, None, None)
        self._bound_tid: Optional[int] = None

    def ensure_current(self) -> None:
        """Bind the context on the calling thread (idempotent per thread).
        One thread at a time may drive GL — same contract as the
        reference's GL display thread."""
        tid = threading.get_ident()
        if tid == self._bound_tid:
            return
        if not self._egl.eglMakeCurrent(_P(self._dpy), None, None, _P(self._ctx)):
            raise GLError("gl: context is bound to another thread")
        self._bound_tid = tid
        self.glBindVertexArray(self._vao.value)

    def _resolve(self, name: str, restype, argtypes):
        ptr = self._egl.eglGetProcAddress(name.encode())
        if not ptr:
            try:
                fn = getattr(self._libgl, name)
                fn.restype = restype
                fn.argtypes = argtypes
                return fn
            except AttributeError:
                raise GLError(f"gl: cannot resolve {name}")
        return ctypes.CFUNCTYPE(restype, *argtypes)(ptr)

    def fn(self, name: str, restype, *argtypes):
        """Resolve an extra GL function on demand."""
        key = name
        if key not in self._fns:
            self._fns[key] = self._resolve(name, restype, argtypes)
        return self._fns[key]

    # -- helpers ------------------------------------------------------------

    def check(self, where: str = "") -> None:
        err = self.glGetError()
        if err != GL.NO_ERROR:
            raise GLError(f"gl: error 0x{err:04x} {where}")

    def compile_program(self, vert_src: str, frag_src: str) -> int:
        def compile_one(kind, src):
            sh = self.glCreateShader(kind)
            buf = ctypes.c_char_p(src.encode())
            arr = (ctypes.c_char_p * 1)(buf)
            self.glShaderSource(sh, 1, ctypes.cast(arr, _P), None)
            self.glCompileShader(sh)
            ok = _I()
            self.glGetShaderiv(sh, GL.COMPILE_STATUS, ctypes.byref(ok))
            if not ok.value:
                log = ctypes.create_string_buffer(4096)
                self.glGetShaderInfoLog(sh, 4096, None, log)
                raise GLError(f"gl: shader compile failed: {log.value.decode()}")
            return sh

        vs = compile_one(GL.VERTEX_SHADER, vert_src)
        fs = compile_one(GL.FRAGMENT_SHADER, frag_src)
        prog = self.glCreateProgram()
        self.glAttachShader(prog, vs)
        self.glAttachShader(prog, fs)
        self.glLinkProgram(prog)
        ok = _I()
        self.glGetProgramiv(prog, GL.LINK_STATUS, ctypes.byref(ok))
        if not ok.value:
            log = ctypes.create_string_buffer(4096)
            self.glGetProgramInfoLog(prog, 4096, None, log)
            raise GLError(f"gl: program link failed: {log.value.decode()}")
        self.glDeleteShader(vs)
        self.glDeleteShader(fs)
        return prog

    def make_texture(self, filter_mode: Optional[int] = None) -> int:
        tex = _U()
        self.glGenTextures(1, ctypes.byref(tex))
        self.glBindTexture(GL.TEXTURE_2D, tex.value)
        mode = GL.NEAREST if filter_mode is None else filter_mode
        self.glTexParameteri(GL.TEXTURE_2D, GL.TEXTURE_MIN_FILTER, mode)
        self.glTexParameteri(GL.TEXTURE_2D, GL.TEXTURE_MAG_FILTER, mode)
        self.glTexParameteri(GL.TEXTURE_2D, GL.TEXTURE_WRAP_S, GL.CLAMP_TO_EDGE)
        self.glTexParameteri(GL.TEXTURE_2D, GL.TEXTURE_WRAP_T, GL.CLAMP_TO_EDGE)
        return tex.value

    def make_fbo_texture(self, w: int, h: int):
        """RGBA8 render target; returns (fbo, texture)."""
        tex = self.make_texture()
        self.glTexImage2D(GL.TEXTURE_2D, 0, GL.RGBA8, w, h, 0,
                          GL.RGBA, GL.UNSIGNED_BYTE, None)
        fbo = _U()
        self.glGenFramebuffers(1, ctypes.byref(fbo))
        self.glBindFramebuffer(GL.FRAMEBUFFER, fbo.value)
        self.glFramebufferTexture2D(GL.FRAMEBUFFER, GL.COLOR_ATTACHMENT0,
                                    GL.TEXTURE_2D, tex, 0)
        status = self.glCheckFramebufferStatus(GL.FRAMEBUFFER)
        if status != GL.FRAMEBUFFER_COMPLETE:
            raise GLError(f"gl: framebuffer incomplete 0x{status:04x}")
        return fbo.value, tex

    def read_rgb(self, w: int, h: int) -> bytes:
        """Read the bound FBO back as packed RGB rows (frame top-down —
        the display renders row 0 at GL y=0, so no flip is needed)."""
        buf = ctypes.create_string_buffer(w * h * 3)
        self.glPixelStorei(GL.PACK_ALIGNMENT, 1)
        self.glReadPixels(0, 0, w, h, GL.RGB, GL.UNSIGNED_BYTE, buf)
        return buf.raw

    def destroy(self) -> None:
        if getattr(self, "_egl", None) is None:
            return
        egl = self._egl
        egl.eglMakeCurrent(_P(self._dpy), None, None, None)
        if self._ctx:
            egl.eglDestroyContext(_P(self._dpy), _P(self._ctx))
            self._ctx = None
