"""Minimal X11 wire-protocol client (pure sockets, no Xlib).

The port's copy of ``ultragrid_tpu/net/x11.py``, unchanged in behaviour: the
slice of the core protocol the screen capture needs -- connection setup
(with MIT-MAGIC-COOKIE-1 auth from ``~/.Xauthority``), ``GetGeometry``,
``GetImage`` (ZPixmap) -- plus the XFIXES extension's ``GetCursorImage``
for cursor compositing, and the window requests a display would use.  The
reference links Xlib for the same calls (ref:
src/video_capture/screen_x11.c:131-147 XOpenDisplay / XGetImage;
XFixesGetCursorImage for the pointer); here the requests are spoken on the
wire directly.

DISPLAY grammar: ``:N[.S]`` / ``host:N[.S]`` as usual; additionally a name
containing ``/`` is taken as an explicit unix-socket path (the XQuartz /
launchd convention), which is also what the tests' mock server uses.
"""

from __future__ import annotations

import os
import socket
import struct
from typing import Optional, Tuple


class X11Error(RuntimeError):
    pass


def parse_display(name: Optional[str] = None):
    """DISPLAY name -> ("unix", path, dispnum, screen) | ("tcp", (host, port), dispnum, screen)."""
    if name is None:
        name = os.environ.get("DISPLAY")
    if not name:
        raise X11Error("no DISPLAY set")
    if "/" in name:  # explicit socket path
        return ("unix", name, 0, 0)
    host, _, rest = name.rpartition(":")
    if not rest:
        raise X11Error(f"bad DISPLAY {name!r}")
    disp_s, _, screen_s = rest.partition(".")
    disp = int(disp_s)
    screen = int(screen_s) if screen_s else 0
    if host in ("", "unix"):
        return ("unix", f"/tmp/.X11-unix/X{disp}", disp, screen)
    return ("tcp", (host, 6000 + disp), disp, screen)


def read_xauthority(dispnum: int) -> Optional[Tuple[bytes, bytes]]:
    """Find a MIT-MAGIC-COOKIE-1 for this display in $XAUTHORITY/~/.Xauthority."""
    path = os.environ.get("XAUTHORITY") or os.path.expanduser("~/.Xauthority")
    try:
        raw = open(path, "rb").read()
    except OSError:
        return None
    hostname = socket.gethostname().encode()
    pos, best = 0, None
    while pos + 2 <= len(raw):
        def field():
            nonlocal pos
            (n,) = struct.unpack(">H", raw[pos : pos + 2])
            pos += 2
            v = raw[pos : pos + n]
            pos += n
            return v

        fam_b = raw[pos : pos + 2]
        pos += 2
        (family,) = struct.unpack(">H", fam_b)
        addr = field()
        display = field()
        name = field()
        data = field()
        if name != b"MIT-MAGIC-COOKIE-1":
            continue
        if display and display != str(dispnum).encode():
            continue
        # FamilyLocal(256)/FamilyWild(65535) or matching hostname
        if family in (256, 65535) or addr in (hostname, b"localhost", b""):
            best = (name, data)
    return best


def _pad4(b: bytes) -> bytes:
    return b + b"\x00" * (-len(b) % 4)


class X11Connection:
    """One synchronous X11 client connection (request/reply lockstep)."""

    def __init__(self, display: Optional[str] = None, timeout: float = 5.0):
        kind, addr, dispnum, screen_idx = parse_display(display)
        if kind == "unix":
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.settimeout(timeout)
        try:
            self.sock.connect(addr)
        except OSError as e:
            self.sock.close()
            raise X11Error(f"cannot open display {display or os.environ.get('DISPLAY')}: {e}")
        self._seq = 0
        try:
            self._handshake(dispnum, screen_idx)
        except Exception:
            self.sock.close()
            raise

    # -- low-level ------------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise X11Error("X server closed the connection")
            buf += chunk
        return buf

    def _request(self, data: bytes) -> int:
        self.sock.sendall(data)
        self._seq = (self._seq + 1) & 0xFFFF
        return self._seq

    def _reply(self) -> bytes:
        """Read one reply (32 bytes + extra); raise on X error packets."""
        head = self._recv_exact(32)
        if head[0] == 0:  # Error
            code, seq = head[1], struct.unpack("<H", head[2:4])[0]
            raise X11Error(f"X error code {code} (seq {seq})")
        if head[0] != 1:  # Event — none are selected; skip defensively
            return self._reply()
        (extra,) = struct.unpack("<I", head[4:8])
        return head + (self._recv_exact(extra * 4) if extra else b"")

    # -- connection setup ----------------------------------------------

    def _handshake(self, dispnum: int, screen_idx: int) -> None:
        auth = read_xauthority(dispnum)
        name, data = auth if auth else (b"", b"")
        req = struct.pack("<BxHHHHxx", 0x6C, 11, 0, len(name), len(data))
        self.sock.sendall(req + _pad4(name) + _pad4(data))
        head = self._recv_exact(8)
        status = head[0]
        (length,) = struct.unpack("<H", head[6:8])
        body = self._recv_exact(length * 4)
        if status != 1:
            reason_len = head[1]
            raise X11Error(f"connection refused: {body[32:32+reason_len] if status == 0 else body!r}")
        (
            release,
            rid_base,
            rid_mask,
            motion,
            vendor_len,
            max_req,
            nscreens,
            nformats,
            self.image_byte_order,
            bitmap_order,
            scan_unit,
            self.scanline_pad,
            minkc,
            maxkc,
        ) = struct.unpack("<IIIIHHBBBBBBBB", body[:28])
        self._rid_base, self._rid_mask = rid_base, rid_mask
        self._rid_next = 0
        self.max_req_bytes = max_req * 4
        pos = 32 + len(_pad4(b"\x00" * vendor_len))
        self.formats = {}
        for _ in range(nformats):
            depth, bpp, spad = struct.unpack("<BBB", body[pos : pos + 3])
            self.formats[depth] = (bpp, spad)
            pos += 8
        screens = []
        for _ in range(nscreens):
            root, cmap, white, black, masks = struct.unpack("<IIIII", body[pos : pos + 20])
            w_px, h_px, w_mm, h_mm, minm, maxm = struct.unpack("<HHHHHH", body[pos + 20 : pos + 32])
            root_visual = struct.unpack("<I", body[pos + 32 : pos + 36])[0]
            root_depth = body[pos + 38]
            ndepths = body[pos + 39]
            pos += 40
            for _ in range(ndepths):
                nvis = struct.unpack("<H", body[pos + 2 : pos + 4])[0]
                pos += 8 + nvis * 24
            screens.append(
                dict(root=root, width=w_px, height=h_px, root_visual=root_visual, root_depth=root_depth)
            )
        if not screens:
            raise X11Error("setup reply carried no screens")
        self.screen = screens[min(screen_idx, len(screens) - 1)]
        self.root = self.screen["root"]
        self._xfixes_opcode = None

    # -- core requests --------------------------------------------------

    def get_geometry(self, drawable: Optional[int] = None):
        """-> (x, y, width, height, depth) of a drawable (opcode 14)."""
        d = self.root if drawable is None else drawable
        self._request(struct.pack("<BxHI", 14, 2, d))
        rep = self._reply()
        depth = rep[1]
        root, x, y, w, h = struct.unpack("<IhhHH", rep[8:20])
        return x, y, w, h, depth

    def get_image(self, x: int, y: int, w: int, h: int, drawable: Optional[int] = None):
        """ZPixmap GetImage (opcode 73) -> (depth, bpp, raw bytes, visual)."""
        d = self.root if drawable is None else drawable
        self._request(struct.pack("<BBHIhhHHI", 73, 2, 5, d, x, y, w, h, 0xFFFFFFFF))
        rep = self._reply()
        depth = rep[1]
        visual = struct.unpack("<I", rep[8:12])[0]
        bpp = self.formats.get(depth, (32, 32))[0]
        return depth, bpp, rep[32:], visual

    # -- display-side requests (window + PutImage; ref role:
    # src/video_display/{sdl3,gl}.cpp present a frame in a window — here
    # the core protocol is spoken directly, no SDL/GL libs needed) ------

    def gen_id(self) -> int:
        """Allocate a fresh resource id from the server's RID range."""
        rid = self._rid_base | (self._rid_next & self._rid_mask)
        self._rid_next += 1
        return rid

    def create_window(self, w: int, h: int, title: str = "ultragrid_tpu") -> int:
        """CreateWindow (opcode 1) + WM_NAME + MapWindow (opcode 8)."""
        wid = self.gen_id()
        # value-mask: background-pixel (0x2) black so resize gaps are not garbage
        req = struct.pack(
            "<BBHIIhhHHHHII",
            1, self.screen["root_depth"], 9, wid, self.root,
            0, 0, w, h, 0, 1,  # border 0, class InputOutput
            self.screen["root_visual"], 0x2,
        ) + struct.pack("<I", 0)
        self._request(req)
        name = title.encode()
        # ChangeProperty(18) Replace WM_NAME(39) type STRING(31) format 8
        self._request(
            struct.pack("<BBHIIIBxxxI", 18, 0, 6 + len(_pad4(name)) // 4,
                        wid, 39, 31, 8, len(name)) + _pad4(name)
        )
        self._request(struct.pack("<BxHI", 8, 2, wid))  # MapWindow
        return wid

    def destroy_window(self, wid: int) -> None:
        self._request(struct.pack("<BxHI", 4, 2, wid))

    def create_gc(self, drawable: int) -> int:
        gc = self.gen_id()
        self._request(struct.pack("<BxHIII", 55, 4, gc, drawable, 0))
        return gc

    def put_image(self, drawable: int, gc: int, x: int, y: int,
                  w: int, h: int, bgrx: bytes) -> None:
        """PutImage (opcode 72, ZPixmap, bpp 32) with row chunking so each
        request stays under the server's max-request-length."""
        row = w * 4
        max_rows = max(1, (self.max_req_bytes - 24) // max(row, 1))
        sent = 0
        while sent < h:
            n = min(max_rows, h - sent)
            chunk = bgrx[sent * row : (sent + n) * row]
            self._request(
                struct.pack(
                    "<BBHIIHHhhBBH", 72, 2, 6 + (len(chunk) + 3) // 4,
                    drawable, gc, w, n, x, y + sent, 0,
                    self.screen["root_depth"], 0,
                ) + _pad4(chunk)
            )
            sent += n

    def sync(self) -> None:
        """Round-trip barrier: GetInputFocus (opcode 43) reply drains any
        pending async error for the fire-and-forget requests above."""
        self._request(struct.pack("<BxH", 43, 1))
        self._reply()

    # -- XFIXES cursor --------------------------------------------------

    def _xfixes_init(self) -> bool:
        if self._xfixes_opcode is not None:
            return self._xfixes_opcode > 0
        name = b"XFIXES"
        self._request(struct.pack("<BxHHxx", 98, 2 + len(_pad4(name)) // 4, len(name)) + _pad4(name))
        rep = self._reply()
        present, major = rep[8], rep[9]
        if not present:
            self._xfixes_opcode = -1
            return False
        self._xfixes_opcode = major
        # XFixesQueryVersion (minor 0), client version 4.0 — REQUIRED before use
        self._request(struct.pack("<BBHII", major, 0, 3, 4, 0))
        self._reply()
        return True

    def get_cursor_image(self):
        """XFixesGetCursorImage -> (x, y, w, h, xhot, yhot, argb uint32 LE
        bytes) or None when the extension is missing."""
        try:
            if not self._xfixes_init():
                return None
            self._request(struct.pack("<BBH", self._xfixes_opcode, 4, 1))
            rep = self._reply()
            x, y, w, h, xhot, yhot = struct.unpack("<hhHHHH", rep[8:20])
            argb = rep[32 : 32 + w * h * 4]
            return x, y, w, h, xhot, yhot, argb
        except X11Error:
            return None

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
