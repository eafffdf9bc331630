"""A mock X server for the port's screen capture and X11 displays, with no
JAX in its imports.

A copy of ``MockXServer`` in ``tests/test_screen_capture.py``: the capture
side (the setup handshake, QueryExtension, GetGeometry, GetImage ZPixmap,
GetInputFocus, XFIXES QueryVersion and GetCursorImage), serving a seeded
depth-24 / bpp-32 LSB-first framebuffer over a unix socket, and the display
side (CreateWindow, MapWindow, DestroyWindow, ChangeProperty WM_NAME,
CreateGC, PutImage ZPixmap), keeping each window's contents as RGB.  That
file imports the JAX package, so ``chip_smoke.py`` and the isolation test
take this one; ``tests/test_torch_captures.py`` and
``tests/test_torch_displays.py`` hold it to the original.
"""

import os
import socket
import struct
import threading

import numpy as np

ROOT_WIN = 0x2C0
XFIXES_OP = 140


def _pad4(b):
    return b + b"\x00" * (-len(b) % 4)


class MockXServer(threading.Thread):
    """Minimal X server: depth-24/bpp-32 LSB-first root window."""

    def __init__(self, path, width=64, height=32, with_xfixes=False, cursor=None):
        super().__init__(daemon=True)
        self.path = path
        self.width, self.height = width, height
        self.with_xfixes = with_xfixes
        # framebuffer as RGB for test reference; served as BGRX
        rng = np.random.default_rng(7)
        self.fb_rgb = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        self.cursor = cursor  # (x, y, w, h, xhot, yhot, argb_np [h,w] u32)
        self.auth_seen = None
        # display-side state (CreateWindow/PutImage from the x11 display)
        self.windows = {}  # wid -> np [h, w, 3] RGB contents
        self.mapped = set()
        self.titles = {}
        self.gcs = set()
        self.put_count = 0
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(path)
        self.sock.listen(2)
        self.start()

    def _setup_reply(self):
        vendor = b"mockx"
        fmt = struct.pack("<BBB5x", 24, 32, 32)  # depth 24 -> bpp 32
        screen = struct.pack(
            "<IIIIIHHHHHHIBBBB",
            ROOT_WIN, 1, 0xFFFFFF, 0, 0,
            self.width, self.height, 100, 50, 1, 1,
            0x21, 0, 0, 24, 1,
        )
        depth_rec = struct.pack("<BxHxxxx", 24, 0)  # 0 visuals (client ignores)
        body = struct.pack(
            "<IIIIHHBBBBBBBB4x",
            11000000, 0x200000, 0x1FFFFF, 256,
            len(vendor), 65535, 1, 1,
            0,  # image byte order LSB
            0, 32, 32, 8, 255,
        ) + _pad4(vendor) + fmt + screen + depth_rec
        return struct.pack("<BxHHH", 1, 11, 0, len(body) // 4) + body

    def run(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn):
        try:
            head = self._recv(conn, 12)
            if not head:
                return
            n_auth, d_auth = struct.unpack("<HH", head[6:10])
            name = self._recv(conn, len(_pad4(b"x" * n_auth)))[:n_auth]
            data = self._recv(conn, len(_pad4(b"x" * d_auth)))[:d_auth]
            self.auth_seen = (name, data)
            conn.sendall(self._setup_reply())
            seq = 0
            while True:
                req = self._recv(conn, 4)
                if not req:
                    return
                opcode, detail = req[0], req[1]
                (rlen,) = struct.unpack("<H", req[2:4])
                rest = self._recv(conn, rlen * 4 - 4) if rlen > 1 else b""
                seq = (seq + 1) & 0xFFFF
                if opcode == 98:  # QueryExtension
                    (nlen,) = struct.unpack("<H", rest[:2])
                    ext = rest[4 : 4 + nlen]
                    present = 1 if (ext == b"XFIXES" and self.with_xfixes) else 0
                    conn.sendall(struct.pack("<BxHIBBBB20x", 1, seq, 0, present, XFIXES_OP, 0, 0))
                elif opcode == 14:  # GetGeometry
                    conn.sendall(struct.pack("<BBHIIhhHHH10x", 1, 24, seq, 0,
                                             ROOT_WIN, 0, 0, self.width, self.height, 0))
                elif opcode == 73:  # GetImage ZPixmap
                    d, x, y, w, h, mask = struct.unpack("<IhhHHI", rest)
                    region = self.fb_rgb[y : y + h, x : x + w]
                    bgrx = np.zeros((h, w, 4), np.uint8)
                    bgrx[:, :, 0] = region[:, :, 2]
                    bgrx[:, :, 1] = region[:, :, 1]
                    bgrx[:, :, 2] = region[:, :, 0]
                    raw = bgrx.tobytes()
                    conn.sendall(struct.pack("<BBHII20x", 1, 24, seq, len(raw) // 4, 0x21) + raw)
                elif opcode == 1:  # CreateWindow
                    wid, parent, x, y, w, h = struct.unpack("<IIhhHH", rest[:16])
                    self.windows[wid] = np.zeros((h, w, 3), np.uint8)
                elif opcode == 8:  # MapWindow
                    (wid,) = struct.unpack("<I", rest[:4])
                    self.mapped.add(wid)
                elif opcode == 4:  # DestroyWindow
                    (wid,) = struct.unpack("<I", rest[:4])
                    self.windows.pop(wid, None)
                    self.mapped.discard(wid)
                elif opcode == 18:  # ChangeProperty (WM_NAME)
                    wid, prop, ptype = struct.unpack("<III", rest[:12])
                    (nlen,) = struct.unpack("<I", rest[16:20])
                    if prop == 39:
                        self.titles[wid] = rest[20 : 20 + nlen].decode()
                elif opcode == 55:  # CreateGC
                    (gc,) = struct.unpack("<I", rest[:4])
                    self.gcs.add(gc)
                elif opcode == 72:  # PutImage (ZPixmap, bpp 32)
                    drawable, gc, w, h, dx, dy = struct.unpack("<IIHHhh", rest[:16])
                    raw = np.frombuffer(rest[20 : 20 + w * h * 4], np.uint8)
                    px = raw.reshape(h, w, 4)
                    fb = self.windows.get(drawable)
                    if fb is not None:
                        # LSB-first BGRX -> RGB
                        fb[dy : dy + h, dx : dx + w, 0] = px[:, :, 2]
                        fb[dy : dy + h, dx : dx + w, 1] = px[:, :, 1]
                        fb[dy : dy + h, dx : dx + w, 2] = px[:, :, 0]
                    self.put_count += 1
                elif opcode == 43:  # GetInputFocus (sync barrier)
                    conn.sendall(struct.pack("<BBHII20x", 1, 0, seq, 0, 0))
                elif opcode == XFIXES_OP and detail == 0:  # XFixesQueryVersion
                    conn.sendall(struct.pack("<BxHIII16x", 1, seq, 0, 4, 0))
                elif opcode == XFIXES_OP and detail == 4:  # GetCursorImage
                    cx, cy, cw, ch, xh, yh, argb = self.cursor
                    raw = argb.astype("<u4").tobytes()
                    conn.sendall(
                        struct.pack("<BxHIhhHHHHI8x", 1, seq, len(raw) // 4,
                                    cx, cy, cw, ch, xh, yh, 1) + raw)
                else:  # unsupported -> X error
                    conn.sendall(struct.pack("<BBH28x", 0, 1, seq))
        except OSError:
            pass
        finally:
            conn.close()

    @staticmethod
    def _recv(conn, n):
        buf = b""
        while len(buf) < n:
            c = conn.recv(n - len(buf))
            if not c:
                return buf if len(buf) == n else b""
            buf += c
        return buf

    def close(self):
        self.sock.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass
