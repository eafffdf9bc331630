"""Per-packet AES-128 encryption, wire-compatible with the reference.

The port's copy of ``ultragrid_tpu/utils/crypto.py`` (ref:
src/crypto/openssl_encrypt.c): key = MD5(passphrase); packet format
``[uint32 data_len LE][16 B IV][ciphertext]``, where the plaintext of the
non-GCM modes is followed by an encrypted CRC-32 of (aad || plaintext), and
GCM appends its 16-byte tag with the payload headers as AAD.  The 1-word
crypto payload header carries the cipher mode in its top byte (ref:
rtp_types.h:154-161, transmit.c:742-747).  Host work, as in the reference.

The ciphers come from the Python package ``cryptography``, imported when a
:class:`PacketCrypto` is made: where it is not installed, ``-e`` raises an
error that names it.
"""

from __future__ import annotations

import hashlib
import os
import struct
import zlib
from typing import Optional

MODE_NONE = 0
MODE_CTR = 1
MODE_CFB = 2
MODE_ECB = 3
MODE_CBC = 4
MODE_GCM = 5

GCM_TAG_LEN = 16
MODE_NAMES = {"ctr": MODE_CTR, "cfb": MODE_CFB, "ecb": MODE_ECB, "cbc": MODE_CBC, "gcm": MODE_GCM}


def _primitives():
    """(Cipher, algorithms, modes) of ``cryptography``, or an error naming
    the package."""
    try:
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
    except ImportError as e:
        raise RuntimeError("-e/--encryption needs the Python package 'cryptography', "
                           "which is not installed") from e
    return Cipher, algorithms, modes


def _crc32_ug(aad: bytes, plaintext: bytes) -> int:
    """UG's crc32buf chain: seed 0xFFFFFFFF, no final inversion
    (ref: crc32buf / crc32buf_with_oldcrc, src/crypto/crc.c)."""
    # zlib.crc32(data, s) computes ~update(~s, data); invert around it
    crc = 0xFFFFFFFF
    for chunk in (aad, plaintext):
        crc = zlib.crc32(chunk, crc ^ 0xFFFFFFFF) ^ 0xFFFFFFFF
    return crc


class PacketCrypto:
    """Symmetric encrypt/decrypt of RTP payloads (one instance per session)."""

    def __init__(self, passphrase: str, mode: int = MODE_GCM):
        self._Cipher, self._alg, self._modes = _primitives()
        if ":cipher=" in passphrase:
            passphrase, _, cipher = passphrase.partition(":cipher=")
            mode = MODE_NAMES.get(cipher, MODE_GCM)
        self.key = hashlib.md5(passphrase.encode()).digest()
        self.mode = mode

    def _cipher(self, iv: bytes):
        alg = self._alg.AES(self.key)
        modes = self._modes
        if self.mode == MODE_CTR:
            return self._Cipher(alg, modes.CTR(iv))
        if self.mode == MODE_CFB:
            return self._Cipher(alg, modes.CFB(iv))
        if self.mode == MODE_CBC:
            return self._Cipher(alg, modes.CBC(iv))
        if self.mode == MODE_ECB:
            return self._Cipher(alg, modes.ECB())
        raise ValueError(f"unsupported mode {self.mode}")

    def encrypt(self, plaintext: bytes, aad: bytes) -> bytes:
        iv = os.urandom(8) + bytes(8)  # the reference randomises 8 bytes
        out = struct.pack("<I", len(plaintext)) + iv
        if self.mode == MODE_GCM:
            c = self._Cipher(self._alg.AES(self.key), self._modes.GCM(iv)).encryptor()
            c.authenticate_additional_data(aad)
            ct = c.update(plaintext) + c.finalize()
            return out + ct + c.tag
        data = plaintext + struct.pack("<I", _crc32_ug(aad, plaintext))
        if self.mode in (MODE_CBC, MODE_ECB):
            # EVP default PKCS#7 padding (always added)
            pad = 16 - len(data) % 16
            data += bytes([pad]) * pad
        enc = self._cipher(iv).encryptor()
        return out + enc.update(data) + enc.finalize()

    def decrypt(self, packet: bytes, aad: bytes) -> Optional[bytes]:
        if len(packet) < 20:
            return None
        (data_len,) = struct.unpack("<I", packet[:4])
        iv = packet[4:20]
        body = packet[20:]
        if self.mode == MODE_GCM:
            if len(body) < GCM_TAG_LEN:
                return None
            ct, tag = body[:-GCM_TAG_LEN], body[-GCM_TAG_LEN:]
            try:
                d = self._Cipher(self._alg.AES(self.key), self._modes.GCM(iv, tag)).decryptor()
                d.authenticate_additional_data(aad)
                pt = d.update(ct) + d.finalize()
            except Exception:  # noqa: BLE001 - an authentication failure drops the packet
                return None
            return pt[:data_len]
        if self.mode in (MODE_CBC, MODE_ECB) and (not body or len(body) % 16):
            return None  # truncated or crafted packet: not a whole block count
        try:
            dec = self._cipher(iv).decryptor()
            pt = dec.update(body) + dec.finalize()
        except Exception:  # noqa: BLE001 - malformed ciphertext must not stop the receiver
            return None
        if len(pt) < data_len + 4:
            return None
        plaintext = pt[:data_len]
        (crc,) = struct.unpack("<I", pt[data_len: data_len + 4])
        if crc != _crc32_ug(aad, plaintext):
            return None
        return plaintext

    def crypto_header(self) -> bytes:
        """1-word crypto payload header (cipher in the top byte)."""
        return struct.pack("!I", self.mode << 24)
