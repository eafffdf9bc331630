"""The flagship sender step on tensors: frame -> JPEG -> LDGM parity.

Port of ``ultragrid_tpu/models/encode.py`` for ``compress="jpeg"`` with
``fec="none"`` or ``fec="ldgm:k:m:c"``.  The JPEG device half (kernel K1 on
the card) emits per-block slot words and bit counts; the LDGM parity (kernel
K2 on the card) protects the slot-aligned container of those six arrays
while it is still on the device, each array starting on a fresh symbol row
(the reference's device container, models/encode.py:162-262).  On the card
the step is three launches: K1's overflow-flag fill, K1 and K2; K2 reads
the six arrays in place and applies the staircase, so the container is
never built.

The "weights" of this system are per-session tables: the mega matrix and
its constant, the Huffman and quantisation tables and the LDGM mask.
:func:`state_from_reference` loads them from the reference's arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device, on_device
from ultragrid_tpu_torch.ops.fec import build_ldgm_matrix, make_gf2_parity
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
from ultragrid_tpu_torch.types import Codec, VideoDesc


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """The reference's EncodeConfig without ``work_codec``, which only the
    unported ``compress="none"`` path reads."""

    in_codec: Codec = Codec.UYVY
    compress: str = "none"  # none | dxt1 | dxt5 | jpeg (only jpeg is ported)
    quality: int = 80
    # JPEG chroma subsampling: None = encoder default (4:2:2 for UYVY/YUYV,
    # 4:4:4 for RGB); "420" | "422" | "444" to force
    subsampling: Optional[str] = None
    fec: str = "none"  # none | ldgm:k:m:c (rs:k:n is not ported)
    scale_to: Optional[Tuple[int, int]] = None  # not ported


def _parse_fec(spec: str):
    """Returns ("ldgm", k, m, c) | ("rs", k, n) | None."""
    if spec in ("", "none", None):
        return None
    name, _, rest = spec.partition(":")
    parts = [int(p) for p in rest.split(":") if p] if rest else []
    if name == "ldgm":
        k = parts[0] if len(parts) > 0 else 512
        m = parts[1] if len(parts) > 1 else 384
        c = parts[2] if len(parts) > 2 else 5
        return ("ldgm", k, m, c)
    if name == "rs":
        k = parts[0] if parts else 200
        n = parts[1] if len(parts) > 1 else 240
        return ("rs", k, n)
    raise ValueError(f"unsupported device FEC {spec!r}")


def ldgm_container_params(frame_size: int, k: int) -> Tuple[int, int]:
    """(symbol size ps, padded data size) per ldgm-session.cpp encode_frame."""
    align = k * 4
    data_size = frame_size + 4
    if data_size % align:
        data_size = (data_size // align + 1) * align
    return data_size // k, data_size


def state_from_reference(arrays: dict) -> dict:
    """The port's per-session state from the reference's numpy arrays.

    ``arrays`` holds a reference ``JpegEncoder``'s attributes under their
    names (``_mega`` = (W, const, bytes per MCU row), ``_dc_l``, ``_dc_c``,
    ``_ac_l``, ``_ac_c`` = (codes, lens), ``qtab_luma``, ``qtab_chroma``) and,
    for an LDGM pipeline, ``ldgm_mask`` [m, k] (``build_ldgm_matrix``, the
    reference ``LdgmSession.matrix``); optionally ``rs_bitmat``, a reference
    ``RsSession._bitmat``.  Returns the dict that ``EncodePipeline(...,
    state=)`` and ``JpegEncoder(..., state=)`` take.  The port's sessions
    compute with the reference's matrices when given them:
    ``LdgmSession(k, m, c, matrix=state["ldgm_mask"])``,
    ``RsSession(k, n, bitmat=state["rs_bitmat"])``.
    """
    W, const = arrays["_mega"][0], arrays["_mega"][1]

    def huff(pair):
        codes, lens = pair
        return (np.array(codes, np.uint32), np.array(lens, np.int32))

    state = {
        "W": np.array(W, np.float32), "const": np.array(const, np.float32),
        "dc_luma": huff(arrays["_dc_l"]), "dc_chroma": huff(arrays["_dc_c"]),
        "ac_luma": huff(arrays["_ac_l"]), "ac_chroma": huff(arrays["_ac_c"]),
        "quant_luma": np.array(arrays["qtab_luma"], np.int32),
        "quant_chroma": np.array(arrays["qtab_chroma"], np.int32),
    }
    if W.ndim != 2 or const.shape != (W.shape[1],):
        raise ValueError(f"mega matrix {W.shape} and constant {const.shape} disagree")
    if "ldgm_mask" in arrays:
        state["ldgm_mask"] = np.array(arrays["ldgm_mask"], np.uint8)
    if "rs_bitmat" in arrays:
        state["rs_bitmat"] = np.array(arrays["rs_bitmat"], np.float32)
    return state


class EncodePipeline:
    """The sender step for a fixed video description, on ``device`` (the
    card unless the caller names another; ``get_device`` raises without one).

    ``pipe(frame)`` takes a uint8 [H, linesize] frame, an array (copied to
    ``device``) or a tensor already on ``device`` (any other raises
    ``ValueError``), and returns the reference's outputs: (ys, ybits, us, ubits, vs, vbits,
    overflow) without FEC; (ys, ybits, us, ubits, vs, vbits, parity_bytes
    uint8 [m, ps], overflow) with LDGM.  Slots are int32 holding uint32 bits.
    """

    def __init__(self, desc: VideoDesc, config: EncodeConfig = EncodeConfig(),
                 device="cuda", state: Optional[dict] = None):
        self.desc = desc
        self.config = cfg = config
        if cfg.compress != "jpeg":
            raise NotImplementedError(
                f"compress={cfg.compress!r} is not ported yet (ROADMAP.md: pixel "
                "formats, DXT); only 'jpeg' is")
        if cfg.scale_to is not None:
            raise NotImplementedError("scale_to is not ported yet (ROADMAP.md: postprocess)")
        fec = _parse_fec(cfg.fec)
        if fec is not None and fec[0] != "ldgm":
            raise NotImplementedError(
                f"fec={cfg.fec!r} is not ported yet (ROADMAP.md: device RS and LDGM decode)")
        self.device = get_device(device)

        enc = JpegEncoder(desc.width, desc.height, in_codec=cfg.in_codec,
                          quality=cfg.quality, subsampling=cfg.subsampling, state=state)
        self.jpeg_encoder = enc
        self.state = dict(enc.state)
        self.fec_desc = None
        self.parity = None
        if fec is None:
            return

        _, k, m, c = fec
        ww = enc.wwords
        n_y, n_c = enc.nmcu * enc.ky, enc.nmcu
        self.part_words = [n_y * ww, n_y, n_c * ww, n_c, n_c * ww, n_c]
        # each part starts on a fresh symbol row; grow ps until the per-part
        # padding fits in k rows (reference models/encode.py:178-186)
        ps, _ = ldgm_container_params(sum(self.part_words) * 4, k)
        while sum(-(-(w * 4) // ps) for w in self.part_words) > k:
            ps += 4
        self.row_counts = [-(-(w * 4) // ps) for w in self.part_words]
        self.fec_desc = ("ldgm", k, m, c, ps)
        self.ps, self.psw, self.m = ps, ps // 4, m
        mask = build_ldgm_matrix(k, m, c, 1) if state is None or "ldgm_mask" not in state \
            else np.asarray(state["ldgm_mask"])
        if mask.shape != (m, k):
            raise ValueError(f"LDGM mask {mask.shape} does not match ldgm:{k}:{m}:{c}")
        self.state["ldgm_mask"] = np.array(mask, np.uint8)
        # the padding rows past the six parts are zero, so they add nothing:
        # one parity over the assembled rows equals the full mask's
        self.parity = make_gf2_parity(mask[:, : sum(self.row_counts)], self.psw,
                                      part_words=self.part_words)

    def container(self, parts) -> torch.Tensor:
        """The six int32 arrays -> the [sum(row_counts), psw] int32
        container, each part zero-padded to its own rows (the plain
        version's input; K2 reads the parts in place)."""
        return self.parity.container(parts)

    def __call__(self, frame):
        frame = on_device(frame, self.device)
        ys, ybits, us, ubits, vs, vbits, ovf = self.jpeg_encoder._encode(frame)
        if self.parity is None:
            return ys, ybits, us, ubits, vs, vbits, ovf
        par = self.parity(ys, ybits, us, ubits, vs, vbits)
        # words -> the wire's little-endian byte layout
        par_bytes = par.view(torch.uint8).reshape(self.m, self.ps)
        return ys, ybits, us, ubits, vs, vbits, par_bytes, ovf
