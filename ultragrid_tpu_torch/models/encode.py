"""The encode pipeline on tensors: frame -> convert -> compress -> FEC.

Port of ``ultragrid_tpu/models/encode.py``: every ``compress`` (none, dxt1,
dxt5, jpeg), ``fec`` (none, ldgm:k:m:c, rs:k:n) and ``scale_to`` that the
reference accepts, and the batched sender ``BatchedJpegLdgmPipeline``.

* JPEG: the device half (kernel K1 on the card) emits per-block slot words
  and bit counts; the LDGM parity (kernel K2 on the card) protects the
  slot-aligned container of those six arrays while it is still on the
  device, each array starting on a fresh symbol row (the reference's device
  container, models/encode.py:162-262).  On the card the step is three
  launches: K1's overflow-flag fill, K1 and K2; K2 reads the six arrays in
  place and applies the staircase, so the container is never built.
  ``scale_to`` pre-scales the frame (nearest neighbour) before K1.
* Fixed-size payloads (uncompressed after a pixel-format conversion to
  ``work_codec``, or DXT1 / DXT5-YCoCg): the parity protects the host
  wire layout ``[u32 len][payload][zero pad]`` as ``[k, ps]`` symbols (ref:
  ldgm-session.cpp:123-176), LDGM by K2 over one part with the staircase,
  Reed-Solomon by the GF(256) bit-matrix product.
* Batched JPEG + LDGM: B frames stacked row-wise ride one K1 launch and one
  K2 launch (K2's frame axis); each frame's outputs equal the single-frame
  step's.

The "weights" of this system are per-session tables: the mega matrix and
its constant, the Huffman and quantisation tables, the LDGM mask and the RS
bit matrix.  :func:`state_from_reference` loads them from the reference's
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device, on_device
from ultragrid_tpu_torch.ops import dxt, pixfmt
from ultragrid_tpu_torch.ops.fec import _gf2_companion_expand, build_ldgm_matrix, gf256_matmul, make_gf2_parity
from ultragrid_tpu_torch.ops.jpeg import JpegBatchEncoder, JpegEncoder
from ultragrid_tpu_torch.ops.postprocess import scale_nearest
from ultragrid_tpu_torch.types import Codec, VideoDesc, vc_get_linesize


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    in_codec: Codec = Codec.UYVY
    work_codec: Codec = Codec.RGB  # conversion target before compression
    compress: str = "none"  # none | dxt1 | dxt5 | jpeg
    quality: int = 80
    # JPEG chroma subsampling: None = encoder default (4:2:2 for UYVY/YUYV,
    # 4:4:4 for RGB); "420" | "422" | "444" to force
    subsampling: Optional[str] = None
    fec: str = "none"  # none | ldgm:k:m:c | rs:k:n
    # optional device pre-scale (capture -> scale -> JPEG -> LDGM as one
    # step); None = encode at capture resolution
    scale_to: Optional[Tuple[int, int]] = None


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


def container_symbols(payload: torch.Tensor, frame_size: int, k: int, ps: int) -> torch.Tensor:
    """[u32 len][payload][zero pad] -> [k, ps] uint8 symbols (the reference
    LDGM and RS buffer layout, ldgm-session.cpp:123-176; reference
    ``_container_symbols``, models/encode.py:75)."""
    flat = payload.reshape(-1)
    out = torch.zeros(k * ps, dtype=torch.uint8, device=flat.device)
    out[:4] = torch.tensor(list(int(frame_size).to_bytes(4, "little")), dtype=torch.uint8, device=flat.device)
    out[4: 4 + flat.numel()] = flat
    return out.reshape(k, ps)


def jpeg_ldgm_layout(enc: JpegEncoder, k: int):
    """(part words, ps, row counts) of the slot container of one frame:
    each part starts on a fresh symbol row; ps grows until the per-part
    padding fits in k rows (reference models/encode.py:170-186)."""
    ww = enc.wwords
    n_y, n_c = enc.nmcu * enc.ky, enc.nmcu
    part_words = [n_y * ww, n_y, n_c * ww, n_c, n_c * ww, n_c]
    ps, _ = ldgm_container_params(sum(part_words) * 4, k)
    while sum(-(-(w * 4) // ps) for w in part_words) > k:
        ps += 4
    return part_words, ps, [-(-(w * 4) // ps) for w in part_words]


def _ldgm_mask(state: Optional[dict], k: int, m: int, c: int) -> np.ndarray:
    mask = build_ldgm_matrix(k, m, c, 1) if state is None or "ldgm_mask" not in state \
        else np.asarray(state["ldgm_mask"])
    if mask.shape != (m, k):
        raise ValueError(f"LDGM mask {mask.shape} does not match ldgm:{k}:{m}:{c}")
    return np.array(mask, np.uint8)


def state_from_reference(arrays: dict) -> dict:
    """The port's per-session state from the reference's numpy arrays.

    ``arrays`` may hold a reference ``JpegEncoder``'s attributes under their
    names (``_mega`` = (W, const, bytes per MCU row), ``_dc_l``, ``_dc_c``,
    ``_ac_l``, ``_ac_c`` = (codes, lens), ``qtab_luma``, ``qtab_chroma``),
    ``ldgm_mask`` [m, k] (``build_ldgm_matrix``, the reference
    ``LdgmSession.matrix``) and ``rs_bitmat`` (``_gf2_companion_expand``,
    the reference ``RsSession._bitmat``).  Returns the dict that
    ``EncodePipeline(..., state=)``, ``BatchedJpegLdgmPipeline(...,
    state=)`` and ``JpegEncoder(..., state=)`` take: a pipeline computes
    with the reference's matrices when given them, as do
    ``LdgmSession(k, m, c, matrix=state["ldgm_mask"])`` and
    ``RsSession(k, n, bitmat=state["rs_bitmat"])``.
    """
    state = {}
    if "_mega" in arrays:
        W, const = arrays["_mega"][0], arrays["_mega"][1]
        if W.ndim != 2 or const.shape != (W.shape[1],):
            raise ValueError(f"mega matrix {W.shape} and constant {const.shape} disagree")

        def huff(pair):
            codes, lens = pair
            return (np.array(codes, np.uint32), np.array(lens, np.int32))

        state.update({
            "W": np.array(W, np.float32), "const": np.array(const, np.float32),
            "dc_luma": huff(arrays["_dc_l"]), "dc_chroma": huff(arrays["_dc_c"]),
            "ac_luma": huff(arrays["_ac_l"]), "ac_chroma": huff(arrays["_ac_c"]),
            "quant_luma": np.array(arrays["qtab_luma"], np.int32),
            "quant_chroma": np.array(arrays["qtab_chroma"], np.int32),
        })
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
    ``ValueError``), and returns the reference step's outputs:

    * JPEG: (ys, ybits, us, ubits, vs, vbits, overflow) without FEC; (ys,
      ybits, us, ubits, vs, vbits, parity_bytes uint8 [m, ps], overflow)
      with LDGM.  Slots are int32 holding uint32 bits.
    * none / dxt1 / dxt5: the payload (the converted frame [H,
      linesize(work_codec)], or the DXT bytes) without FEC; (payload,
      parity uint8 [m, ps] or [n - k, ps]) with LDGM or RS.
    """

    def __init__(self, desc: VideoDesc, config: EncodeConfig = EncodeConfig(),
                 device="cuda", state: Optional[dict] = None):
        self.desc = desc
        self.config = cfg = config
        self.device = get_device(device)
        self.jpeg_encoder = None
        self.fec_desc = None  # (kind, params..., symbol size) when FEC is on
        self.parity = None
        self.state = {}
        fec = _parse_fec(cfg.fec)
        if cfg.compress == "jpeg":
            self._init_jpeg(fec, state)
        elif cfg.compress in ("none", "dxt1", "dxt5"):
            self._init_fixed(fec, state)
        else:
            raise ValueError(f"unknown compress {cfg.compress!r}")

    # -- JPEG ------------------------------------------------------------

    def _init_jpeg(self, fec, state) -> None:
        desc, cfg = self.desc, self.config
        enc_w, enc_h = cfg.scale_to if cfg.scale_to is not None else (desc.width, desc.height)
        enc = JpegEncoder(enc_w, enc_h, in_codec=cfg.in_codec, quality=cfg.quality,
                          subsampling=cfg.subsampling, state=state)
        self.jpeg_encoder = enc
        self.state = dict(enc.state)
        if fec is None:
            return
        if fec[0] != "ldgm":
            raise ValueError("device-fused JPEG FEC supports ldgm only")
        _, k, m, c = fec
        self.part_words, ps, self.row_counts = jpeg_ldgm_layout(enc, k)
        self.fec_desc = ("ldgm", k, m, c, ps)
        self.ps, self.psw, self.m = ps, ps // 4, m
        mask = self.state["ldgm_mask"] = _ldgm_mask(state, k, m, c)
        # the padding rows past the six parts are zero, so they add nothing:
        # one parity over the assembled rows equals the full mask's
        self.parity = make_gf2_parity(mask[:, : sum(self.row_counts)], self.psw,
                                      part_words=self.part_words)

    def container(self, parts) -> torch.Tensor:
        """The six int32 arrays -> the [sum(row_counts), psw] int32
        container, each part zero-padded to its own rows (the plain
        version's input; K2 reads the parts in place)."""
        return self.parity.container(parts)

    def prescale(self, frame: torch.Tensor) -> torch.Tensor:
        """The ``scale_to`` pre-scale (identity without one)."""
        cfg = self.config
        if cfg.scale_to is None:
            return frame
        return scale_nearest(frame, self.desc.width, cfg.in_codec, *cfg.scale_to)

    def _jpeg_step(self, frame: torch.Tensor):
        ys, ybits, us, ubits, vs, vbits, ovf = self.jpeg_encoder._encode(self.prescale(frame))
        if self.parity is None:
            return ys, ybits, us, ubits, vs, vbits, ovf
        par = self.parity(ys, ybits, us, ubits, vs, vbits)
        # words -> the wire's little-endian byte layout
        par_bytes = par.view(torch.uint8).reshape(self.m, self.ps)
        return ys, ybits, us, ubits, vs, vbits, par_bytes, ovf

    # -- fixed-size payloads (none / dxt1 / dxt5) --------------------------

    def _init_fixed(self, fec, state) -> None:
        desc, cfg = self.desc, self.config
        if cfg.compress == "dxt1":
            self.out_bytes = desc.width * desc.height // 2
        elif cfg.compress == "dxt5":
            self.out_bytes = desc.width * desc.height
        else:
            self.out_bytes = desc.height * vc_get_linesize(desc.width, cfg.work_codec)
        if fec is None:
            return
        if fec[0] == "ldgm":
            _, k, m, c = fec
            ps, _ = ldgm_container_params(self.out_bytes, k)
            self.fec_desc = ("ldgm", k, m, c, ps)
            self.ps, self.psw, self.m = ps, ps // 4, m
            mask = self.state["ldgm_mask"] = _ldgm_mask(state, k, m, c)
            # one part, the whole [k, psw] container, staircase on
            self.parity = make_gf2_parity(mask, self.psw)
        else:
            _, k, n = fec
            ps = -(-(self.out_bytes + 4) // k)
            self.fec_desc = ("rs", k, n, (ps + 1) & ~1)
            bitmat = _gf2_companion_expand(k, n) if state is None or "rs_bitmat" not in state \
                else np.asarray(state["rs_bitmat"], np.float32)
            if bitmat.shape != ((n - k) * 8, k * 8):
                raise ValueError(f"RS bit matrix {bitmat.shape} does not match rs:{k}:{n}")
            self.state["rs_bitmat"] = np.array(bitmat, np.float32)
            self._rs_bitmat = torch.as_tensor(self.state["rs_bitmat"], device=self.device)

    def payload(self, frame: torch.Tensor) -> torch.Tensor:
        """Conversion to ``work_codec`` (compress none) or DXT (reference
        models/encode.py:264-279)."""
        desc, cfg = self.desc, self.config
        width = desc.width
        if cfg.compress == "none":
            if cfg.work_codec != cfg.in_codec:
                return pixfmt.convert_frame(frame, width, cfg.in_codec, cfg.work_codec)
            return frame
        if cfg.compress == "dxt1":
            if cfg.in_codec == Codec.UYVY:
                return dxt.dxt1_encode_uyvy(frame, width)
            return dxt.dxt1_encode_rgb(frame, width)
        return dxt.dxt5_ycocg_encode_rgb(frame, width)

    def _fixed_step(self, frame: torch.Tensor):
        data = self.payload(frame)
        if self.fec_desc is None:
            return data
        sym = container_symbols(data, self.out_bytes, self.fec_desc[1], self.fec_desc[-1])
        if self.fec_desc[0] == "ldgm":
            par = self.parity(sym.view(torch.int32)).view(torch.uint8).reshape(self.m, self.ps)
        else:
            par = gf256_matmul(self._rs_bitmat, sym)
        return data, par

    def __call__(self, frame):
        frame = on_device(frame, self.device)
        if self.jpeg_encoder is not None:
            return self._jpeg_step(frame)
        return self._fixed_step(frame)


class BatchedJpegLdgmPipeline:
    """Throughput variant of the JPEG + LDGM sender step (reference
    models/encode.py:319-430): B frames stacked row-wise ride one K1 launch
    (frame boundaries are restart boundaries, so each frame's output is
    bit-identical to the single-frame pipeline's) and one K2 launch, whose
    frame axis gives each frame its own parity.  The latency-critical
    sender keeps the single-frame :class:`EncodePipeline`.

    ``pipe(stacked)`` takes uint8 [B*H, linesize] or [B, H, linesize] (an
    array is copied to ``device``, a tensor must be on it) and returns (ys,
    ybits, us, ubits, vs, vbits, parity uint8 [B, m, ps], overflow).
    """

    def __init__(self, desc: VideoDesc, nframes: int, quality: int = 80, fec: str = "ldgm:256:26:5",
                 subsampling: Optional[str] = None, device="cuda", state: Optional[dict] = None):
        parsed = _parse_fec(fec)
        if parsed is None or parsed[0] != "ldgm":
            raise ValueError(f"the batched pipeline takes ldgm:k:m:c, not {fec!r}")
        _, k, m, c = parsed
        self.device = get_device(device)
        self.nframes = nframes
        self.enc = JpegBatchEncoder(desc.width, desc.height, nframes, in_codec=desc.color_spec,
                                    quality=quality, subsampling=subsampling, state=state)
        self.part_words, ps, self.row_counts = jpeg_ldgm_layout(self.enc.single, k)
        self.ps, self.k, self.m, self.c = ps, k, m, c
        self.state = dict(self.enc.single.state)
        mask = self.state["ldgm_mask"] = _ldgm_mask(state, k, m, c)
        self.parity = make_gf2_parity(mask[:, : sum(self.row_counts)], ps // 4,
                                      part_words=self.part_words, frames=nframes)

    def __call__(self, stacked_frames):
        f = on_device(stacked_frames, self.device)
        if f.dim() == 3:
            f = f.reshape(self.enc.tall.height, f.shape[-1])
        ys, ybits, us, ubits, vs, vbits, ovf = self.enc.tall._encode(f)
        par = self.parity(ys, ybits, us, ubits, vs, vbits)
        par_bytes = par.view(torch.uint8).reshape(self.nframes, self.m, self.ps)
        return ys, ybits, us, ubits, vs, vbits, par_bytes, ovf
