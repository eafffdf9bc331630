"""The correctness check of a JPEG + LDGM session, against the plain
reference (``ugbench/reference``), on the frames the run sampled.

Numbers, each the worst over the sampled frames:

* ``coef_off_ppm`` -- coefficients of the file the sender handed its
  socket that are not the float64 reference's rounding of the captured
  frame (more than 0.5 plus the float32 tolerance off; every coefficient
  of a block that does not decode counts), per million coefficients: K1,
  the slots' download and the C assembly.
* ``parity_off`` -- parity bytes of that buffer that differ from the
  reference's LDGM parity of its data part (all of them where the FEC
  header names other parameters than the configuration): the sender's LDGM.
* ``pixel_off_ppm`` -- bytes of the displayed picture more than 0.5 plus
  the float32 tolerance off the reference's inverse DCT of the sent file
  (all of them where the frame was not shown), per million bytes: the
  loss, the peel, the scan decode, the upload and the reverse product.
* ``frames_missing`` -- frames of the window not shown.
"""

from __future__ import annotations

import numpy as np

from ugbench.reference import jpeg as rjpeg
from ugbench.reference import ldgm as rldgm

LDGM_SEED = 1  # the protocol's default seed (the reference's ldgm.hpp:48)


def fec_params(cfg: dict):
    k, m, c = (int(x) for x in cfg["fec"].split(":")[1:4])
    return k, m, c


def quality(cfg: dict) -> int:
    parts = cfg["compress"].split(":")
    return int(parts[1]) if len(parts) > 1 and parts[1] else 80


def _numbers(coef_off, parity_off, pixel_off, ring_frame) -> dict:
    # a 4:2:2 frame has as many coefficients as its UYVY frame has bytes
    return {"coef_off_ppm": 1e6 * coef_off / ring_frame.size, "parity_off": parity_off,
            "pixel_off_ppm": 1e6 * pixel_off / ring_frame.size}


def frame_numbers(buf, hdr20: bytes, ring_frame, picture, cfg: dict) -> dict:
    """The numbers of one sampled frame: ``buf`` the FEC buffer the sender
    handed its socket and ``hdr20`` its FEC header, ``ring_frame`` the
    captured frame, ``picture`` what the receiver showed (or None)."""
    k, m, c = fec_params(cfg)
    ref, tol = rjpeg.forward_coefficients(ring_frame, quality(cfg))
    coef_off, parity_off, pixel_off = ref.size, 0, ring_frame.size
    try:
        jpeg, data, par = rldgm.split_buffer(buf, k, m)
    except ValueError:
        return _numbers(coef_off, int(np.asarray(buf).size), pixel_off, ring_frame)
    words = np.frombuffer(hdr20, ">u4")
    if (words[3] >> 19, (words[3] >> 6) & 0x1FFF, words[3] & 0x3F, words[4]) != (k, m, c, LDGM_SEED):
        parity_off = int(par.size)
    else:
        parity_off = int((rldgm.parity(data, k, m, c, LDGM_SEED).reshape(-1) != par).sum())
    try:
        hdr, co, ok = rjpeg.decode_coefficients(jpeg.tobytes())
    except (rjpeg.JpegError, KeyError, IndexError, StopIteration):
        co = None
    if co is not None and co.shape == ref.shape:
        coef_off = int(((np.abs(co - ref) > 0.5 + tol) | ~ok[:, None]).sum())
        if picture is not None and picture.shape == ring_frame.shape:
            px, ptol = rjpeg.uyvy_pixels(co, hdr)
            pixel_off = int((np.abs(picture.astype(np.float64) - px) > 0.5 + ptol).sum())
    return _numbers(coef_off, parity_off, pixel_off, ring_frame)


def compare(res: dict, cfg: dict) -> dict:
    """The check's numbers for a run (see the module's docstring)."""
    worst = {"coef_off_ppm": 0.0, "parity_off": 0, "pixel_off_ppm": 0.0}
    for key in sorted(res["sampled_keys"]):
        if key not in res["buffers"]:
            continue  # never sent: counted in frames_missing
        buf, hdr20 = res["buffers"][key]
        ring_frame = res["ring_frames"][res["ring_of_key"][key]]
        nums = frame_numbers(buf, hdr20, ring_frame, res["pictures"].get(key), cfg)
        for name, v in nums.items():
            worst[name] = max(worst[name], v)
    worst["frames_missing"] = sum(1 for f in res["window"] if f[4] not in res["shown"])
    return worst
