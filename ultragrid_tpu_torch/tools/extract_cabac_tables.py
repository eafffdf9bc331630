"""Binary-extraction / drift-check harness for the H.264 CABAC constants.

The port's copy of ``ultragrid_tpu/tools/extract_cabac_tables.py`` (jax-free; copied, not imported, so
the port never runs the JAX package's ``__init__``).

The own decoder's CABAC tables (ISO/IEC 14496-10 Tables 9-12..9-45 and
the Table 9-43 8x8 significance maps) are ISO-published *trained
constants* with no transcribable source in this environment, so they
were recovered from the system codec binaries (libavcodec / libx264
rodata) and are conformance-gated by sample-exact decode of libx264
streams.  This tool re-locates every table in the installed binaries and
diffs it against the repo's checked-in copy, so envelope extensions
(new context banks) never repeat the round-4/round-5 transcription-error
hunt: run it after editing ops/h264_cabac_tables.py or ops/h264_8x8.py.

Round-5 war story it exists to prevent: LAST8_INC (last_significant_
coeff_flag ctxIdxInc, ctxBlockCat 5) was first transcribed with 1s at
scan 16..31 where the published table has 2s; sparse 8x8 blocks decode
identically, so the smooth-content conformance case passed while dense
(qp<=24) blocks desynced mid-slice.  This tool's byte-compare against
BOTH binaries catches that class of error immediately.

Reference role: the constants FFmpeg carries in h264_cabac.c, reached by
the reference through src/video_decompress/libavcodec.c.

Usage: python -m ultragrid_tpu_torch.tools.extract_cabac_tables
Exit status 0 = every repo table byte-identical to the binaries.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

_LIB_DIRS = ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu", "/usr/lib")


def _find_lib(prefix: str) -> Path | None:
    for d in _LIB_DIRS:
        p = Path(d)
        if not p.is_dir():
            continue
        hits = sorted(p.glob(prefix + "*"))
        for h in hits:
            if h.is_file():
                return h
    return None


def _find_all(blob: bytes, needle: bytes) -> list:
    out, i = [], -1
    while True:
        i = blob.find(needle, i + 1)
        if i < 0:
            return out
        out.append(i)


def extract_sig8(blob: bytes) -> np.ndarray | None:
    """significant_coeff_flag ctxIdxInc, ctxBlockCat 5 frame (63 bytes) —
    located by its unique leading run 0,1,2,3,4,5,5,4,..."""
    hits = _find_all(blob, bytes([0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5]))
    if len(hits) != 1:
        return None
    return np.frombuffer(blob[hits[0]:hits[0] + 63], np.uint8).astype(np.int64)


def extract_last8(blob: bytes) -> np.ndarray | None:
    """last_significant_coeff_flag ctxIdxInc, ctxBlockCat 5 frame: the
    only 63-byte monotone non-decreasing 0..8 run with a long 1-plateau
    (it sits adjacent to the sig table in both binaries)."""
    cands = []
    n = len(blob)
    i = 0
    while i < n - 63:
        if blob[i] == 0 and blob[i + 1] == 1:
            w = blob[i:i + 63]
            prev, ok = 0, True
            for b in w:
                if b < prev or b > 8:
                    ok = False
                    break
                prev = b
            if ok and w[-1] >= 4 and w.count(1) > 10 and bytes(w) not in cands:
                cands.append(bytes(w))
        i += 1
    if len(cands) != 1:
        return None
    return np.frombuffer(cands[0], np.uint8).astype(np.int64)


def extract_context_init(blob: bytes) -> np.ndarray | None:
    """The four 1024x2 (m, n) context-init tables, located by the spec's
    Table 9-12 leading entries {20,-15},{2,54},{3,74} shared by all four;
    binary order is [PB idc0, PB idc1, PB idc2, I] distinguished by the
    Table 9-13 P-skip contexts 11..13 ({23,33} leads idc0; zeros = I)."""
    lead = np.array([[20, -15], [2, 54], [3, 74]], np.int8).tobytes()
    hits = _find_all(blob, lead)
    # contexts 3..5 repeat the 0..2 leads in some builds: keep only the
    # first hit of each overlapping cluster
    starts = []
    for h in hits:
        if not starts or h - starts[-1] > 1024:
            starts.append(h)
    tables = []
    for h in starts:
        t = np.frombuffer(blob[h:h + 2048], np.int8)
        if len(t) == 2048:
            tables.append(t.reshape(1024, 2))
    if len(tables) < 4:
        return None
    def key(t):
        v = t[11].tolist()
        return {(23, 33): 1, (22, 25): 2, (29, 16): 3}.get(tuple(v), 0)
    ordered = [None] * 4
    for t in tables[:4]:
        ordered[key(t)] = t
    if any(o is None for o in ordered):
        return None
    return np.stack(ordered)


def extract_range_tab(blob: bytes) -> np.ndarray | None:
    """rangeTabLPS (Table 9-44), 64x4 row-major, by its first two rows.
    FFmpeg repacks this table for SIMD (not byte-searchable); when it is
    not located the repo copy stays anchored by the unit-test spot checks
    (tests/test_h264_cabac.py::test_cabac_tables_anchored) and every
    sample-exact stream decode."""
    lead = bytes([128, 176, 208, 240, 128, 167, 197, 227])
    hits = _find_all(blob, lead)
    if not hits:
        return None
    return np.frombuffer(blob[hits[0]:hits[0] + 256], np.uint8).reshape(64, 4).astype(np.int64)


def extract_deblock_tc0(blob: bytes) -> np.ndarray | None:
    """Table 8-17 tc0 as stored by libx264: 4-byte-padded {bS1,bS2,bS3,0}
    rows over an extended indexA range, located by the saturated tail row
    {13,17,25}.  Returns (3, 52) to match h264_deblock._TC0.  This table
    was once mistranscribed in-repo (bS=1 column started at indexA 21
    instead of 23) — the error is invisible on qp>=26 streams and shows
    only as +/-1 chroma deblock deltas on dense inter frames, so keep it
    binary-pinned."""
    tail = bytes([13, 17, 25, 0])
    for hit in _find_all(blob, tail):
        for nrows in (64, 76, 52):
            start = hit + 4 - nrows * 4
            if start < 0:
                continue
            seg = blob[start:hit + 4]
            rows = [tuple(seg[k * 4:k * 4 + 3]) for k in range(nrows)]
            nzk = [k for k, r in enumerate(rows) if r != (0, 0, 0)]
            if not nzk or nzk[0] < 10:
                continue
            first = nzk[0]
            mono = all(rows[k][j] <= rows[k + 1][j]
                       for k in range(first, nrows - 1) for j in range(3))
            if mono and rows[first - 1] == (0, 0, 0):
                tab = np.array(rows[:52], np.int64)  # indexA 0..51
                return tab.T.copy()  # -> (3, 52): rows bS=1,2,3
    return None


def extract_deblock_alpha_beta(blob: bytes) -> np.ndarray | None:
    """Tables 8-16 alpha+beta, anchored by alpha's unique 36-byte ramp.
    Returns (2, 52): [alpha, beta].  In both binaries beta's ramp
    2,2,2,3,... sits within 512 bytes of alpha's."""
    alpha_ramp = bytes([4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22,
                        25, 28, 32, 36, 40, 45, 50, 56, 63, 71, 80, 90,
                        101, 113, 127, 144, 162, 182, 203, 226, 255, 255])
    beta_ramp = bytes([2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9,
                       9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15,
                       16, 16, 17, 17, 18, 18])
    ah = _find_all(blob, alpha_ramp)
    if not ah:
        return None
    near = [b for b in _find_all(blob, beta_ramp) if abs(b - ah[0]) < 512]
    if not near:
        return None
    alpha = np.concatenate([np.zeros(16, np.int64),
                            np.frombuffer(alpha_ramp, np.uint8).astype(np.int64)])
    beta = np.concatenate([np.zeros(16, np.int64),
                           np.frombuffer(beta_ramp, np.uint8).astype(np.int64)])
    return np.stack([alpha, beta])


def main() -> int:
    from ultragrid_tpu_torch.ops.h264_8x8 import LAST8_INC, SIG8_INC
    from ultragrid_tpu_torch.ops.h264_cabac_tables import CONTEXT_INIT, RANGE_TAB_LPS
    from ultragrid_tpu_torch.ops.h264_deblock import _ALPHA, _BETA, _TC0

    libs = []
    for pref in ("libavcodec.so", "libx264.so"):
        p = _find_lib(pref)
        if p is not None:
            libs.append(p)
    if not libs:
        print("no codec binaries found — nothing to verify against")
        return 1

    checks = [
        ("SIG8_INC", extract_sig8, SIG8_INC),
        ("LAST8_INC", extract_last8, LAST8_INC),
        ("CONTEXT_INIT", extract_context_init, CONTEXT_INIT),
        ("RANGE_TAB_LPS", extract_range_tab, RANGE_TAB_LPS),
        ("DEBLOCK_TC0", extract_deblock_tc0, _TC0),
        ("DEBLOCK_ALPHA_BETA", extract_deblock_alpha_beta,
         np.stack([_ALPHA, _BETA])),
    ]
    fail = 0
    for lib in libs:
        blob = lib.read_bytes()
        for name, fn, repo in checks:
            got = fn(blob)
            if got is None:
                print(f"{lib.name}: {name}: not located (ok if stripped differently)")
                continue
            if got.shape != np.asarray(repo).shape:
                # context init exists only in libavcodec; libx264 carries
                # a transposed encoder layout — report located-but-other
                print(f"{lib.name}: {name}: located, layout differs — skipped")
                continue
            if np.array_equal(got, np.asarray(repo)):
                print(f"{lib.name}: {name}: MATCH")
            else:
                d = int(np.count_nonzero(got != np.asarray(repo)))
                print(f"{lib.name}: {name}: MISMATCH ({d} entries differ)")
                fail += 1
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
