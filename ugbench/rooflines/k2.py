"""Kernel K2 (``csrc/gf2_parity.cu``): the least time of one launch, bound
by bytes (an XOR is no floating-point work).  The container of ``rows``
symbols of ``psw`` 32-bit words read once, ``out_rows`` parity symbols
written once, and the mask lists (``nnz`` column indices and ``out_rows``
+ 1 row offsets, 32-bit) read once."""

from ugbench import peaks


def min_seconds(rows: int, out_rows: int, nnz: int, psw: int) -> float:
    return 4 * (rows * psw + out_rows * psw + nnz + out_rows + 1) / peaks.HBM_BYTES


def peel_launch(ps: int, k: int, m: int, left_nnz: int) -> float:
    """One round of the receiver's peel: K2 over the full check matrix
    (the left matrix, the parity diagonal and the staircase below it) of
    k + m symbols of ``ps`` bytes, staircase off."""
    return min_seconds(k + m, m, left_nnz + m + (m - 1), -(-ps // 4))
