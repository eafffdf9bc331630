"""The port's LDGM parity (plain version of kernel K2) against the JAX reference.

Inputs are made with numpy from a seed and go through the reference's
``gf2_matmul`` (XLA on the CPU) or its Pallas kernel in interpret mode, and
through ``ultragrid_tpu_torch.ops.fec`` on the CPU.  Integer work: the
tolerance is exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ultragrid_tpu.ops import fec as ref_fec  # noqa: E402
from ultragrid_tpu_torch.ops import fec as port_fec  # noqa: E402


def _bytes_of(words_u32: np.ndarray) -> np.ndarray:
    return np.frombuffer(words_u32.tobytes(), np.uint8).reshape(words_u32.shape[0], -1)


@pytest.mark.parametrize("k,m,c,ps,staircase", [
    (8, 4, 3, 40, False), (8, 4, 3, 40, True), (32, 6, 4, 64, True),
    (32, 16, 5, 100, False), (256, 26, 5, 36, True),
])
def test_gf2_matmul_matches_reference(k, m, c, ps, staircase):
    mask = ref_fec.build_ldgm_matrix(k, m, c, 1).astype(np.float32)
    data = np.random.default_rng(k + m).integers(0, 256, (k, ps), dtype=np.uint8)
    want = np.asarray(ref_fec.gf2_matmul(jnp.asarray(mask), jnp.asarray(data), staircase))
    got = port_fec.gf2_matmul(mask, torch.as_tensor(data), staircase)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


def test_gf2_parity_twin_matches_pallas_interpret_and_xla():
    """The ``psw=700`` case of tests/test_fec.py: a column count that the
    Pallas kernel pads to 4096 words (K2 needs no padding).  K2 applies the
    staircase, which the Pallas kernel leaves to its caller."""
    k, m, c = 32, 6, 4
    psw = 700
    mask = ref_fec.build_ldgm_matrix(k, m, c, 1).astype(np.float32)
    data = np.random.default_rng(3).integers(0, 2**32, (k, psw), dtype=np.uint32)
    pallas = np.asarray(ref_fec.make_gf2_parity_pallas(mask, psw, interpret=True)(jnp.asarray(data)))
    pallas = np.bitwise_xor.accumulate(pallas, axis=0)
    xla = np.asarray(ref_fec.gf2_matmul(jnp.asarray(mask), jnp.asarray(_bytes_of(data)), True))
    par = port_fec.make_gf2_parity(mask, psw)
    got = par(torch.as_tensor(data.view(np.int32)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, psw)
    got_u32 = got.numpy().view(np.uint32)
    assert np.array_equal(got_u32, pallas)
    assert np.array_equal(_bytes_of(got_u32), xla)


def test_staircase_matches_sequential_definition():
    par = torch.as_tensor(np.random.default_rng(1).integers(-2**31, 2**31, (26, 17), dtype=np.int64)).to(torch.int32)
    want = par.clone()
    for r in range(1, want.shape[0]):
        want[r] ^= want[r - 1]
    assert torch.equal(port_fec.apply_staircase(par), want)


def test_parity_with_staircase_matches_c_ldgm_encoder():
    """Parity + staircase equals the shared C host encoder
    (native/ldgm_xor.c), which the reference's wire path uses."""
    from ultragrid_tpu.native import ldgm_xor_lib

    lib = ldgm_xor_lib()
    assert lib is not None
    k, m, c, ps = 64, 12, 3, 96
    mask = port_fec.build_ldgm_matrix(k, m, c, 1)
    data = np.random.default_rng(8).integers(0, 256, (k, ps), dtype=np.uint8)
    row_len = int(mask.sum(axis=1).max())
    idx = np.full((m, row_len), -1, np.int32)
    for r in range(m):
        nz = np.nonzero(mask[r])[0]
        idx[r, : nz.size] = nz
    want = np.zeros((m, ps), np.uint8)
    lib.ldgm_encode_xor(data.ctypes.data, k, ps, idx.ctypes.data, m, row_len, want.ctypes.data)
    words = torch.as_tensor(data.view(np.int32))
    got = port_fec.make_gf2_parity(mask, ps // 4)(words)
    assert np.array_equal(got.numpy().view(np.uint8), want)


@pytest.mark.parametrize("k,m,c,psw,part_words", [
    (32, 16, 5, 40, [400, 25, 100, 25, 100, 25]),
    (64, 12, 3, 33, [660, 41, 330, 41, 330, 41]),
    (256, 26, 5, 21, [2048, 128, 1024, 64, 1024, 64]),
])
def test_fused_parity_plain_matches_reference(k, m, c, psw, part_words):
    """K2's plain version (parts -> container -> parity -> staircase)
    equals the reference's ``gf2_matmul(mask, container_bytes, True)``."""
    rng = np.random.default_rng(k + psw)
    parts = [torch.as_tensor(rng.integers(-2**31, 2**31, w, dtype=np.int64).astype(np.int32))
             for w in part_words]
    rows = sum(-(-w // psw) for w in part_words)
    mask = ref_fec.build_ldgm_matrix(k, m, c, 1)
    par = port_fec.make_gf2_parity(mask[:, :rows], psw, part_words=part_words)
    got = par(*parts)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, psw)
    cont = np.zeros((k, psw), np.int32)
    cont[:rows] = par.container(parts).numpy()
    want = np.asarray(ref_fec.gf2_matmul(jnp.asarray(mask.astype(np.float32)),
                                         jnp.asarray(cont.view(np.uint8)), True))
    assert np.array_equal(got.numpy().view(np.uint8), want)


def test_port_native_ldgm_encoder_matches_reference_loader():
    """The port's own loader builds the same C encoder as the reference's."""
    from ultragrid_tpu.native import ldgm_xor_lib as ref_lib
    from ultragrid_tpu_torch.native import ldgm_xor_lib

    k, m, c, ps = 32, 8, 3, 40
    mask = port_fec.build_ldgm_matrix(k, m, c, 1)
    data = np.random.default_rng(2).integers(0, 256, (k, ps), dtype=np.uint8)
    row_len = int(mask.sum(axis=1).max())
    idx = np.full((m, row_len), -1, np.int32)
    for r in range(m):
        nz = np.nonzero(mask[r])[0]
        idx[r, : nz.size] = nz
    outs = []
    for lib in (ldgm_xor_lib(), ref_lib()):
        out = np.zeros((m, ps), np.uint8)
        lib.ldgm_encode_xor(data.ctypes.data, k, ps, idx.ctypes.data, m, row_len, out.ctypes.data)
        outs.append(out)
    assert outs[0].any() and np.array_equal(outs[0], outs[1])


def test_cpu_tensor_never_launches_k2():
    before = port_fec.LAUNCHES.count
    par = port_fec.make_gf2_parity(port_fec.build_ldgm_matrix(16, 4, 3, 1), 8)
    par(torch.zeros(16, 8, dtype=torch.int32))
    assert port_fec.LAUNCHES.count == before
    with pytest.raises(ValueError, match="int32"):
        par(torch.zeros(16, 8, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        par.launch(torch.zeros(16, 8, dtype=torch.int32))
