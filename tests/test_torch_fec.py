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


# ---------------------------------------------------------------------------
# LDGM session: wire layout, host and device peels (the plain version of K2
# without the staircase on the CPU), encode_device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,m,c,size", [(64, 16, 5, 5000), (256, 26, 5, 1), (32, 12, 3, 3001)])
def test_ldgm_encode_buffer_and_desc_match_reference(k, m, c, size):
    frame = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8)
    want_buf, want_desc = ref_fec.LdgmSession(k, m, c, 1).encode(frame)
    got_buf, got_desc = port_fec.LdgmSession(k, m, c, 1).encode(frame)
    assert np.array_equal(got_buf, want_buf)
    assert got_desc == port_fec.FecDesc(*[getattr(want_desc, f) for f in ("type", "k", "m", "c", "seed", "symbol_size")])


def _lossy(buf, ps, nloss, trial):
    sym = buf.reshape(-1, ps)
    r = np.random.default_rng(trial)
    lost = r.choice(sym.shape[0], nloss, replace=False)
    present = np.ones(sym.shape[0], bool)
    present[lost] = False
    garbled = sym.copy()
    garbled[lost] = r.integers(0, 256, (nloss, ps), np.uint8)
    return garbled, present


@pytest.mark.parametrize("trial,nloss", [(0, 5), (1, 12), (2, 16), (3, 30)])
def test_ldgm_decodes_match_reference_device_decode(trial, nloss):
    """The four loss trials of tests/test_fec.py, including the
    unrecoverable ones: the port's host peel and its decode_device on the
    CPU give what the reference's decode_device gives (None included)."""
    k, m, c = 64, 16, 5
    ref, port = ref_fec.LdgmSession(k, m, c, 1), port_fec.LdgmSession(k, m, c, 1)
    frame = np.random.default_rng(3).integers(0, 256, 5000, dtype=np.uint8)
    buf, desc = ref.encode(frame)
    garbled, present = _lossy(buf, desc.symbol_size, nloss, trial)
    want = ref.decode_device(garbled.copy(), present.copy())
    host = port.decode(garbled.copy(), present.copy())
    dev = port.decode_device(garbled.copy(), present.copy(), device="cpu")
    for got in (host, dev):
        if want is None:
            assert got is None
        else:
            assert np.array_equal(got, np.asarray(want)) and np.array_equal(got, frame)
    assert port.rounds >= 1


@pytest.mark.parametrize("ps_pad", [0, 3])
def test_ldgm_peel_staircase_chain_and_unaligned_symbols(ps_pad):
    """A data symbol and a run of parities lost: recovery chains over
    rounds (tests/test_fec.py:212).  With ``ps_pad``, the symbols are
    ``ps + 3`` bytes wide (not whole words): the port pads them with zero
    words, and the reference works on the bytes."""
    k, m, c = 32, 12, 3
    ref, port = ref_fec.LdgmSession(k, m, c, 1), port_fec.LdgmSession(k, m, c, 1)
    frame = np.random.default_rng(7).integers(0, 256, 3000, dtype=np.uint8)
    buf, desc = ref.encode(frame)
    sym = buf.reshape(-1, desc.symbol_size)
    if ps_pad:
        # extra columns: their parity is their own XOR code, so the block
        # stays a codeword column by column
        extra = np.random.default_rng(1).integers(0, 256, (k, ps_pad), np.uint8)
        par = np.asarray(ref.encode_device(jnp.asarray(extra)))
        sym = np.concatenate([sym, np.concatenate([extra, par])], axis=1)
    sym = sym.copy()
    present = np.ones(k + m, bool)
    for idx in (3, k + 2, k + 3, k + 4):
        present[idx] = False
        sym[idx] = 0
    want = ref.decode_device(sym.copy(), present.copy())
    got = port.decode_device(torch.as_tensor(sym), present)
    assert want is not None and np.array_equal(got, np.asarray(want))
    if not ps_pad:
        assert np.array_equal(got, frame)
    assert port.rounds >= 1


@pytest.mark.parametrize("k,m,c,ps", [(64, 16, 5, 80), (256, 26, 5, 36), (32, 12, 3, 37)])
def test_ldgm_encode_device_matches_reference(k, m, c, ps):
    data = np.random.default_rng(ps).integers(0, 256, (k, ps), dtype=np.uint8)
    want = np.asarray(ref_fec.LdgmSession(k, m, c, 1).encode_device(jnp.asarray(data)))
    got = port_fec.LdgmSession(k, m, c, 1).encode_device(torch.as_tensor(data))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_sessions_compute_with_reference_matrices():
    """``state_from_reference`` carries the reference sessions' matrices;
    the port's sessions built from them encode as the reference's do, and
    a different matrix changes the parity."""
    from ultragrid_tpu_torch.models.encode import state_from_reference

    ref_l, ref_r = ref_fec.LdgmSession(48, 12, 4, 1), ref_fec.RsSession(12, 16)
    arrays = {"_mega": (np.zeros((256, 256), np.float32), np.zeros(256, np.float32), 32),
              "_dc_l": ([0], [0]), "_dc_c": ([0], [0]), "_ac_l": ([0], [0]), "_ac_c": ([0], [0]),
              "qtab_luma": np.ones(64), "qtab_chroma": np.ones(64),
              "ldgm_mask": ref_l.matrix, "rs_bitmat": np.asarray(ref_r._bitmat)}
    st = state_from_reference(arrays)
    lsess = port_fec.LdgmSession(48, 12, 4, matrix=st["ldgm_mask"])
    rsess = port_fec.RsSession(12, 16, bitmat=st["rs_bitmat"])
    frame = np.random.default_rng(4).integers(0, 256, 999, dtype=np.uint8)
    assert np.array_equal(lsess.encode(frame)[0], ref_l.encode(frame)[0])
    assert np.array_equal(rsess.encode(frame, device="cpu")[0], ref_r.encode(frame)[0])
    other = port_fec.LdgmSession(48, 12, 4, matrix=port_fec.build_ldgm_matrix(48, 12, 4, 2))
    assert not np.array_equal(other.encode(frame)[0], ref_l.encode(frame)[0])
    with pytest.raises(ValueError, match="does not match"):
        port_fec.LdgmSession(48, 13, 4, matrix=st["ldgm_mask"])


def test_peel_on_cpu_never_launches_k2():
    port = port_fec.LdgmSession(32, 12, 3, 1)
    buf, desc = port.encode(np.arange(900, dtype=np.uint8))
    sym, present = _lossy(buf, desc.symbol_size, 3, 0)
    before = port_fec.LAUNCHES.count
    assert np.array_equal(port.decode_device(sym, present, device="cpu"), np.arange(900, dtype=np.uint8))
    assert port_fec.LAUNCHES.count == before


# ---------------------------------------------------------------------------
# Reed-Solomon and the -f grammar
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,n", [(20, 30), (200, 240)])
def test_rs_matrices_match_reference(k, n):
    assert np.array_equal(port_fec.rs_encode_matrix(k, n), ref_fec.rs_encode_matrix(k, n))
    assert np.array_equal(port_fec._gf2_companion_expand(k, n), ref_fec._gf2_companion_expand(k, n))


@pytest.mark.parametrize("k,n,size,nloss", [(20, 30, 700, 10), (200, 240, 20000, 40), (200, 240, 20000, 41)])
def test_rs_encode_and_erasure_decode_match_reference(k, n, size, nloss):
    """Encode (the bit-plane product, ``gf256_matmul``) and decode with
    ``nloss`` erasures spread over data and parity; one more erasure than
    ``n - k`` gives None on both."""
    payload = np.random.default_rng(size + nloss).integers(0, 256, size, dtype=np.uint8)
    ref, port = ref_fec.RsSession(k, n), port_fec.RsSession(k, n)
    want_buf, want_desc = ref.encode(payload, b"hdr")
    got_buf, got_desc = port.encode(payload, b"hdr", device="cpu")
    assert np.array_equal(got_buf, want_buf) and got_desc.symbol_size == want_desc.symbol_size
    ss = want_desc.symbol_size
    sym = want_buf.reshape(n, ss)
    want_par = np.asarray(ref_fec.gf256_matmul(ref._bitmat, jnp.asarray(sym[:k])))
    assert np.array_equal(port_fec.gf256_matmul(port._bitmat, torch.as_tensor(sym[:k])).numpy(), want_par)
    r = np.random.default_rng(nloss)
    present = np.ones(n, bool)
    present[r.choice(n, nloss, replace=False)] = False
    garbled = sym.copy()
    garbled[~present] = 0
    want = ref.decode(garbled, present)
    got = port.decode(garbled, present)
    if want is None:
        assert got is None and nloss > n - k
    else:
        assert np.array_equal(got, want) and bytes(got[:3]) == b"hdr"


@pytest.mark.parametrize("frame_size,loss,mtu", [(144000, 5.0, 1500), (4147200, 10.0, 1500),
                                                 (4147200, 2.0, 9000), (200000, 0.0, 1500)])
def test_ldgm_suggest_params_matches_reference(frame_size, loss, mtu):
    assert port_fec.ldgm_suggest_params(frame_size, loss, mtu) == ref_fec.ldgm_suggest_params(frame_size, loss, mtu)


@pytest.mark.parametrize("spec", ["none", "", "ldgm", "ldgm:5%", "ldgm:10%", "ldgm:128:64:4", "ldgm:64:16",
                                  "rs", "rs:20:30", "rs:16", "mult:3"])
def test_fec_from_spec_matches_reference(spec):
    want = ref_fec.fec_from_spec(spec, frame_size=177000)
    got = port_fec.fec_from_spec(spec, frame_size=177000)
    if want is None or isinstance(want, tuple):
        assert got == want
    elif isinstance(want, ref_fec.LdgmSession):
        assert isinstance(got, port_fec.LdgmSession)
        assert (got.k, got.m, got.c, got.seed) == (want.k, want.m, want.c, want.seed)
        assert np.array_equal(got.matrix, want.matrix)
    else:
        assert isinstance(got, port_fec.RsSession) and (got.k, got.n) == (want.k, want.n)
    with pytest.raises(ValueError, match="unknown FEC"):
        port_fec.fec_from_spec("xor:3")


# (k, file bytes): with a 24-byte header and the 4-byte length word, data
# parts that need no pad, one pad byte, a whole symbol of pad but one, an
# empty file, and a file shorter than a symbol
@pytest.mark.parametrize("k,n", [(32, 32 * 4 * 3 - 28), (32, 32 * 4 * 3 - 29), (32, 32 * 4 * 2 - 27), (32, 0),
                                 (256, 5), (256, 390_001), (8, 12_345)])
def test_ldgm_buffer_built_on_a_tensor_is_the_host_buffer(k, n):
    sess = port_fec.LdgmSession(k, max(4, k // 8), 3)
    hdr = bytes(range(100, 124))
    frame = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    want, want_desc = sess.encode(np.concatenate([np.frombuffer(hdr, np.uint8), frame]))
    got, desc = sess.encode_tensor(torch.as_tensor(frame), hdr=hdr)
    assert desc == want_desc and got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    ref_buf, _ = ref_fec.LdgmSession(k, max(4, k // 8), 3).encode(
        np.concatenate([np.frombuffer(hdr, np.uint8), frame]))
    assert np.array_equal(got.numpy(), np.asarray(ref_buf))


def test_ldgm_buffer_of_a_frame_view_and_bad_input():
    """A 2-D frame, taken flat, and a strided view: the bytes in order."""
    sess = port_fec.LdgmSession(16, 8, 3)
    frame = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (24, 64), dtype=np.uint8))
    view = frame[:, 8:40]
    for t in (frame, view):
        got, _ = sess.encode_tensor(t)
        assert np.array_equal(got.numpy(), sess.encode(t.contiguous().numpy().reshape(-1))[0])
    with pytest.raises(ValueError, match="uint8"):
        sess.encode_tensor(torch.zeros(10, dtype=torch.int32))


def test_a_parity_at_another_width_is_a_fresh_one_and_shares_its_lists():
    mask = port_fec.build_ldgm_matrix(32, 12, 3)
    base = port_fec.Gf2Parity(mask, 1)
    for psw in (1, 7, 64):
        words = torch.as_tensor(np.random.default_rng(psw).integers(-2 ** 31, 2 ** 31, (32, psw), dtype=np.int32))
        par = base.with_width(psw)
        assert par._csr is base._csr and par.psw == psw and base.psw == 1
        assert torch.equal(par(words), port_fec.Gf2Parity(mask, psw)(words))
    with pytest.raises(ValueError, match="one-part"):
        port_fec.Gf2Parity(mask, 4, part_words=[64, 64]).with_width(8)
