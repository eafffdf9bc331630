import numpy as np
import torch

from ugbench import content, loss


def test_ring_is_seeded_and_panned():
    a = content.ring(2**31 + 11, 64, 32, n=4, device="cpu")
    b = content.ring(2**31 + 11, 64, 32, n=4, device="cpu")
    c = content.ring(2**31 + 12, 64, 32, n=4, device="cpu")
    assert a.shape == (4, 32, 128) and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)
    # frame i + 1 is frame i's window moved PAN pixels right, PAN / 2 down
    dy, dx = content.PAN // 2, 2 * content.PAN
    assert torch.equal(a[1][: -dy, : -dx], a[0][dy:, dx:])
    y = a[:, :, 1::2].float()
    assert 16 <= y.min() and y.max() <= 235 and y.std() > 10


def test_loss_is_seeded_and_drops_data_packets_only():
    k, m = 8, 2
    data = np.zeros(1000, np.uint8)  # data part: the first 800 bytes
    offsets = np.arange(0, 1000, 100)
    sizes = np.full(10, 100)
    hdrs = np.arange(10)[:, None]

    def drops(seed):
        drop = loss.DataPacketLoss(1, seed, k, m)
        out = []
        for _ in range(20):
            h, o, s = drop(hdrs, data, offsets, sizes)
            assert len(o) == 9 and s.sum() == 900
            out.append(int(np.setdiff1d(offsets, o)[0]))
        return out

    a, b = drops(2**33 + 5), drops(2**33 + 5)
    assert a == b and max(a) < 800 and len(set(a)) > 1
    assert drops(2**33 + 6) != a
    h, o, s = loss.DataPacketLoss(0, 1, k, m)(hdrs, data, offsets, sizes)
    assert len(o) == 10
