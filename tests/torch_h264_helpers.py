"""Content and the memoising fixture shared by the port's H.264 tests
(``tests/test_torch_h264*.py``); a test module takes the fixture by
importing it.

The reference makes a new ``jax.jit`` for every encoder, and each costs
15-20 s to trace and compile on the CPU; ``shared_reference_graphs``
memoises ``make_device_encode`` and ``make_device_encode_p`` so that every
graph is made once per module.  The graphs are pure functions of their
arguments, so the reference's outputs are the same.
"""

import functools

import numpy as np
import pytest

from ultragrid_tpu.ops import h264_tpu


@pytest.fixture(scope="module", autouse=True)
def shared_reference_graphs():
    mp = pytest.MonkeyPatch()
    for name in ("make_device_encode", "make_device_encode_p"):
        mp.setattr(h264_tpu, name, functools.lru_cache(maxsize=None)(getattr(h264_tpu, name)))
    yield
    mp.undo()


def picture(w, h, seed, noise=6.0):
    """A UYVY frame: smooth waves plus sensor-like noise, limited range."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:2 * w].astype(np.float32)
    a, b = rng.uniform(0.5, 2.0, 2)
    base = 128 + 60 * np.sin(xx * 0.05 * a + yy * 0.07 * b) + rng.normal(0, noise, (h, 2 * w))
    return base.clip(16, 235).astype(np.uint8)


def moving(n, w, h, step=3, seed=0, noise=6.0):
    """n UYVY frames of one ``picture`` panned by ``step`` luma samples right
    and ``step // 2`` down a frame."""
    big = picture(w + step * n, h + step * n // 2, seed, noise)
    return [np.ascontiguousarray(big[i * (step // 2):i * (step // 2) + h, 2 * step * i:2 * step * i + 2 * w])
            for i in range(n)]
