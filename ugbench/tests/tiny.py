"""A tiny session for the CPU tests: a 256x64 frame, an MTU at which a
packet holds about one LDGM symbol (as 1500 does at 1080p), eight frames
a second."""

from ugbench import registry


def config(name: str = "jpeg_ldgm_1080p") -> dict:
    cfg = registry.config(name)
    cfg.update(width=256, height=64, mtu=100)
    return cfg


def traffic(name: str) -> dict:
    tr = registry.traffic(name)
    tr.update(warmup_frames=8, trace_lead_frames=4, grace_s=5.0, sample_frames=3, rate=8)
    return tr
