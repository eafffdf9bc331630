"""Transport of the port: RTP/RTCP over UDP, packetisation, playout buffer,
reassembly and FEC jobs.

Copies of the jax-free ``ultragrid_tpu/net/`` modules (video, audio, RTSP
the RFC 2435/6184 standards payloads and NAT traversal),
wire-compatible with the reference so the two interoperate on one network.
Device work enters only through the port's ops (the LDGM peel on the card,
``--param ldgm-device=device``).
"""
