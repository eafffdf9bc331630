"""Audio subsystem of the port: frames, codecs, capture/playback, resampling,
filters.

The port's copy of ``ultragrid_tpu/audio/`` (host-side analogue of the
reference's src/audio/).  Audio stays on the host in numpy, as in the
reference: an audio frame is a few kilobytes a channel, next to megabytes of
video.  The codecs PCM, A-law and mu-law are here; the libavcodec codecs
(``ultragrid_tpu/audio/lavc_codecs.py``: Opus, G.722, Speex, MP3, AAC, FLAC)
are not in the port yet, and :func:`~ultragrid_tpu_torch.audio.codecs.get_audio_codec`
refuses them by that module's name.
"""

from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame  # noqa: F401
