"""Audio subsystem of the port: frames, codecs, capture/playback, resampling,
filters.

The port's copy of ``ultragrid_tpu/audio/`` (host-side analogue of the
reference's src/audio/).  Audio stays on the host in numpy, as in the
reference: an audio frame is a few kilobytes a channel, next to megabytes of
video.  The codecs PCM, A-law and mu-law are here, and the libavcodec codecs
of ``audio/lavc_codecs.py`` (Opus, G.722, Speex, MP3, AAC, FLAC), which
refuse with an error that names libavcodec where it is absent.
"""

from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame  # noqa: F401
