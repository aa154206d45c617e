"""Faults planted in the program under the benchmark's timed path, for
the tests that see `correct` come out false. plant(name) patches the
port's entry points in this process; "" plants nothing.

- decode_stale: feed_annexb returns the previous picture again (a step
  that returns its state unchanged);
- decode_altered: one sample of every returned picture is changed (an
  answer altered where it is produced);
- encode_stale: encode_stream returns each frame's bytes in the place of
  the next frame's (a step that returns its state unchanged);
- encode_altered: one byte in the middle of every frame's bytes is
  changed (a token altered where it is produced);
- api_stale, api_altered: the same two faults in the API's EncodeFrame.
Half of a batch and the exchange between chips do not arise: the
decode mix feeds one access unit per call, the encode mix one frame at
a time, and every cell runs on one card.
"""

from __future__ import annotations


def _decode_stale():
    from openh264_tpu_torch.decoder import decoder as d
    orig = d.H264Decoder.feed_annexb

    def feed(self, data):
        out = []
        for f in orig(self, data):
            out.append(getattr(self, "_prev_out", f))
            self._prev_out = f
        return out
    d.H264Decoder.feed_annexb = feed


def _decode_altered():
    from openh264_tpu_torch.decoder import decoder as d
    orig = d.H264Decoder.feed_annexb

    def feed(self, data):
        out = orig(self, data)
        for f in out:
            f.y = f.y.copy()
            f.y[0, 0] ^= 1
        return out
    d.H264Decoder.feed_annexb = feed


def _encode_stale():
    from openh264_tpu_torch.encoder import session_device as sd
    orig = sd.DeviceSessionEncoder.encode_stream

    def encode_stream(self, frames):
        out = orig(self, frames)
        res = []
        for b in out:
            res.append(getattr(self, "_prev_out", b))
            self._prev_out = b
        return res
    sd.DeviceSessionEncoder.encode_stream = encode_stream


def _encode_altered():
    from openh264_tpu_torch.encoder import session_device as sd
    orig = sd.DeviceSessionEncoder.encode_stream

    sd.DeviceSessionEncoder.encode_stream = \
        lambda self, frames: [_alter(b) for b in orig(self, frames)]


def _alter(b: bytes) -> bytes:
    if not b:
        return b
    k = len(b) // 2
    return b[:k] + bytes([b[k] ^ 0x24]) + b[k + 1:]


def _api_stale():
    from openh264_tpu_torch.api import encoder_api as ea
    orig = ea.CWelsH264SVCEncoder.EncodeFrame

    def encode_frame(self, y, u, v):
        b = orig(self, y, u, v)
        out = getattr(self, "_prev_out", b)
        self._prev_out = b
        return out
    ea.CWelsH264SVCEncoder.EncodeFrame = encode_frame


def _api_altered():
    from openh264_tpu_torch.api import encoder_api as ea
    orig = ea.CWelsH264SVCEncoder.EncodeFrame
    ea.CWelsH264SVCEncoder.EncodeFrame = \
        lambda self, y, u, v: _alter(orig(self, y, u, v))


FAULTS = {"decode_stale": _decode_stale, "decode_altered": _decode_altered,
          "encode_stale": _encode_stale, "encode_altered": _encode_altered,
          "api_stale": _api_stale, "api_altered": _api_altered}


def plant(name: str) -> None:
    if name:
        FAULTS[name]()
