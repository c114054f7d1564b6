"""MPEG audio and ADTS AAC frame headers, for the format sniffers of io/wav.py.

Copies of hpfw_tpu/io/mp3.py's bitrate and sample-rate tables, FrameHeader,
_find_sync, _free_format_size and _skip_id3, and of hpfw_tpu/io/aac.py's
ADTS_RATES, _AdtsHeader and _find_adts: the header parsing that tells an
MPEG or ADTS stream from other bytes. The decoders themselves are the
native library's. tests/test_torch_config.py pins each copy to its original.
"""

from __future__ import annotations

BITRATES = {
    1: (0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416, 448),
    2: (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384),
    3: (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320),
}
# MPEG-2 LSF (and 2.5): Layer I has its own table; Layers II/III share one.
BITRATES_LSF = {
    1: (0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224, 256),
    2: (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160),
    3: (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160),
}
SAMPLE_RATES = (44100, 48000, 32000)
SAMPLE_RATES_V2 = (22050, 24000, 16000)
SAMPLE_RATES_V25 = (11025, 12000, 8000)

ADTS_RATES = (96000, 88200, 64000, 48000, 44100, 32000,
              24000, 22050, 16000, 12000, 11025, 8000)


class FrameHeader:
    __slots__ = ("layer", "bitrate_kbps", "bitrate_idx", "sample_rate",
                 "sr_idx", "padding", "mode", "mode_ext", "protection",
                 "frame_bytes", "channels", "lsf", "mpeg25")

    def __init__(self, word: int):
        if (word >> 21) & 0x7FF != 0x7FF:
            raise ValueError("bad sync")
        version = (word >> 19) & 3
        if version == 1:
            raise ValueError("reserved MPEG version")
        # 3 = MPEG-1, 2 = MPEG-2 LSF, 0 = MPEG-2.5 (quarter rates)
        self.lsf = version != 3
        self.mpeg25 = version == 0
        layer_bits = (word >> 17) & 3
        if layer_bits == 0:
            raise ValueError("reserved layer")
        self.layer = {3: 1, 2: 2, 1: 3}[layer_bits]
        self.protection = (word >> 16) & 1
        br_idx = (word >> 12) & 0xF
        if br_idx == 15:
            raise ValueError("forbidden bitrate index")
        self.bitrate_idx = br_idx
        # br_idx 0 = free format: the frame size is measured from the
        # next sync at stream level (decode_mp3) and set on this header.
        self.bitrate_kbps = (BITRATES_LSF if self.lsf
                             else BITRATES)[self.layer][br_idx]
        self.sr_idx = (word >> 10) & 3
        if self.sr_idx == 3:
            raise ValueError("reserved sample rate")
        self.sample_rate = (SAMPLE_RATES_V25 if self.mpeg25
                            else SAMPLE_RATES_V2 if self.lsf
                            else SAMPLE_RATES)[self.sr_idx]
        self.padding = (word >> 9) & 1
        self.mode = (word >> 6) & 3
        self.mode_ext = (word >> 4) & 3
        self.channels = 1 if self.mode == 3 else 2
        br = self.bitrate_kbps * 1000
        if br == 0:
            self.frame_bytes = 0  # free format: filled by the stream loop
        elif self.layer == 1:
            self.frame_bytes = (12 * br // self.sample_rate + self.padding) * 4
        elif self.layer == 3 and self.lsf:
            # LSF Layer III frames carry one granule (576 samples)
            self.frame_bytes = 72 * br // self.sample_rate + self.padding
        else:
            self.frame_bytes = 144 * br // self.sample_rate + self.padding


def _find_sync(data: bytes, start: int) -> int:
    i = start
    n = len(data)
    while i + 4 <= n:
        if data[i] == 0xFF and (data[i + 1] & 0xE0) == 0xE0:
            try:
                FrameHeader(int.from_bytes(data[i:i + 4], "big"))
                return i
            except ValueError:
                pass
        i += 1
    return -1


def _free_format_size(data: bytes, pos: int, h: "FrameHeader") -> int:
    """Free-format (bitrate index 0) base frame size: the distance to the
    next sync with a matching header, minus the first frame's padding
    slot. Free-format frames are constant-size by spec (padding aside);
    the scan is capped at the format's largest plausible frame."""
    unit = 4 if h.layer == 1 else 1
    limit = min(len(data) - 4, pos + 5000)
    i = pos + 16
    while i <= limit:
        if data[i] == 0xFF and (data[i + 1] & 0xE0) == 0xE0:
            try:
                h2 = FrameHeader(int.from_bytes(data[i:i + 4], "big"))
            except ValueError:
                i += 1
                continue
            if (h2.layer == h.layer and h2.sample_rate == h.sample_rate
                    and h2.channels == h.channels and h2.bitrate_idx == 0):
                return (i - pos) - h.padding * unit
        i += 1
    return -1


def _skip_id3(data: bytes) -> int:
    if data[:3] == b"ID3" and len(data) >= 10:
        size = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) \
            | ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
        return 10 + size
    return 0


class _AdtsHeader:
    __slots__ = ("sample_rate", "channels", "frame_length", "crc",
                 "header_len", "profile")

    def check_supported(self):
        if self.profile != 1:
            raise ValueError(f"AAC profile/object {self.profile + 1} "
                             "unsupported (LC only)")

    def __init__(self, data, pos):
        if pos + 7 > len(data) or data[pos] != 0xFF \
                or (data[pos + 1] & 0xF6) != 0xF0:
            raise ValueError("bad ADTS sync")
        protection_absent = data[pos + 1] & 1
        self.profile = data[pos + 2] >> 6
        sr_idx = (data[pos + 2] >> 2) & 0xF
        if sr_idx >= len(ADTS_RATES):
            raise ValueError(f"bad ADTS sample-rate index {sr_idx}")
        self.sample_rate = ADTS_RATES[sr_idx]
        self.channels = ((data[pos + 2] & 1) << 2) | (data[pos + 3] >> 6)
        self.frame_length = ((data[pos + 3] & 3) << 11) \
            | (data[pos + 4] << 3) | (data[pos + 5] >> 5)
        if self.frame_length < 7:
            raise ValueError("bad ADTS frame length")
        nblocks = data[pos + 6] & 3
        if nblocks:
            raise ValueError("multi-raw-data-block ADTS frames unsupported")
        self.crc = not protection_absent
        self.header_len = 7 + (2 if self.crc else 0)


def _find_adts(data, pos, chain=2):
    """Next offset with a verified ADTS header whose frame lengths chain
    onto `chain` further verified headers (or the end of the stream) —
    spurious sync pairs inside other codecs' payloads don't chain."""
    n = len(data)
    while pos + 7 <= n:
        if data[pos] == 0xFF and (data[pos + 1] & 0xF6) == 0xF0:
            try:
                h = _AdtsHeader(data, pos)
            except ValueError:
                pos += 1
                continue
            nxt = pos + h.frame_length
            ok = True
            for _ in range(chain):
                if nxt == n:
                    break                      # clean end-of-stream
                try:
                    h2 = _AdtsHeader(data, nxt)
                except ValueError:
                    ok = False
                    break
                nxt += h2.frame_length
            if ok and nxt <= n:
                return pos
        pos += 1
    return -1
