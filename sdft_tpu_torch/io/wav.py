"""WAV I/O matching the reference harness conventions (a copy of
``sdft_tpu.io.wav``, which cannot be imported without jax).

Read: any channel count / 8-16-24-32-bit PCM, normalized to [-1, 1] floats
with the reference's half-step offset convention and mean-mix option
(reference: test/wav.py:6-30, test/wav.h:38-91).  Write: mono PCM at a
configurable bit depth, default 32 like the C driver (test/wav.h:93-122).

Implementation is vectorized NumPy over raw frames (the reference Python
loops per frame; at 350k frames that matters for test latency).
"""

from __future__ import annotations

import struct
import wave

import numpy as np


def _read_float_wav(path: str):
    """Minimal RIFF walker for IEEE-float WAVs (format tag 3, or
    WAVE_FORMAT_EXTENSIBLE wrapping it) — the reference's dr_wav reads
    these (test/wav.h:38-91); Python's ``wave`` rejects format 3 loudly.
    Returns (data float64 (n, C) passthrough — float samples carry no
    half-step quantization convention — samplerate)."""
    with open(path, "rb") as f:
        riff, _, wave_id = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave_id != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = struct.unpack("<4sI", hdr)
            body = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = body
            elif cid == b"data":
                data = body
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    tag, channels, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if tag == 0xFFFE and len(fmt) >= 40:   # extensible: first GUID word
        tag = struct.unpack("<H", fmt[24:26])[0]
    if tag != 3:
        raise ValueError(f"{path}: unsupported WAV format tag {tag}")
    if bits == 32:
        arr = np.frombuffer(data, dtype="<f4")
    elif bits == 64:
        arr = np.frombuffer(data, dtype="<f8")
    else:
        raise ValueError(f"{path}: unsupported float width {bits}")
    n = arr.size // channels
    return arr[:n * channels].astype(np.float64).reshape(n, channels), sr


def read_wav(path: str, mono: bool = True):
    """Read a WAV file — integer PCM at 8/16/24/32 bits via the stdlib
    reader, or IEEE-float (format 3, 32/64-bit) via the RIFF fallback.

    Returns:
      (samples, samplerate) where samples is float64 in [-1, 1], shape (n,)
      when ``mono`` (mean-mix across channels, test/wav.py:28) else (n, C).
    """
    try:
        with wave.open(path, "rb") as f:
            sr = f.getframerate()
            width = f.getsampwidth()
            channels = f.getnchannels()
            raw = f.readframes(f.getnframes())
    except wave.Error:
        data, sr = _read_float_wav(path)
        data = np.clip(data, -1.0, 1.0)
        if mono:
            data = data.mean(axis=-1)
        return data, sr

    if width not in (1, 2, 3, 4):
        raise ValueError(f"unsupported sample width {width}")
    bits = width * 8
    scaler = 2.0 ** (bits - 1) - 1

    frames = np.frombuffer(raw, dtype=np.uint8).reshape(-1, width)
    # The per-byte shift assembly below decodes the on-disk little-endian
    # layout independent of host byte order (np.uint8 views carry no
    # endianness) — no host-dependent flipping.
    acc = np.zeros(len(frames), dtype=np.int64)
    for b in range(width):
        acc |= frames[:, b].astype(np.int64) << (8 * b)
    if bits != 8:  # sign-extend
        signbit = np.int64(1) << (bits - 1)
        acc = (acc ^ signbit) - signbit
    data = acc.astype(np.float64).reshape(-1, channels)

    if bits == 8:
        data -= 128.0
    data = (data + 0.5) / (scaler + 0.5)
    data = np.clip(data, -1.0, 1.0)
    if mono:
        data = data.mean(axis=-1)
    return data, sr


def write_wav(path: str, samples, samplerate: int, bits: int = 32):
    """Write mono PCM (reference: test/wav.py:33-57; C driver uses s32)."""
    data = np.asarray(samples, dtype=np.float64)
    if data.ndim != 1 or data.size == 0:
        raise ValueError(f"expected non-empty 1-D samples, got shape {data.shape}")
    if bits not in (8, 16, 24, 32):
        raise ValueError(f"unsupported bit depth {bits}")
    width = bits // 8
    scaler = 2.0 ** (bits - 1) - 1

    data = np.clip(data, -1.0, 1.0)
    quant = np.round(data * (scaler + 0.5) - 0.5).astype(np.int64)
    # clip in SIGNED range first, then apply the 8-bit unsigned offset —
    # clipping after the +128 offset would clamp the whole positive half
    # of the waveform to byte 127 (~ -0.004 on decode)
    quant = np.clip(quant, -(2 ** (bits - 1)), 2 ** (bits - 1) - 1)
    if bits == 8:
        quant += 128

    frames = np.zeros((quant.size, width), dtype=np.uint8)
    for b in range(width):
        frames[:, b] = (quant >> (8 * b)) & 0xFF

    with wave.open(path, "wb") as f:
        f.setframerate(samplerate)
        f.setsampwidth(width)
        f.setnchannels(1)
        f.writeframes(frames.tobytes())
