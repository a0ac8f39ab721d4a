"""Host-side audio I/O: the port's copy of what the synthesiser needs from
``idiaptts_tpu/ops/audio_io.py`` (WAV read and write through scipy,
PCM conversion, polyphase resampling).  numpy and scipy only."""

import os

import numpy as np
import scipy.io.wavfile
import scipy.signal


def get_raw(audio_name, preemphasis=0.0):
    """Load a wav file as float32 in [-1, 1], optionally pre-emphasised."""
    fs, raw = scipy.io.wavfile.read(audio_name)
    raw = pcm_to_float(raw)
    if preemphasis and preemphasis != 0.0:
        raw = apply_preemphasis(raw, preemphasis)
    return raw, fs


def pcm_to_float(raw):
    if raw.dtype == np.int16:
        return raw.astype(np.float32) / 32768.0
    if raw.dtype == np.int32:
        return raw.astype(np.float32) / 2147483648.0
    if raw.dtype == np.uint8:
        return (raw.astype(np.float32) - 128.0) / 128.0
    return raw.astype(np.float32)


def float_to_pcm16(raw):
    # NaN to 0 first: np.clip passes NaN through, and NaN -> int16 is
    # undefined.
    raw = np.nan_to_num(np.asarray(raw, dtype=np.float64),
                        nan=0.0, posinf=1.0, neginf=-1.0)
    return (np.clip(raw, -1.0, 1.0) * 32767.0).astype(np.int16)


def raw_to_file(file_path, raw, fs, file_format="wav"):
    """Write a waveform as uncompressed 16-bit WAV; other extensions are
    replaced by ``.wav``.  int16 input is written verbatim."""
    if file_format.lower() not in ("wav", "wave"):
        file_path = os.path.splitext(file_path)[0] + ".wav"
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    raw = np.asarray(raw)
    data = raw if raw.dtype == np.int16 else float_to_pcm16(raw)
    scipy.io.wavfile.write(file_path, int(fs), data)
    return file_path


def apply_preemphasis(raw, coefficient=0.97):
    return np.append(raw[0], raw[1:] - coefficient * raw[:-1]).astype(
        np.float32)


def resample(raw, fs_in, fs_out):
    """Polyphase resampling (librosa.resample replacement)."""
    if fs_in == fs_out:
        return np.asarray(raw, dtype=np.float32)
    g = np.gcd(int(fs_in), int(fs_out))
    up, down = int(fs_out) // g, int(fs_in) // g
    return scipy.signal.resample_poly(raw, up, down).astype(np.float32)
