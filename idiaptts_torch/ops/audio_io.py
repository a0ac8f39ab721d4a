"""Host-side audio I/O: the port's copy of ``idiaptts_tpu/ops/audio_io.py``
(WAV read and write through scipy, PCM conversion, pre-emphasis and its
inverse, polyphase resampling, RMS loudness normalisation, the FIR
high-pass, energy-based silence trimming).  numpy and scipy only."""

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


def depreemphasis(raw, coefficient=0.97):
    return scipy.signal.lfilter([1.0], [1.0, -coefficient],
                                raw).astype(np.float32)


def resample(raw, fs_in, fs_out):
    """Polyphase resampling (librosa.resample replacement)."""
    if fs_in == fs_out:
        return np.asarray(raw, dtype=np.float32)
    g = np.gcd(int(fs_in), int(fs_out))
    up, down = int(fs_out) // g, int(fs_in) // g
    return scipy.signal.resample_poly(raw, up, down).astype(np.float32)


def rms_normalise(raw, target_dbfs=-20.0):
    """Scale to an RMS of ``target_dbfs`` dB full scale."""
    rms = np.sqrt(np.mean(np.square(raw)) + 1e-12)
    target = 10.0 ** (target_dbfs / 20.0)
    return (raw * (target / rms)).astype(np.float32)


def highpass_filter(raw, fs, cutoff=70.0, order=1001):
    """Linear-phase FIR high-pass (an odd number of taps), applied
    forward and backward."""
    order = int(order) | 1
    taps = scipy.signal.firwin(order, cutoff, fs=fs, pass_zero=False)
    return scipy.signal.filtfilt(taps, [1.0], raw).astype(np.float32)


def trim_silence(raw, fs, silence_threshold_db=-50.0, chunk_ms=10,
                 keep_ms=0):
    """Energy-based leading and trailing silence removal over chunks of
    ``chunk_ms``; returns (trimmed, start, end)."""
    chunk = max(1, int(fs * chunk_ms / 1000))
    n_chunks = len(raw) // chunk
    if n_chunks == 0:
        return raw, 0, len(raw)
    frames = raw[:n_chunks * chunk].reshape(n_chunks, chunk)
    db = 10.0 * np.log10(np.mean(np.square(frames), axis=1) + 1e-12)
    loud = np.where(db > silence_threshold_db)[0]
    if len(loud) == 0:
        return raw[:0], 0, 0
    keep = int(fs * keep_ms / 1000)
    start = max(0, loud[0] * chunk - keep)
    end = min(len(raw), (loud[-1] + 1) * chunk + keep)
    return raw[start:end], start, end
