"""Raw waveform targets for neural vocoder training: the port of
``idiaptts_tpu/data/audio_gen.py``.

:class:`RawWaveformLabelGen` loads a wav, resamples it to the model
rate, optionally trims leading and trailing silence, and µ-law
compands it (quantised to [0, mu] by default); ``postprocess_sample``
inverts the companding.  numpy on the host, as the JAX package does.
"""

import os

import numpy as np

from idiaptts_torch.data.reader import DataReader
from idiaptts_torch.ops import audio_io
from idiaptts_torch.ops.mulaw import (inv_mulaw, inv_mulaw_quantize, mulaw,
                                      mulaw_quantize)


class RawWaveformLabelGen(DataReader):

    class Config(DataReader.Config):
        def __init__(self, name="raw_waveform", frame_rate_output_hz=16000,
                     dir_audio=None, mu=255, quantize=True,
                     silence_threshold_db=None, frame_size_ms=5,
                     **kwargs):
            super().__init__(name, **kwargs)
            self.frame_rate_output_hz = frame_rate_output_hz
            self.dir_audio = dir_audio
            self.mu = mu
            self.quantize = quantize
            self.silence_threshold_db = silence_threshold_db
            self.frame_size_ms = frame_size_ms

        def create_reader(self):
            return RawWaveformLabelGen(self)

    def __init__(self, config):
        super().__init__(config)
        self.frame_rate_output_hz = config.frame_rate_output_hz
        self.dir_audio = config.dir_audio
        self.mu = config.mu
        self.quantize = config.quantize
        self.silence_threshold_db = config.silence_threshold_db
        self.frame_size_ms = config.frame_size_ms

    def load(self, id_name):
        id_name = os.path.splitext(os.path.basename(id_name))[0]
        raw, fs = audio_io.get_raw(os.path.join(self.dir_audio,
                                                id_name + ".wav"))
        if fs != self.frame_rate_output_hz:
            raw = audio_io.resample(raw, fs, self.frame_rate_output_hz)
        if self.silence_threshold_db is not None:
            raw, _, _ = audio_io.trim_silence(
                raw, self.frame_rate_output_hz, self.silence_threshold_db)
        return raw[:, None]

    def preprocess_sample(self, features, feature_idx=0):
        raw = np.asarray(features)
        if self.quantize:
            return mulaw_quantize(raw, self.mu).astype(np.float32)
        return mulaw(raw, self.mu).astype(np.float32)

    def postprocess_sample(self, features, feature_idx=0):
        feats = np.asarray(features)
        if self.quantize:
            return np.asarray(inv_mulaw_quantize(feats, self.mu))
        return np.asarray(inv_mulaw(feats, self.mu))

    @staticmethod
    def load_sample(file_path, frame_rate_output_hz=None):
        raw, fs = audio_io.get_raw(file_path)
        if frame_rate_output_hz and fs != frame_rate_output_hz:
            raw = audio_io.resample(raw, fs, frame_rate_output_hz)
        return raw
