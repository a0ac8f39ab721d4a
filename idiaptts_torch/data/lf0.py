"""LF0 readers: the port of ``idiaptts_tpu/data/lf0.py``.

:class:`LF0LabelGen` loads lf0 (with deltas when configured) and vuv
from a WORLD feature directory; :class:`FlatLF0LabelGen` subtracts the
phrase curve of ``<dir_phrase>/<id>.phrase`` (the targets of the
flat-intonation stage of phrase-atom training).
"""

import os

import numpy as np

from idiaptts_torch.data.normalisation import MeanStdDevExtractor
from idiaptts_torch.data.reader import LabelGen, NpzDataReader
from idiaptts_torch.data.world_feat import WorldFeatLabelGen


class LF0LabelGen(NpzDataReader, LabelGen):
    """Loads LF0 (+deltas) and VUV from the WORLD feature directory."""

    class Config(NpzDataReader.Config):
        def __init__(self, *args, add_deltas=False, load_vuv=True,
                     **kwargs):
            kwargs.setdefault("norm_type",
                              NpzDataReader.Config.NormType.MEAN_STDDEV)
            super().__init__(*args, **kwargs)
            self.add_deltas = add_deltas
            self.load_vuv = load_vuv

        def create_reader(self):
            reader = LF0LabelGen(self)
            try:
                reader.get_normalisation_params()
            except (AssertionError, FileNotFoundError):
                pass
            return reader

    def __init__(self, config):
        super().__init__(config)
        self.add_deltas = config.add_deltas
        self.load_vuv = config.load_vuv
        self._world = WorldFeatLabelGen(
            dir_labels=self.directory[0], add_deltas=config.add_deltas,
            load_sp=False, load_bap=False, load_vuv=config.load_vuv)

    def load(self, id_name):
        return self._world.load(id_name)

    def get_normalisation_params(self, dir_out=None, file_name=None):
        directory = dir_out or self.directory[0]
        base = os.path.join(directory, WorldFeatLabelGen.dir_lf0,
                            (file_name + "-" if file_name else "")
                            + MeanStdDevExtractor.file_name_appendix)
        for cand in (base + ".npz", base + ".bin"):
            if os.path.isfile(cand):
                mean, std = MeanStdDevExtractor.load(cand)
                if self.load_vuv:
                    mean = np.concatenate([np.atleast_1d(
                        np.squeeze(mean)), [0.0]])
                    std = np.concatenate([np.atleast_1d(
                        np.squeeze(std)), [1.0]])
                self.norm_params = (mean.astype(np.float32),
                                    std.astype(np.float32))
                return self.norm_params
        raise FileNotFoundError(base)


class FlatLF0LabelGen(LF0LabelGen):
    """LF0 with the phrase curve removed."""

    class Config(LF0LabelGen.Config):
        def __init__(self, *args, dir_phrase=None, **kwargs):
            super().__init__(*args, **kwargs)
            self.dir_phrase = dir_phrase

        def create_reader(self):
            reader = FlatLF0LabelGen(self)
            try:
                reader.get_normalisation_params()
            except (AssertionError, FileNotFoundError):
                pass
            return reader

    def __init__(self, config):
        super().__init__(config)
        self.dir_phrase = config.dir_phrase

    def load(self, id_name):
        sample = super().load(id_name)
        phrase_path = os.path.join(
            self.dir_phrase,
            os.path.splitext(os.path.basename(id_name))[0] + ".phrase")
        phrase = np.fromfile(phrase_path, dtype=np.float32)
        n = min(len(sample), len(phrase))
        sample = np.array(sample[:n])
        sample[:, 0] -= phrase[:n]
        return sample
