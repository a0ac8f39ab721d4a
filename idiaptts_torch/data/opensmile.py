"""openSMILE feature label generator: the port of
``idiaptts_tpu/data/opensmile.py`` on the port's ``NpzDataReader`` and
``MeanStdDevExtractor``.

Extracts eGeMAPS-style features by running the ``SMILExtract`` binary
(an external tool, not part of this repository), stores one npz per
utterance with the corpus statistics, and serves them as a normalised
reader.  Raises a clear error when the binary is not on PATH.
"""

import csv
import glob
import logging
import os
import shutil
import subprocess
import tempfile

import numpy as np

from idiaptts_torch.data.normalisation import MeanStdDevExtractor
from idiaptts_torch.data.reader import LabelGen, NpzDataReader

logger = logging.getLogger(__name__)


class OpenSMILELabelGen(NpzDataReader, LabelGen):

    class Config(NpzDataReader.Config):
        def __init__(self, *args, config_file=None,
                     smile_binary="SMILExtract", **kwargs):
            kwargs.setdefault("norm_type",
                              NpzDataReader.Config.NormType.MEAN_STDDEV)
            super().__init__(*args, **kwargs)
            self.config_file = config_file
            self.smile_binary = smile_binary

        def create_reader(self):
            reader = OpenSMILELabelGen(self)
            try:
                reader.get_normalisation_params()
            except (AssertionError, FileNotFoundError):
                pass
            return reader

    def __init__(self, config):
        super().__init__(config)
        self.config_file = config.config_file
        self.smile_binary = config.smile_binary

    @staticmethod
    def extract_features(wav_path, config_file,
                         smile_binary="SMILExtract"):
        """One wav -> (T, D) features via the openSMILE subprocess."""
        if shutil.which(smile_binary) is None:
            raise RuntimeError(
                "openSMILE binary '{}' not found on PATH; install "
                "openSMILE or precompute features.".format(
                    smile_binary))
        with tempfile.NamedTemporaryFile(suffix=".csv",
                                         delete=False) as tmp:
            out_csv = tmp.name
        try:
            subprocess.run(
                [smile_binary, "-C", config_file, "-I", wav_path,
                 "-csvoutput", out_csv, "-timestampcsv", "0",
                 "-headercsv", "0"], check=True,
                capture_output=True)
            with open(out_csv) as f:
                rows = [[float(v) for v in row if v]
                        for row in csv.reader(f, delimiter=";") if row]
            return np.asarray(rows, np.float32)
        finally:
            os.unlink(out_csv)

    def gen_data(self, dir_wav, dir_out=None, id_list=None,
                 return_dict=False):
        if id_list is None:
            id_list = [os.path.splitext(os.path.basename(p))[0]
                       for p in glob.glob(os.path.join(dir_wav,
                                                       "*.wav"))]
        extractor = MeanStdDevExtractor()
        label_dict = {}
        for id_name in id_list:
            feats = self.extract_features(
                os.path.join(dir_wav, id_name + ".wav"),
                self.config_file, self.smile_binary)
            extractor.add_sample(feats)
            if dir_out is not None:
                self._save_to_npz(os.path.join(dir_out, id_name),
                                  feats, self.features[0])
            if return_dict:
                label_dict[id_name] = feats
        if dir_out is not None:
            extractor.save(os.path.join(dir_out, ""))
        if return_dict:
            return label_dict, extractor.get_params()
        return extractor.get_params()
