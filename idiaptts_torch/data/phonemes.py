"""Phoneme and phoneme-duration label generators: the port's copy of
``idiaptts_tpu/data/phonemes.py`` (numpy and the standard library).

:class:`PhonemeLabelGen` reads phoneme id (or one-hot) sequences from
HTK full, mono, state-aligned or MFA TextGrid labels, with a symbol
dict and an optional EOF symbol.  :class:`PhonemeDurationLabelGen`
reads per-phone 5-state durations from state-aligned HTK labels (50000
units of 100 ns a frame) or per-phone ones from TextGrids, turns
durations into a hard-attention matrix, and generates the ``.dur``
files with their mean/std-dev statistics (``gen_data``).
"""

import glob
import os
import re

import numpy as np

from idiaptts_torch.data.normalisation import MeanStdDevExtractor
from idiaptts_torch.data.reader import LabelGen, NpzDataReader
from idiaptts_torch.data.textgrid import read_textgrid

_HTK_UNITS_PER_FRAME = 50000  # 100 ns units per 5 ms frame


def _read_symbol_from_htk_full(line):
    """Current phoneme from an HTS full-context label line."""
    label = line.split()[-1]
    match = re.search(r"-(.+?)\+", label)
    if match is None:
        raise ValueError("Cannot parse phoneme from: " + label)
    return match.group(1)


class PhonemeLabelGen(NpzDataReader, LabelGen):
    """Phoneme id (or one-hot) sequences from label files."""

    ext_phonemes = ".lab"
    silent_symbol = "sil"  # MFA >=2.0.0a22 leaves silence marks empty

    class Config(NpzDataReader.Config):
        def __init__(self, *args, file_symbol_dict=None,
                     label_type="HTK full", one_hot=False,
                     add_EOF=False, **kwargs):
            kwargs.setdefault("norm_type",
                              NpzDataReader.Config.NormType.NONE)
            super().__init__(*args, **kwargs)
            self.file_symbol_dict = file_symbol_dict
            self.label_type = label_type
            self.one_hot = one_hot
            self.add_EOF = add_EOF

        def create_reader(self):
            return PhonemeLabelGen(self)

    def __init__(self, config):
        super().__init__(config)
        self.label_type = config.label_type
        self.one_hot = config.one_hot
        self.add_EOF = config.add_EOF
        self.symbol_dict = self.get_symbol_dict(config.file_symbol_dict)
        # EOF symbol gets the id after the last real symbol.
        self.eof_id = len(self.symbol_dict)
        self.num_symbols = len(self.symbol_dict) + (1 if self.add_EOF
                                                    else 0)

    @staticmethod
    def get_symbol_dict(file_path):
        with open(file_path) as f:
            symbols = [line.strip() for line in f if line.strip()]
        return {symbol: idx for idx, symbol in enumerate(symbols)}

    def _symbol_to_id(self, symbol):
        return self.symbol_dict[symbol]

    def load(self, id_name):
        id_name = os.path.splitext(os.path.basename(id_name))[0]
        ext = ".TextGrid" if self.label_type == "mfa" \
            else self.ext_phonemes
        path = os.path.join(self.directory[0], id_name + ext)
        if self.label_type == "HTK full":
            symbols = self._load_htk_full(path)
        elif self.label_type == "full_state_align":
            symbols = self._load_htk_state_align(path)
        elif self.label_type == "mono_no_align":
            symbols = self._load_mono(path)
        elif self.label_type == "mfa":
            symbols = self._load_mfa(path)
        else:
            raise NotImplementedError("Unknown label_type "
                                      + self.label_type)
        ids = np.array([self._symbol_to_id(s) for s in symbols],
                       dtype=np.float32)[:, None]
        return ids

    def preprocess_sample(self, features, feature_idx=0):
        sample = np.asarray(features)
        if self.add_EOF:
            sample = np.concatenate(
                [sample, np.full((1, 1), self.eof_id, sample.dtype)])
        if self.one_hot:
            eye = np.eye(self.num_symbols, dtype=np.float32)
            sample = eye[sample[:, 0].astype(np.int64)]
        return sample.astype(np.float32)

    def postprocess_sample(self, features, feature_idx=0):
        if self.one_hot:
            features = np.argmax(features, axis=-1)[:, None]
        if self.add_EOF:
            features = features[:-1]
        return features

    @staticmethod
    def _load_mono(path):
        symbols = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if parts:
                    symbols.append(parts[-1])
        return symbols

    @staticmethod
    def _load_htk_full(path):
        symbols = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    symbols.append(_read_symbol_from_htk_full(line))
        return symbols

    @staticmethod
    def _load_htk_state_align(path):
        symbols = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                label = line.split()[-1]
                if label.endswith("]"):
                    if int(label[-2]) != 2:  # only first state per phone
                        continue
                    label = label[:-3]
                symbols.append(re.search(r"-(.+?)\+", label).group(1))
        return symbols

    @staticmethod
    def _load_mfa(path):
        """Phoneme marks from the MFA TextGrid "phones" tier; empty
        marks become the silent symbol (PhonemeLabelGen.py:288-301
        behaviour, via the bundled TextGrid reader instead of the
        ``textgrid`` package)."""
        tier = read_textgrid(path).get_tier("phones")
        return [iv.mark if iv.mark != ""
                else PhonemeLabelGen.silent_symbol for iv in tier]

    @staticmethod
    def load_sample(id_name, dir_out, file_symbol_dict,
                    label_type="HTK full"):
        config = PhonemeLabelGen.Config(
            name="phonemes", directory=dir_out,
            file_symbol_dict=file_symbol_dict, label_type=label_type)
        return PhonemeLabelGen(config).load(id_name)


class PhonemeDurationLabelGen(NpzDataReader, LabelGen):
    """Per-phone state durations in frames."""

    ext_durations = ".dur"
    dir_durations = "dur"
    num_states = 5
    min_phoneme_length = _HTK_UNITS_PER_FRAME
    frame_length_sec = 0.005

    class Config(NpzDataReader.Config):
        def __init__(self, *args, load_as_matrix=False,
                     label_type="full_state_align", **kwargs):
            kwargs.setdefault("norm_type",
                              NpzDataReader.Config.NormType.MEAN_STDDEV)
            if load_as_matrix:
                kwargs["norm_type"] = NpzDataReader.Config.NormType.NONE
            super().__init__(*args, **kwargs)
            self.load_as_matrix = load_as_matrix
            self.label_type = label_type

        def create_reader(self):
            reader = PhonemeDurationLabelGen(self)
            try:
                reader.get_normalisation_params()
            except (AssertionError, FileNotFoundError):
                pass
            return reader

    def __init__(self, config):
        super().__init__(config)
        self.load_as_matrix = getattr(config, "load_as_matrix", False)
        self.label_type = getattr(config, "label_type",
                                  "full_state_align")

    def load(self, id_name):
        id_name = os.path.splitext(os.path.basename(id_name))[0]
        for directory in self.directory:
            npz_path = os.path.join(directory, id_name + ".npz")
            if os.path.isfile(npz_path):
                archive = np.load(npz_path)
                return archive["dur"].astype(np.float32)
            raw_path = os.path.join(directory,
                                    id_name + self.ext_durations)
            if os.path.isfile(raw_path):
                arr = np.fromfile(raw_path, dtype=np.float32)
                # MFA durations are per-phone, HTK ones per-state.
                width = 1 if self.label_type == "mfa" \
                    else self.num_states
                return arr.reshape(-1, width)
            lab_path = os.path.join(directory, id_name + ".lab")
            if os.path.isfile(lab_path):
                return self._get_full_state_align_dur(
                    lab_path, self.min_phoneme_length, self.num_states)
            tg_path = os.path.join(directory, id_name + ".TextGrid")
            if os.path.isfile(tg_path):
                return self._get_mfa_dur(tg_path, self.frame_length_sec)
        raise FileNotFoundError(id_name)

    def preprocess_sample(self, features, feature_idx=0):
        features = super().preprocess_sample(features, feature_idx)
        if self.load_as_matrix:
            durations = np.asarray(features).sum(axis=1).astype(np.int64)
            return self.durations_to_hard_attention_matrix(durations)
        return features

    @staticmethod
    def durations_to_hard_attention_matrix(durations):
        """(P,) frame counts -> (num_frames, P) selection matrix
        (reference :176-200)."""
        durations = np.asarray(durations, dtype=np.int64)
        num_frames = int(durations.sum())
        ends = np.cumsum(durations)
        starts = ends - durations
        frames = np.arange(num_frames)[:, None]
        A = ((frames >= starts[None, :])
             & (frames < ends[None, :])).astype(np.float32)
        return A

    @staticmethod
    def _get_full_state_align_dur(file_path, min_length, num_states):
        with open(file_path) as f:
            timings = np.array(
                [line.split()[:2] for line in f if line.strip()],
                dtype=np.float64) / min_length
        dur = (timings[:, 1] - timings[:, 0]).astype(np.float32)
        return dur.reshape(-1, num_states)

    @staticmethod
    def _get_mfa_dur(file_path, frame_length_sec):
        """Per-phone durations in frames from an MFA TextGrid
        (PhonemeDurationLabelGen.py:316-325 behaviour, via the bundled
        TextGrid reader)."""
        tier = read_textgrid(file_path).get_tier("phones")
        dur = [(iv.maxTime - iv.minTime) / frame_length_sec
               for iv in tier]
        return np.array(dur, dtype=np.float32)[:, None]

    @staticmethod
    def load_sample(id_name, dir_out, label_type="full_state_align"):
        config = PhonemeDurationLabelGen.Config(name="durations",
                                                directory=dir_out,
                                                label_type=label_type)
        return PhonemeDurationLabelGen(config).load(id_name)

    @staticmethod
    def gen_data(dir_in, dir_out=None, file_id_list="", id_list=None,
                 label_type="full_state_align", return_dict=False):
        """Extract durations for a corpus; accumulate mean/std stats."""
        label_ext = ".TextGrid" if label_type == "mfa" else ".lab"
        if id_list is None:
            id_list = [os.path.splitext(os.path.basename(p))[0]
                       for p in glob.glob(os.path.join(
                           dir_in, "*" + label_ext))]
            file_id_list_name = "all"
        else:
            file_id_list_name = os.path.splitext(
                os.path.basename(str(file_id_list)))[0] or "all"
            id_list = [os.path.basename(i) for i in id_list]
        extractor = MeanStdDevExtractor()
        label_dict = {}
        for file_id in id_list:
            if label_type == "mfa":
                dur = PhonemeDurationLabelGen._get_mfa_dur(
                    os.path.join(dir_in, file_id + label_ext),
                    PhonemeDurationLabelGen.frame_length_sec)
            else:
                dur = PhonemeDurationLabelGen._get_full_state_align_dur(
                    os.path.join(dir_in, file_id + label_ext),
                    PhonemeDurationLabelGen.min_phoneme_length,
                    PhonemeDurationLabelGen.num_states)
            extractor.add_sample(dur)
            if dir_out is not None:
                os.makedirs(dir_out, exist_ok=True)
                dur.astype(np.float32).tofile(
                    os.path.join(dir_out, file_id
                                 + PhonemeDurationLabelGen.ext_durations))
            if return_dict:
                label_dict[file_id] = dur
        if dir_out is not None:
            extractor.save(os.path.join(dir_out, file_id_list_name))
        mean, std = extractor.get_params()
        if return_dict:
            return label_dict, mean, std
        return mean, std


def main(argv=None):
    """CLI: 5-state phone durations of a corpus of labels."""
    import argparse
    parser = argparse.ArgumentParser(
        description="Extract 5-state phone durations.")
    parser.add_argument("-l", "--dir_labels", required=True)
    parser.add_argument("-o", "--dir_out", required=True)
    parser.add_argument("-i", "--file_id_list", default=None)
    args = parser.parse_args(argv)
    id_list = None
    if args.file_id_list:
        with open(args.file_id_list) as f:
            id_list = [line.strip() for line in f if line.strip()]
    PhonemeDurationLabelGen.gen_data(
        args.dir_labels, dir_out=args.dir_out,
        file_id_list=args.file_id_list or "", id_list=id_list)


if __name__ == "__main__":
    main()
