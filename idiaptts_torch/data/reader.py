"""Data reader layer: config-driven feature readers.  The port's copy of
``idiaptts_tpu/data/reader.py``: ``DataReader`` (named outputs, chunk
padding, length matching), ``NpzDataReader`` (npz or raw float32 files
over several directories, index subsets, normalisation, pre/post
processing) and ``LabelGen`` (atomic npz save).  Readers produce numpy;
the model handler moves batches to the device.
"""

import os
from enum import Enum

import numpy as np

from idiaptts_torch.data.normalisation import (
    MeanCovarianceExtractor, MeanStdDevExtractor, MinMaxExtractor)


def _to_tuple(value):
    if value is None:
        return None
    if isinstance(value, (tuple, list)):
        return tuple(value)
    return (value,)


class DataReader:
    """Base reader: named outputs, chunk padding, length matching."""

    class Config:
        def __init__(self, name, chunk_size=1, match_length=None,
                     output_names=None, random_select=True, max_frames=None,
                     min_frames=None, pad_mode="constant",
                     other_pad_dims=None, requires_seq_mask=False):
            self.name = name
            self.chunk_size = chunk_size
            self.match_length = _to_tuple(match_length)
            self.output_names = (_to_tuple(output_names)
                                 if output_names is not None else (name,))
            self.random_select = random_select
            self.max_frames = max_frames
            self.min_frames = min_frames
            self.pad_mode = pad_mode
            self.other_pad_dims = other_pad_dims
            self.requires_seq_mask = requires_seq_mask

        def create_reader(self):
            raise NotImplementedError

    def __init__(self, config):
        self.name = config.name
        self.chunk_size = config.chunk_size
        self.match_length = config.match_length
        self.output_names = config.output_names
        self.random_select = config.random_select
        self.max_frames = config.max_frames
        self.min_frames = config.min_frames
        self.pad_mode = config.pad_mode
        self.other_pad_dims = config.other_pad_dims
        self.requires_seq_mask = config.requires_seq_mask
        self._length_cache = {}

    # -- protocol --------------------------------------------------------
    def load(self, id_name):
        raise NotImplementedError(
            "{} does not implement load().".format(type(self).__name__))

    def preprocess_sample(self, features, feature_idx=0):
        return features

    def postprocess_sample(self, features, feature_idx=0):
        return features

    def __getitem__(self, id_name):
        item = self.preprocess_sample(self.load(id_name))
        if not isinstance(item, (tuple, list)):
            item = (item,)
        if len(item) != len(self.output_names):
            raise RuntimeError(
                "Reader {} returned {} items for {} output names.".format(
                    self.name, len(item), len(self.output_names)))
        if self.chunk_size > 1:
            item = [self.pad(i, self._chunk_padding(i)) for i in item]
        if self.min_frames is not None:
            item = [self.pad(i, [(0, max(0, self.min_frames - len(i)))]
                             + [(0, 0)] * (np.ndim(i) - 1))
                    if len(i) < self.min_frames else i for i in item]
        out = {name: value for name, value in zip(self.output_names, item)}
        out["_id_list"] = id_name
        return out

    def get_length(self, id_name):
        """Cached sequence length, rounded up to chunk_size multiples."""
        if id_name not in self._length_cache:
            sample = self.load(id_name)
            if isinstance(sample, (tuple, list)):
                sample = sample[0]
            length = len(sample)
            if self.chunk_size > 1:
                length = int(np.ceil(length / self.chunk_size)
                             * self.chunk_size)
            self._length_cache[id_name] = length
        return self._length_cache[id_name]

    def _chunk_padding(self, sample):
        remainder = len(sample) % self.chunk_size
        pad = (self.chunk_size - remainder) if remainder else 0
        return [(0, pad)] + [(0, 0)] * (np.ndim(sample) - 1)

    def pad(self, sample, pad_width, pad_mode=None):
        return np.pad(sample, pad_width, pad_mode or self.pad_mode)

    @staticmethod
    def trim_end_sample(sample, length, reverse=False):
        if length == 0:
            return sample
        if reverse:
            return sample[length:]
        return sample[:len(sample) - length]

    def trim(self, sample, trim_width):
        slices = []
        for dim, v in enumerate(trim_width):
            if isinstance(v, tuple):
                slices.append(slice(v[0], sample.shape[dim] - v[1]))
            else:
                slices.append(v)
        return sample[tuple(slices)]


class NpzDataReader(DataReader):
    """Reader for per-utterance feature files with normalisation.

    Supports ``<id>.npz`` archives (feature keys) spread over multiple
    directories, plus raw float32 files ``<id><ext>`` when
    ``raw_feature_dims`` is configured (reference fixture layout).
    """

    class Config(DataReader.Config):

        class NormType(Enum):
            NONE = "None"
            MEAN_VARIANCE = "mean_variance"
            MEAN_STDDEV = "mean_stddev"
            MIN_MAX = "min_max"

        def __init__(self, name, directory=None, features=None, indices=None,
                     norm_params_path=None, norm_params=None,
                     norm_type=None, output_names=None,
                     preprocessing_fn=None, preprocess_before_norm=False,
                     postprocessing_fn=None, postprocess_before_norm=True,
                     raw_feature_dims=None, raw_file_extension=None,
                     **kwargs):
            self.features = (features if isinstance(features, list)
                             else [features]) if features is not None \
                else [name]
            self.indices = indices
            super().__init__(
                name=name,
                output_names=(output_names if output_names is not None
                              else self.features),
                **kwargs)
            self.directory = (list(directory)
                              if isinstance(directory, (tuple, list))
                              else [directory])
            self.norm_params_path = norm_params_path
            self.norm_params = norm_params
            self.norm_type = norm_type or NpzDataReader.Config.NormType.NONE
            self.preprocessing_fn = preprocessing_fn
            self.preprocess_before_norm = preprocess_before_norm
            self.postprocessing_fn = postprocessing_fn
            self.postprocess_before_norm = postprocess_before_norm
            self.raw_feature_dims = raw_feature_dims
            self.raw_file_extension = raw_file_extension

        def create_reader(self):
            reader = NpzDataReader(self)
            if reader.normaliser is not None and reader.norm_params is None:
                try:
                    reader.get_normalisation_params()
                except (AssertionError, FileNotFoundError) as e:
                    # Tolerated (stats may be provided later or the
                    # reader may be output-only), but NOT silent: a
                    # configured norm_type without stats means raw
                    # unnormalised features.
                    import logging
                    logging.getLogger(__name__).warning(
                        "Reader %s: norm_type %s configured but no "
                        "normalisation stats found (%s) — features "
                        "will pass through unnormalised.",
                        self.name, self.norm_type, e)
            return reader

    _NORMALISERS = {
        Config.NormType.NONE: None,
        Config.NormType.MEAN_VARIANCE: MeanCovarianceExtractor,
        Config.NormType.MEAN_STDDEV: MeanStdDevExtractor,
        Config.NormType.MIN_MAX: MinMaxExtractor,
    }

    def __init__(self, config):
        super().__init__(config)
        self.directory = config.directory
        self.features = config.features
        self.indices = config.indices
        norm_cls = self._NORMALISERS[config.norm_type]
        self.normaliser = norm_cls() if norm_cls else None
        self.norm_params = config.norm_params
        if self.norm_params is None and config.norm_params_path is not None \
                and self.normaliser is not None:
            self.norm_params = self.normaliser.load(config.norm_params_path)
        self.preprocessing_fn = config.preprocessing_fn
        self.preprocess_before_norm = config.preprocess_before_norm
        self.postprocessing_fn = config.postprocessing_fn
        self.postprocess_before_norm = config.postprocess_before_norm
        self.raw_feature_dims = config.raw_feature_dims
        self.raw_file_extension = config.raw_file_extension

    # -- normalisation parameters ---------------------------------------
    def get_normalisation_params(self, dir_out=None, file_name=None):
        if self.normaliser is None:
            return None
        if dir_out is not None:
            self.norm_params = self._load_norm_params(dir_out, file_name)
            return self.norm_params
        params = []
        for directory in self.directory:
            try:
                params.append(self._load_norm_params(directory, file_name))
            except FileNotFoundError:
                pass
        assert params, ("No normalisation parameter file found in {}"
                        .format(self.directory))
        self.norm_params = params[0] if len(params) == 1 else params
        return self.norm_params

    def _load_norm_params(self, directory, file_name=None):
        prefix = "" if not file_name else (
            file_name + "-" if os.path.basename(file_name) != "" else
            file_name)
        base = os.path.join(directory, prefix
                            + self.normaliser.file_name_appendix)
        for candidate in (base + ".npz", base + ".bin"):
            if os.path.isfile(candidate):
                return self.normaliser.load(candidate)
        if not file_name:
            # Stats written under an id-list prefix (gen_data's
            # ``<id_list_name>-<appendix>``): unambiguous single match
            # loads directly.
            import glob as _glob
            matches = sorted(
                _glob.glob(os.path.join(
                    directory,
                    "*-" + self.normaliser.file_name_appendix + ext))
                for ext in (".npz", ".bin"))
            matches = [m for group in matches for m in group]
            if len(matches) == 1:
                return self.normaliser.load(matches[0])
        raise FileNotFoundError(base)

    # -- loading ---------------------------------------------------------
    def load(self, id_name):
        id_name = os.path.splitext(os.path.basename(id_name))[0]
        missing = list(self.features)
        # Collect by NAME: features split across directories must land
        # on their declared position regardless of directory-scan
        # order (norm params are applied positionally downstream).
        found = {}
        for directory in self.directory:
            if directory is None:
                continue
            path = os.path.join(directory, id_name + ".npz")
            if os.path.isfile(path):
                archive = np.load(path)
                for feature in list(missing):
                    if feature in archive:
                        found[feature] = archive[feature].astype(
                            np.float32, copy=False)
                        missing.remove(feature)
            elif self.raw_file_extension is not None:
                raw_path = os.path.join(directory,
                                        id_name + self.raw_file_extension)
                if os.path.isfile(raw_path) and missing:
                    arr = np.fromfile(raw_path, dtype=np.float32)
                    if self.raw_feature_dims and self.raw_feature_dims > 1:
                        arr = arr.reshape(-1, self.raw_feature_dims)
                    found[missing.pop(0)] = arr
        if missing:
            raise FileNotFoundError(
                "Cannot find features {} for id {} in {}".format(
                    missing, id_name, self.directory))
        ordered = [found[f] for f in self.features]
        return ordered[0] if len(ordered) == 1 else ordered

    # -- pre/post processing ---------------------------------------------
    def preprocess_sample(self, features, feature_idx=0):
        if isinstance(features, list):
            return [self.preprocess_sample(f, i)
                    for i, f in enumerate(features)]
        if self.indices is not None:
            features = self._subset(features)
        if self.preprocess_before_norm and self.preprocessing_fn is not None:
            features = self.preprocessing_fn(features)
        if self.normaliser is not None and self.norm_params is not None:
            features = self._normalise(features, feature_idx)
        if not self.preprocess_before_norm \
                and self.preprocessing_fn is not None:
            features = self.preprocessing_fn(features)
        return np.asarray(features).astype(np.float32, copy=False)

    def postprocess_sample(self, features, feature_idx=0):
        if isinstance(features, dict):
            # Keys may follow either naming; resolve each key's norm
            # index through features/output_names rather than assuming
            # dict order matches self.features.
            def index_of(name):
                for names in (self.features, self.output_names):
                    if names and name in names:
                        return list(names).index(name)
                return 0
            return {name: self.postprocess_sample(value, index_of(name))
                    for name, value in features.items()}
        if self.postprocess_before_norm and self.postprocessing_fn is not None:
            features = self.postprocessing_fn(features)
        if self.normaliser is not None and self.norm_params is not None:
            features = self._denormalise(features, feature_idx)
        if not self.postprocess_before_norm \
                and self.postprocessing_fn is not None:
            features = self.postprocessing_fn(features)
        return features

    def _subset(self, features):
        if isinstance(self.indices, dict):
            index_tuple = tuple(self.indices.get(dim, slice(None))
                                for dim in range(features.ndim))
            return features[index_tuple]
        return features[..., self.indices]

    def _params_for(self, feature_idx):
        if isinstance(self.norm_params[0], (tuple, list)):
            return self.norm_params[feature_idx]
        return self.norm_params

    def _normalise(self, feature, feature_idx):
        return self.normaliser._normalise(feature,
                                          *self._params_for(feature_idx))

    def _denormalise(self, feature, feature_idx):
        return self.normaliser._denormalise(feature,
                                            *self._params_for(feature_idx))


class LabelGen:
    """Base class for offline feature extractors: subclasses implement
    ``gen_data`` (offline extraction) and act as data readers at train
    time."""

    @staticmethod
    def _save_to_npz(file_path, features, feature_name):
        """Add or replace one array of an npz file: read, keep a backup,
        write a temporary file and move it into place, so a crash cannot
        corrupt features written before."""
        file_path = str(file_path)
        if not file_path.endswith(".npz"):
            file_path += ".npz"
        os.makedirs(os.path.dirname(os.path.abspath(file_path)),
                    exist_ok=True)
        data = {}
        backup_path = file_path + ".bak"
        if os.path.isfile(file_path):
            try:
                with np.load(file_path) as existing:
                    data = {k: existing[k] for k in existing.files}
            except Exception:
                if os.path.isfile(backup_path):
                    with np.load(backup_path) as existing:
                        data = {k: existing[k] for k in existing.files}
            else:
                os.replace(file_path, backup_path)
        data[feature_name] = features
        tmp_path = file_path + ".tmp.npz"
        np.savez(tmp_path, **data)
        os.replace(tmp_path, file_path)
        if os.path.isfile(backup_path):
            os.remove(backup_path)

    @staticmethod
    def trim_end_sample(sample, length, reverse=False):
        return DataReader.trim_end_sample(sample, length, reverse)
