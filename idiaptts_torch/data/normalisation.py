"""Normalisation statistics: the port's copy of
``idiaptts_tpu/data/normalisation.py`` without the subset combination.

The loaders read statistics that the JAX package (or the reference)
wrote.  :class:`MeanStdDevExtractor` and :class:`MinMaxExtractor` also
accumulate statistics online (``add_sample``, ``get_params``) and save
them as npz, byte for byte as the JAX package does: question and
duration generation use them.  Accumulating the covariance waits for
feature extraction (ROADMAP.md queue 1 item 5).  File formats:

* ``*-mean-std_dev.bin``  : int32 ``sum_length`` header, float64 ``(2, D)``
  (mean row, std-dev row).
* ``*-mean-covariance.bin``: two int32 (``sum_length``, ``size``) header,
  float64 ``(size, D)`` where row 0 is the mean and rows 1.. the covariance.
* ``*-min-max.bin``        : headerless float64 ``(2, D)`` (min, max).
* npz archives with keys ``mean``/``std_dev``, ``mean``/``covariance`` or
  ``min``/``max`` (each with ``sum_length``), and ``*-stats`` with
  ``sum_frames``/``sum_squared_frames`` (or ``sum_product_frames``
  for the covariance).
"""

import os
import struct

import numpy as np


def _ensure_npz(file_path):
    path = str(file_path)
    if not path.endswith(".npz") and not path.endswith(".bin") \
            and os.path.isfile(path + ".npz"):
        return path + ".npz"
    return path


def _prefix(filename):
    """'dir/name' -> 'dir/name-', 'dir/' -> 'dir/'."""
    if filename is not None and os.path.basename(filename) != "":
        return filename + "-"
    return filename


def _save_npz(filename, sum_length, stats, datatype=np.float64):
    out = {k: np.atleast_1d(v).astype(datatype, copy=False)
           for k, v in stats.items()}
    out["sum_length"] = np.array(sum_length, dtype=np.int64)
    np.savez(filename, **out)


class MeanStdDevExtractor:
    """Online mean / standard deviation accumulator."""

    file_name_stats = "stats"
    file_name_appendix = "mean-std_dev"

    def __init__(self):
        self.sum_length = 0
        self.sum_frames = 0
        self.sum_squared_frames = 0

    @staticmethod
    def _normalise(feature, mean, std_dev):
        return (feature - mean) / std_dev

    @staticmethod
    def _denormalise(feature, mean, std_dev):
        return feature * std_dev + mean

    def add_sample(self, sample):
        if sample is None:
            raise ValueError("add_sample needs a sample, got None")
        sample = np.asarray(sample)
        self.sum_length += len(sample)
        self.sum_frames = self.sum_frames + np.sum(sample, axis=0)
        self.sum_squared_frames = (self.sum_squared_frames
                                   + np.sum(sample ** 2, axis=0))

    def get_params(self):
        mean = self.sum_frames / self.sum_length
        var = self.sum_squared_frames / self.sum_length - mean ** 2
        std_dev = np.sqrt(np.maximum(var, 0.0))
        return np.atleast_1d(mean), np.atleast_1d(std_dev)

    def save(self, filename, datatype=np.float64):
        self.save_stats(filename, datatype)
        self.save_mean_std_dev(filename, datatype)

    def save_stats(self, filename, datatype=np.float64):
        _save_npz(_prefix(filename) + self.file_name_stats, self.sum_length,
                  {"sum_frames": self.sum_frames,
                   "sum_squared_frames": self.sum_squared_frames}, datatype)

    def save_mean_std_dev(self, filename, datatype=np.float64):
        mean, std_dev = self.get_params()
        _save_npz(_prefix(filename) + self.file_name_appendix,
                  self.sum_length, {"mean": mean, "std_dev": std_dev},
                  datatype)

    @staticmethod
    def load_stats(file_path, datatype=np.float64):
        with np.load(_ensure_npz(file_path)) as archive:
            return (archive["sum_frames"], archive["sum_squared_frames"],
                    archive["sum_length"])

    @staticmethod
    def load(file_path, datatype=np.float64):
        if str(file_path).endswith(".bin"):  # legacy binary format
            with open(file_path, "rb") as f:
                struct.unpack("i", f.read(4))  # sum_length, unused
                arr = np.fromfile(f, dtype=datatype).reshape((2, -1))
            mean, std_dev = arr[0:1], arr[1:2]
        else:
            with np.load(_ensure_npz(file_path)) as archive:
                mean, std_dev = archive["mean"], archive["std_dev"]
        return (np.atleast_1d(mean).astype(np.float32, copy=False),
                np.atleast_1d(std_dev).astype(np.float32, copy=False))

    @staticmethod
    def load_mean_std_dev_from_stats(file_path, datatype=np.float64):
        s, ss, n = MeanStdDevExtractor.load_stats(file_path, datatype)
        mean = s / n
        std_dev = np.sqrt(np.maximum(ss / n - mean ** 2, 0.0))
        return (mean.astype(np.float32, copy=False),
                std_dev.astype(np.float32, copy=False))

    @staticmethod
    def combine_stats(file_list, dir_out=None, datatype=np.float64,
                      save_txt=False):
        """Sum the ``*-stats`` of corpus subsets; saved to ``dir_out``
        when given."""
        total = MeanStdDevExtractor()
        for path in file_list:
            s, ss, n = MeanStdDevExtractor.load_stats(path, datatype)
            total.sum_length += int(n)
            total.sum_frames = total.sum_frames + s
            total.sum_squared_frames = total.sum_squared_frames + ss
        if dir_out is not None:
            total.save(os.path.join(dir_out, ""), datatype)
        return total


class MeanCovarianceExtractor:
    """Online mean / full covariance accumulator (the covariance also
    feeds MLPG)."""

    file_name_stats = "stats"
    file_name_appendix = "mean-covariance"

    def __init__(self):
        self.sum_length = 0
        self.sum_frames = 0
        self.sum_product_frames = 0

    @staticmethod
    def _cov_to_std(cov_or_std):
        cov_or_std = np.asarray(cov_or_std)
        if cov_or_std.ndim == 2 and cov_or_std.shape[0] == \
                cov_or_std.shape[1] and cov_or_std.shape[0] > 1:
            return np.sqrt(np.maximum(np.diagonal(cov_or_std), 1e-20))
        return np.squeeze(cov_or_std)  # already a std-dev vector

    @staticmethod
    def _normalise(feature, mean, covariance):
        std = MeanCovarianceExtractor._cov_to_std(covariance)
        return (feature - np.squeeze(mean)) / std

    @staticmethod
    def _denormalise(feature, mean, covariance):
        std = MeanCovarianceExtractor._cov_to_std(covariance)
        return feature * std + np.squeeze(mean)

    def add_sample(self, sample):
        if sample is None:
            raise ValueError("add_sample needs a sample, got None")
        sample = np.asarray(sample)
        self.sum_length += len(sample)
        self.sum_frames = self.sum_frames + np.sum(sample, axis=0,
                                                   keepdims=True)
        self.sum_product_frames = (self.sum_product_frames
                                   + sample.T @ sample)

    def get_params(self):
        mean = np.atleast_2d(self.sum_frames / self.sum_length)
        covariance = (self.sum_product_frames / self.sum_length
                      - mean.T @ mean)
        return mean, np.atleast_2d(covariance)

    def save(self, filename, datatype=np.float64):
        self.save_stats(filename, datatype)
        self.save_mean_covariance(filename, datatype)

    def save_stats(self, filename, datatype=np.float64):
        _save_npz(_prefix(filename) + self.file_name_stats, self.sum_length,
                  {"sum_frames": self.sum_frames,
                   "sum_product_frames": self.sum_product_frames}, datatype)

    def save_mean_covariance(self, filename, datatype=np.float64):
        mean, covariance = self.get_params()
        _save_npz(_prefix(filename) + self.file_name_appendix,
                  self.sum_length, {"mean": mean, "covariance": covariance},
                  datatype)

    @staticmethod
    def load_stats(file_path, datatype=np.float64):
        with np.load(_ensure_npz(file_path)) as archive:
            return (archive["sum_frames"], archive["sum_product_frames"],
                    archive["sum_length"])

    @staticmethod
    def combine_stats(file_list, dir_out=None, datatype=np.float64):
        """Sum the ``*-stats`` of corpus subsets; saved to ``dir_out``
        when given."""
        total = MeanCovarianceExtractor()
        for path in file_list:
            s, sp, n = MeanCovarianceExtractor.load_stats(path, datatype)
            total.sum_length += int(n)
            total.sum_frames = total.sum_frames + s
            total.sum_product_frames = total.sum_product_frames + sp
        if dir_out is not None:
            total.save(os.path.join(dir_out, ""), datatype)
        return total

    @staticmethod
    def load(file_path, datatype=np.float64):
        if str(file_path).endswith(".bin"):  # legacy binary format
            with open(file_path, "rb") as f:
                _, size = struct.unpack("ii", f.read(8))
                arr = np.fromfile(f, dtype=datatype).reshape((size, -1))
            mean, covariance = arr[0:1], arr[1:]
        else:
            with np.load(_ensure_npz(file_path)) as archive:
                mean, covariance = archive["mean"], archive["covariance"]
        mean = np.atleast_2d(mean).astype(np.float32, copy=False)
        covariance = np.atleast_2d(covariance).astype(np.float32, copy=False)
        return mean, covariance


class MinMaxExtractor:
    """Online per-dimension min/max accumulator (question normalisation)."""

    file_name_appendix = "min-max"

    def __init__(self):
        self.combined_min = None
        self.combined_max = None

    @staticmethod
    def _fix_range(range_):
        range_ = np.atleast_1d(np.array(range_, dtype=np.float64, copy=True))
        range_[range_ <= 0] = 1.0
        return range_

    @staticmethod
    def _normalise(feature, min_, max_):
        return (feature - min_) / MinMaxExtractor._fix_range(max_ - min_)

    @staticmethod
    def _denormalise(feature, min_, max_):
        return feature * MinMaxExtractor._fix_range(max_ - min_) + min_

    def add_sample(self, sample):
        if sample is None:
            raise ValueError("add_sample needs a sample, got None")
        sample = np.asarray(sample)
        cur_min = sample.min(axis=0)
        cur_max = sample.max(axis=0)
        if self.combined_min is None:
            self.combined_min, self.combined_max = cur_min, cur_max
        else:
            self.combined_min = np.minimum(self.combined_min, cur_min)
            self.combined_max = np.maximum(self.combined_max, cur_max)

    def get_params(self):
        return (np.atleast_1d(self.combined_min),
                np.atleast_1d(self.combined_max))

    def save(self, filename, datatype=np.float64):
        vmin, vmax = self.get_params()
        _save_npz(_prefix(filename) + self.file_name_appendix, 0,
                  {"min": vmin, "max": vmax}, datatype)

    @staticmethod
    def load(file_path, datatype=np.float64):
        if str(file_path).endswith(".bin"):  # legacy: headerless (2, D)
            arr = np.fromfile(file_path, dtype=datatype).reshape((2, -1))
            vmin, vmax = arr[0:1], arr[1:2]
        else:
            with np.load(_ensure_npz(file_path)) as archive:
                vmin, vmax = archive["min"], archive["max"]
        return (np.atleast_1d(vmin).astype(np.float32, copy=False),
                np.atleast_1d(vmax).astype(np.float32, copy=False))

    @staticmethod
    def combine_min_max(file_list, dir_out=None):
        """Min and max over the ``*-min-max`` files of corpus subsets;
        saved to ``dir_out`` when given."""
        total = MinMaxExtractor()
        for path in file_list:
            vmin, vmax = MinMaxExtractor.load(path)
            total.add_sample(np.stack([np.squeeze(vmin), np.squeeze(vmax)]))
        if dir_out is not None:
            total.save(os.path.join(dir_out, ""))
        return total
