"""Normalisation statistics: the loading half of
``idiaptts_tpu/data/normalisation.py``.

The port reads statistics that the JAX package (or the reference) wrote;
accumulating and saving them stays with the feature-extraction slice
(ROADMAP.md queue 1 item 10).  File formats:

* ``*-mean-std_dev.bin``  : int32 ``sum_length`` header, float64 ``(2, D)``
  (mean row, std-dev row).
* ``*-mean-covariance.bin``: two int32 (``sum_length``, ``size``) header,
  float64 ``(size, D)`` where row 0 is the mean and rows 1.. the covariance.
* ``*-min-max.bin``        : headerless float64 ``(2, D)`` (min, max).
* npz archives with keys ``mean``/``std_dev``, ``mean``/``covariance`` or
  ``min``/``max``.
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


class MeanStdDevExtractor:
    """Mean / standard-deviation normalisation."""

    file_name_appendix = "mean-std_dev"

    @staticmethod
    def _normalise(feature, mean, std_dev):
        return (feature - mean) / std_dev

    @staticmethod
    def _denormalise(feature, mean, std_dev):
        return feature * std_dev + mean

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


class MeanCovarianceExtractor:
    """Mean / covariance normalisation (the covariance also feeds MLPG)."""

    file_name_appendix = "mean-covariance"

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
    """Per-dimension min/max normalisation (question features)."""

    file_name_appendix = "min-max"

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
