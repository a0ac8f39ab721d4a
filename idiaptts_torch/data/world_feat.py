"""WORLD acoustic features: the port of ``idiaptts_tpu/data/world_feat.py``
without extraction and non-cepstral decoding.

Feature layout (the JAX package's and the reference's):
  cmp = [coded_sp(+d+dd) | lf0(+d+dd) | vuv | bap(+d+dd)]
Storage: per-stream npz under ``dir/<sp_type><num>/id.npz`` (keys
``<sp_type>``, ``<sp_type>_deltas``, ``<sp_type>_double_deltas``),
``dir/lf0``, ``dir/vuv``, ``dir/bap``; normalisation statistics per
stream (mean-covariance under ``dir/cmp_<sp_type><num>/`` with deltas,
mean-std_dev per stream directory without).  The raw-binary fixture
layout (``.mcep``/``.lf0``/... float32 files and
``cmp_<sp_type><num>/*.cmp``) loads too.

Post-processing of predictions (``postprocess_sample``): denormalise,
then per-stream MLPG through ``MLPG.generation`` (the one-shot solve
kernel) on the reader's ``device`` (``"cuda"`` unless the config says
``"cpu"``), three solves per utterance (coded spectrum, lf0, bap).

Not ported yet (ROADMAP.md queue 1 item 5): extraction from audio
(``gen_data``) and the non-cepstral spectrum decoding (``decode_sp``,
``world_features_to_raw``).
"""

import logging
import os

import numpy as np

from idiaptts_torch.data.normalisation import (MeanCovarianceExtractor,
                                               MeanStdDevExtractor)
from idiaptts_torch.data.reader import LabelGen, NpzDataReader
from idiaptts_torch.ops.mlpg import MLPG

logger = logging.getLogger(__name__)

_LATER_EXTRACT = ("WORLD feature extraction and non-cepstral spectrum "
                  "decoding are not ported yet; ROADMAP.md queue 1 item "
                  "5 ports them")


class WorldFeatLabelGen(NpzDataReader, LabelGen):
    """WORLD feature reader."""

    dir_lf0 = "lf0"
    dir_vuv = "vuv"
    dir_bap = "bap"
    dir_deltas = "cmp"
    ext_lf0 = "lf0"
    ext_vuv = "vuv"
    ext_bap = "bap"
    ext_deltas = "cmp"

    class Config(NpzDataReader.Config):
        def __init__(self, name, directory=None, indices=None,
                     norm_params_path=None, norm_params=None,
                     norm_type=None, output_names=None,
                     preprocessing_fn=None, preprocess_before_norm=False,
                     postprocessing_fn=None, postprocess_before_norm=False,
                     add_deltas=False, preemphasis=0.0, n_fft=None,
                     win_length_ms=None, num_coded_sps=60, num_bap=1,
                     sp_type="mcep", mgc_alpha=None,
                     frame_shift_ms=5.0, load_sp=True,
                     load_lf0=True, load_vuv=True, load_bap=True,
                     apply_mlpg=True, device="cuda", **kwargs):
            if norm_type is None:
                norm_type = (NpzDataReader.Config.NormType.MEAN_VARIANCE
                             if add_deltas else
                             NpzDataReader.Config.NormType.MEAN_STDDEV)
            super().__init__(name, directory=directory, indices=indices,
                             norm_params_path=norm_params_path,
                             norm_params=norm_params, norm_type=norm_type,
                             output_names=output_names,
                             preprocessing_fn=preprocessing_fn,
                             preprocess_before_norm=preprocess_before_norm,
                             postprocessing_fn=postprocessing_fn,
                             postprocess_before_norm=postprocess_before_norm,
                             **kwargs)
            self.add_deltas = add_deltas
            self.preemphasis = preemphasis
            self.n_fft = n_fft
            self.win_length_ms = win_length_ms
            self.num_coded_sps = num_coded_sps
            self.num_bap = num_bap
            self.sp_type = sp_type
            # Warping-coefficient override (e.g. Merlin's 0.58 at 16 kHz).
            self.mgc_alpha = mgc_alpha
            self.frame_shift_ms = frame_shift_ms
            self.load_sp = load_sp
            self.load_lf0 = load_lf0
            self.load_vuv = load_vuv
            self.load_bap = load_bap
            self.apply_mlpg = apply_mlpg
            # Where the MLPG of postprocess_sample runs.
            self.device = device

        def create_reader(self):
            reader = WorldFeatLabelGen(self)
            try:
                reader.get_normalisation_params()
            except (AssertionError, FileNotFoundError):
                logger.warning("No normalisation parameters found for %s",
                               self.name)
            return reader

    def __init__(self, config_or_dir=None, **kwargs):
        if isinstance(config_or_dir, WorldFeatLabelGen.Config):
            config = config_or_dir
        else:
            # LEGACY-style construction: (dir_labels, add_deltas=..., ...)
            dir_labels = kwargs.pop("dir_labels", config_or_dir)
            config = WorldFeatLabelGen.Config(
                name="world", directory=dir_labels, **kwargs)
        super().__init__(config)
        self.add_deltas = config.add_deltas
        self.preemphasis = config.preemphasis
        self.num_coded_sps = config.num_coded_sps
        self.num_bap = config.num_bap
        self.sp_type = config.sp_type
        self.mgc_alpha = getattr(config, "mgc_alpha", None)
        self.frame_shift_ms = config.frame_shift_ms
        self.load_sp = config.load_sp
        self.load_lf0 = config.load_lf0
        self.load_vuv = config.load_vuv
        self.load_bap = config.load_bap
        self.apply_mlpg = config.apply_mlpg
        self.device = config.device
        self.covs = [None] * 4
        self.dir_labels = self.directory[0]
        if config.postprocessing_fn is None:
            self.postprocessing_fn = lambda sample: self._postprocess_world(
                sample, apply_mlpg=self.apply_mlpg)

    # ------------------------------------------------------------------
    @property
    def dir_coded_sps(self):
        return self.sp_type + str(self.num_coded_sps)

    def _stream_dims(self):
        factor = 3 if self.add_deltas else 1
        return (self.num_coded_sps * factor, factor, 1,
                self.num_bap * factor)

    # -- loading ---------------------------------------------------------
    def load(self, id_name):
        id_name = os.path.splitext(os.path.basename(id_name))[0]
        try:
            return self._load_streams(id_name)
        except FileNotFoundError:
            return self._load_cmp(id_name)

    def _stream_info(self):
        return (
            (self.load_sp, self.dir_coded_sps, self.sp_type,
             self.num_coded_sps),
            (self.load_lf0, self.dir_lf0, self.ext_lf0, 1),
            (self.load_vuv, self.dir_vuv, self.ext_vuv, 1),
            (self.load_bap, self.dir_bap, self.ext_bap, self.num_bap),
        )

    def _load_streams(self, id_name):
        output = []
        for load, subdir, ext, dim in self._stream_info():
            if not load:
                continue
            path = os.path.join(self.dir_labels, subdir, id_name)
            if os.path.isfile(path + ".npz"):
                archive = np.load(path + ".npz")
                feats = archive[ext].astype(np.float32)
                if feats.ndim == 1:
                    feats = feats[:, None]
                if self.add_deltas and ext != self.ext_vuv:
                    feats = np.concatenate(
                        [feats,
                         archive[ext + "_deltas"].astype(np.float32),
                         archive[ext + "_double_deltas"].astype(np.float32)],
                        axis=1)
                output.append(feats)
            elif os.path.isfile(path + "." + ext) and not self.add_deltas:
                # LEGACY raw float32 (the committed fixture layout).
                feats = np.fromfile(path + "." + ext,
                                    dtype=np.float32).reshape(-1, dim)
                output.append(feats)
            else:
                raise FileNotFoundError(path)
        if not output:
            raise ValueError("At least one feature stream must be loaded.")
        return np.concatenate(output, axis=1)

    def _load_cmp(self, id_name):
        """Fall back to the cmp directory (always contains deltas)."""
        path = os.path.join(
            self.dir_labels,
            "{}_{}{}".format(self.dir_deltas, self.sp_type,
                             self.num_coded_sps),
            "{}.{}".format(id_name, self.ext_deltas))
        if os.path.isfile(path + ".npz"):
            cmp = np.load(path + ".npz")[self.ext_deltas].astype(np.float32)
        else:
            cmp = np.fromfile(path, dtype=np.float32)
        total = 3 * (self.num_coded_sps + 1 + self.num_bap) + 1
        cmp = cmp.reshape(-1, total)
        dim_sp, dim_lf0, dim_vuv, dim_bap = self._stream_dims()
        out = []
        if self.load_sp:
            out.append(cmp[:, :dim_sp])
        if self.load_lf0:
            start = 3 * self.num_coded_sps
            out.append(cmp[:, start:start + dim_lf0])
        if self.load_vuv:
            start = -3 * self.num_bap - 1
            out.append(cmp[:, start:start + 1])
        if self.load_bap:
            if dim_bap == 3 * self.num_bap:
                out.append(cmp[:, -3 * self.num_bap:])
            else:
                start = -3 * self.num_bap
                out.append(cmp[:, start:start + dim_bap])
        return np.concatenate(out, axis=1)

    # -- normalisation ----------------------------------------------------
    def get_normalisation_params(self, dir_out=None, file_name=None):
        """Assemble per-stream normalisation vectors; keeps per-stream
        covariances for MLPG."""
        if dir_out is None:
            dir_out = self.dir_labels
        means, scales = [], []
        for idx, (load, subdir, ext, dim) in enumerate(self._stream_info()):
            if not load:
                continue
            if subdir == self.dir_vuv:
                means.append(np.zeros((1, 1), np.float32))
                scales.append(np.ones((1, 1), np.float32))
                continue
            mean, scale, cov = self._load_stream_norm(dir_out, subdir,
                                                      file_name)
            self.covs[idx] = cov
            means.append(np.atleast_2d(mean))
            scales.append(np.atleast_2d(scale))
        mean = np.concatenate(means, axis=1).astype(np.float32)
        scale = np.concatenate(scales, axis=1).astype(np.float32)
        self.norm_params = (mean.squeeze(0), scale.squeeze(0))
        return self.norm_params

    def _load_stream_norm(self, dir_out, subdir, file_name):
        prefix = "" if not file_name else file_name + "-"
        if self.add_deltas:
            # Covariance over [static, delta, delta-delta].
            candidates = [
                os.path.join(dir_out, "{}_{}{}".format(
                    self.dir_deltas, self.sp_type, self.num_coded_sps),
                    "{}{}-{}.bin".format(
                        prefix, subdir,
                        MeanCovarianceExtractor.file_name_appendix)),
                os.path.join(dir_out, "{}_{}{}".format(
                    self.dir_deltas, self.sp_type, self.num_coded_sps),
                    "{}{}-{}.npz".format(
                        prefix, subdir,
                        MeanCovarianceExtractor.file_name_appendix)),
                os.path.join(dir_out, subdir,
                             "{}{}.npz".format(
                                 prefix,
                                 MeanCovarianceExtractor.file_name_appendix)),
            ]
            for path in candidates:
                if os.path.isfile(path):
                    mean, cov = MeanCovarianceExtractor.load(path)
                    std = np.sqrt(np.maximum(np.diagonal(cov), 1e-20))
                    return mean.reshape(1, -1), std.reshape(1, -1), cov
            raise FileNotFoundError(candidates[0])
        candidates = [
            os.path.join(dir_out, subdir, "{}{}.npz".format(
                prefix, MeanStdDevExtractor.file_name_appendix)),
            os.path.join(dir_out, subdir, "{}{}.bin".format(
                prefix, MeanStdDevExtractor.file_name_appendix)),
        ]
        for path in candidates:
            if os.path.isfile(path):
                mean, std = MeanStdDevExtractor.load(path)
                return mean.reshape(1, -1), std.reshape(1, -1), None
        raise FileNotFoundError(candidates[0])

    @staticmethod
    def load_sample(id_name, dir_out, add_deltas=False, num_coded_sps=60,
                    num_bap=1, sp_type="mcep", load_sp=True, load_lf0=True,
                    load_vuv=True, load_bap=True):
        reader = WorldFeatLabelGen(
            dir_labels=dir_out, add_deltas=add_deltas,
            num_coded_sps=num_coded_sps, num_bap=num_bap, sp_type=sp_type,
            load_sp=load_sp, load_lf0=load_lf0, load_vuv=load_vuv,
            load_bap=load_bap)
        return reader.load(id_name)

    # -- conversions -------------------------------------------------------
    @staticmethod
    def convert_to_world_features(sample, contains_deltas=False,
                                  num_coded_sps=60, num_bap=1):
        """[sp, lf0, vuv, bap](+deltas) matrix -> (coded_sp, lf0, vuv,
        bap) statics tuple."""
        deltas_factor = 3 if contains_deltas else 1
        coded_sp = sample[:, :num_coded_sps]
        pos = num_coded_sps * deltas_factor
        lf0 = sample[:, pos]
        pos += deltas_factor
        vuv = np.copy(sample[:, pos])
        vuv[vuv < 0.5] = 0.0
        vuv[vuv >= 0.5] = 1.0
        pos += 1
        bap = sample[:, pos:pos + num_bap]
        return coded_sp, lf0, vuv, bap

    @staticmethod
    def convert_from_world_features(coded_sp, lf0, vuv, bap):
        """(coded_sp, lf0, vuv, bap) statics -> one [sp, lf0, vuv, bap]
        matrix: the inverse of :meth:`convert_to_world_features`."""
        if lf0.ndim < 2:
            lf0 = lf0[:, None]
        if vuv.ndim < 2:
            vuv = vuv[:, None]
        if bap.ndim < 2:
            bap = bap[:, None]
        return np.concatenate([coded_sp, lf0, vuv, bap], axis=1)

    # -- post-processing --------------------------------------------------
    def postprocess_sample(self, sample, feature_idx=0, norm_params=None,
                           apply_mlpg=None):
        """Denormalise a (T, cmp) prediction and run MLPG per stream
        (``apply_mlpg`` defaults to the config's)."""
        if apply_mlpg is None:
            apply_mlpg = self.apply_mlpg
        saved_fn = self.postprocessing_fn
        saved_params = self.norm_params
        self.postprocessing_fn = lambda s: self._postprocess_world(
            s, apply_mlpg=apply_mlpg)
        if norm_params is not None:
            self.norm_params = norm_params
        try:
            return super().postprocess_sample(sample, feature_idx)
        finally:
            self.postprocessing_fn = saved_fn
            self.norm_params = saved_params

    def _postprocess_world(self, sample, apply_mlpg=True):
        """Denormalised network output -> [coded_sp, lf0, vuv, bap]
        statics, with per-stream MLPG on ``self.device`` when deltas are
        modelled."""
        if not self.add_deltas:
            return sample
        mlpg = MLPG()

        def smooth(block, cov, dim):
            if not apply_mlpg:
                return block[:, :dim]
            return mlpg.generation(block, cov, dim, device=self.device)

        out = []
        pos = 0
        if self.load_sp:
            out.append(smooth(sample[:, pos:pos + self.num_coded_sps * 3],
                              self.covs[0], self.num_coded_sps))
            pos += self.num_coded_sps * 3
        if self.load_lf0:
            out.append(smooth(sample[:, pos:pos + 3], self.covs[1], 1))
            pos += 3
        if self.load_vuv:
            out.append((sample[:, pos] > 0.5).astype(np.float32)[:, None])
            pos += 1
        if self.load_bap:
            out.append(smooth(sample[:, -self.num_bap * 3:], self.covs[3],
                              self.num_bap))
        return np.concatenate(out, axis=1)

    @staticmethod
    def decode_sp(*args, **kwargs):
        raise NotImplementedError(_LATER_EXTRACT)

    @staticmethod
    def world_features_to_raw(*args, **kwargs):
        raise NotImplementedError(_LATER_EXTRACT)

    @staticmethod
    def gen_data(*args, **kwargs):
        raise NotImplementedError(_LATER_EXTRACT)
