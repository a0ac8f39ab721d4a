"""WORLD acoustic features: the port of ``idiaptts_tpu/data/world_feat.py``.

Feature layout (the JAX package's and the reference's):
  cmp = [coded_sp(+d+dd) | lf0(+d+dd) | vuv | bap(+d+dd)]
Storage: per-stream npz under ``dir/<sp_type><num>/id.npz`` (keys
``<sp_type>``, ``<sp_type>_deltas``, ``<sp_type>_double_deltas``),
``dir/lf0``, ``dir/vuv``, ``dir/bap``; normalisation statistics per
stream (mean-covariance under ``dir/cmp_<sp_type><num>/`` with deltas,
mean-std_dev per stream directory without).  The raw-binary fixture
layout (``.mcep``/``.lf0``/... float32 files and
``cmp_<sp_type><num>/*.cmp``) loads too.

Extraction (``gen_data``, ``extract_features``) analyses each wav on the
reader's ``device`` (``"cuda"`` unless the config says ``"cpu"``)
through :mod:`idiaptts_torch.ops.world`; the corpus loop overlaps
utterance i's host work (voicing refinement, deltas, statistics, npz
writes) with utterance i+1's analysis on the card.  The statistics are
numpy float64 on the host.

Post-processing of predictions (``postprocess_sample``): denormalise,
then per-stream MLPG through ``MLPG.generation`` (the one-shot solve
kernel) on the reader's ``device``, three solves per utterance (coded
spectrum, lf0, bap).  ``decode_sp`` and ``world_features_to_raw`` turn
coded features back into amplitude spectra and waveforms on a
``device`` of their own.
"""

import glob
import logging
import os

import numpy as np
import torch

from idiaptts_torch.data.normalisation import (MeanCovarianceExtractor,
                                               MeanStdDevExtractor)
from idiaptts_torch.data.reader import LabelGen, NpzDataReader
from idiaptts_torch.ops import audio_io
from idiaptts_torch.ops import mcep as mcep_ops
from idiaptts_torch.ops.dispatch import resolve_device
from idiaptts_torch.ops.interpolation import (add_deltas as _stack_deltas,
                                              interpolate_lin)
from idiaptts_torch.ops.mlpg import MLPG

logger = logging.getLogger(__name__)


class WorldFeatLabelGen(NpzDataReader, LabelGen):
    """WORLD feature extractor and reader."""

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

    @property
    def load_flags(self):
        return (self.load_sp, self.load_lf0, self.load_vuv, self.load_bap)

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

    # -- extraction -----------------------------------------------------
    @staticmethod
    def _lf0_vuv(f0):
        """f0 track -> (lf0, vuv) (T, 1) float32: frames below 20 Hz are
        unvoiced, gaps are filled by :func:`interpolate_lin`."""
        f0 = np.array(f0)
        f0[f0 < 20.0] = 0.0
        ip_f0, vuv = interpolate_lin(f0)
        lf0 = np.log(np.maximum(ip_f0, 1e-10)).astype(np.float32)
        return lf0, vuv.astype(np.float32)

    @staticmethod
    def world_extract_features(raw, fs, frame_shift_ms=5.0, device="cuda"):
        """Waveform -> (amp_sp, lf0, vuv, bap) numpy: F0, the CheapTrick
        envelope and the coded band aperiodicity, analysed on
        ``device``."""
        from idiaptts_torch.ops.world import (cheaptrick,
                                              d4c_band_aperiodicity,
                                              extract_f0)
        from idiaptts_torch.ops.world.d4c import code_aperiodicity
        f0 = extract_f0(raw, fs, frame_shift_ms, device=device)
        with torch.inference_mode():
            amp_sp = torch.sqrt(cheaptrick(raw, f0, fs, frame_shift_ms,
                                           device=device))
            bap = code_aperiodicity(d4c_band_aperiodicity(
                raw, f0, fs, frame_shift_ms, device=device))
        lf0, vuv = WorldFeatLabelGen._lf0_vuv(f0)
        return amp_sp.cpu().numpy(), lf0, vuv, bap.cpu().numpy()

    @staticmethod
    def extract_features(dir_in, file_name, file_ext="wav",
                         num_coded_sps=60, sp_type="mcep",
                         preemphasis=0.0, frame_shift_ms=5.0,
                         mgc_alpha=None, device="cuda"):
        """One utterance -> ((coded_sp, lf0, vuv, bap), fs), analysed on
        ``device``.  mcep and mgc run the whole analysis in one pass;
        mfbanks codes the envelope as ``log(amp_sp**2 @ fbank.T)``;
        amp_sp keeps it."""
        audio_name = os.path.join(dir_in, "{}.{}".format(file_name,
                                                         file_ext))
        raw, fs = audio_io.get_raw(audio_name, preemphasis)
        if sp_type in ("mcep", "mgc"):
            from idiaptts_torch.ops.world.extract import world_analysis
            f0, coded_sp, bap = world_analysis(
                raw, fs, num_coded_sps, frame_shift_ms,
                mgc_alpha=mgc_alpha, device=device)
            lf0, vuv = WorldFeatLabelGen._lf0_vuv(f0)
            return WorldFeatLabelGen.trim_to_shortest(
                [coded_sp.astype(np.float32), lf0, vuv,
                 bap.astype(np.float32)]), fs
        amp_sp, lf0, vuv, bap = WorldFeatLabelGen.world_extract_features(
            raw, fs, frame_shift_ms, device=device)
        if sp_type == "mfbanks":
            from idiaptts_torch.ops import stft as stft_ops
            fbank = stft_ops.mel_filterbank(fs, (amp_sp.shape[1] - 1) * 2,
                                            n_mels=num_coded_sps)
            coded_sp = np.log(np.maximum(amp_sp ** 2 @ fbank.T, 1e-10))
        elif sp_type == "amp_sp":
            coded_sp = amp_sp
        else:
            raise NotImplementedError("Unknown sp_type " + sp_type)
        return WorldFeatLabelGen.trim_to_shortest(
            [coded_sp.astype(np.float32), lf0, vuv, bap]), fs

    @staticmethod
    def trim_to_shortest(features):
        min_len = min(len(f) for f in features)
        return [f[:min_len] for f in features]

    # -- synthesis ----------------------------------------------------------
    @staticmethod
    def world_features_to_raw(amp_sp, lf0, vuv, bap, fs,
                              frame_shift_ms=5.0, z=None, device="cuda"):
        """WORLD features (amplitude spectrum, lf0, vuv, coded bap) ->
        waveform (numpy) through the harmonic + noise synthesis on
        ``device``, its noise drawn from a generator seeded with 0
        unless ``z`` (complex (T, bins)) gives it."""
        from idiaptts_torch.ops.world.d4c import decode_aperiodicity
        from idiaptts_torch.ops.world.synthesis import world_synthesis
        device = resolve_device(device)
        f0 = np.exp(np.asarray(lf0).reshape(-1))
        vuv = np.asarray(vuv).reshape(-1)
        f0 = np.where(vuv > 0.5, f0, 0.0).astype(np.float32)
        amp_sp = torch.as_tensor(np.asarray(amp_sp, np.float32),
                                 device=device)
        with torch.inference_mode():
            ap = decode_aperiodicity(torch.as_tensor(
                np.atleast_2d(np.asarray(bap, np.float32)), device=device),
                amp_sp.shape[1], fs)
            raw = world_synthesis(f0, amp_sp ** 2, ap, fs, frame_shift_ms,
                                  z=z, device=device)
        return raw.cpu().numpy()

    @staticmethod
    def mcep_to_amp_sp(coded_sp, fs, alpha=None, num_bins=None,
                       device="cuda"):
        """Mel-cepstrum (numpy) -> amplitude spectrum (numpy), rendered
        on ``device``."""
        device = resolve_device(device)
        if alpha is None:
            alpha = mcep_ops.fs_to_mgc_alpha(fs)
        if num_bins is None:
            num_bins = mcep_ops.fs_to_frame_length(fs) // 2 + 1
        with torch.inference_mode():
            return mcep_ops.mcep_to_amp_sp(torch.as_tensor(
                np.asarray(coded_sp, np.float32), device=device), num_bins,
                alpha).cpu().numpy()

    @staticmethod
    def decode_sp(coded_sp, sp_type="mcep", fs=None, alpha=None,
                  n_fft=None, post_filtering=False, device="cuda"):
        """Coded spectrum -> amplitude spectrum (numpy), on ``device``:
        mcep and mgc through the warped-cepstral render, mfbanks through
        the NNLS mel inversion, amp_sp as it is.  ``post_filtering``
        applies the Merlin formant post-filter (cepstra only)."""
        if post_filtering:
            if sp_type in ("mcep", "mgc"):
                with torch.inference_mode():
                    coded_sp = mcep_ops.merlin_post_filter(
                        torch.as_tensor(np.asarray(coded_sp, np.float32),
                                        device=resolve_device(device)),
                        alpha if alpha is not None
                        else mcep_ops.fs_to_mgc_alpha(fs)).cpu().numpy()
            else:
                logger.warning("Post-filtering only implemented for "
                               "cepstrum features.")
        if sp_type in ("mcep", "mgc"):
            num_bins = None if n_fft is None else n_fft // 2 + 1
            return WorldFeatLabelGen.mcep_to_amp_sp(
                coded_sp, fs, alpha=alpha, num_bins=num_bins, device=device)
        if sp_type == "mfbanks":
            from idiaptts_torch.ops import stft as stft_ops
            return stft_ops.mfbanks_to_amp_sp(coded_sp, fs, n_fft=n_fft,
                                              device=device).cpu().numpy()
        if sp_type == "amp_sp":
            return np.asarray(coded_sp)
        raise NotImplementedError(
            "Unknown feature type {}. No decoding method available."
            .format(sp_type))

    # -- corpus generation ------------------------------------------------
    def _new_extractors(self):
        cls = MeanCovarianceExtractor if self.add_deltas \
            else MeanStdDevExtractor
        return cls(), cls(), cls()

    def _full_streams(self, coded_sp, lf0, bap):
        if self.add_deltas:
            return (_stack_deltas(coded_sp), _stack_deltas(lf0),
                    _stack_deltas(bap))
        return coded_sp, lf0, bap

    def gen_data(self, dir_in, dir_out=None, file_id_list="", id_list=None,
                 file_ext="wav", return_dict=False):
        """Extract WORLD features for a corpus on the reader's device:
        per-stream npz files (with deltas when configured) and online
        normalisation statistics per stream (covariances in the cmp
        directory with deltas).  Returns the coded spectrum's
        statistics, and the {id: statics} dict with ``return_dict``."""
        if id_list is None:
            id_list = [os.path.splitext(os.path.basename(p))[0]
                       for p in glob.glob(os.path.join(
                           dir_in, "*." + file_ext))]
            file_id_list_name = "all"
        else:
            file_id_list_name = os.path.splitext(
                os.path.basename(str(file_id_list)))[0] or None
            id_list = [os.path.basename(i) for i in id_list]

        norm_sp, norm_lf0, norm_bap = self._new_extractors()
        label_dict = {}
        for file_name, (coded_sp, lf0, vuv, bap), fs in \
                self._extract_corpus(dir_in, id_list, file_ext):
            if return_dict:
                label_dict[file_name] = \
                    WorldFeatLabelGen.convert_from_world_features(
                        coded_sp, lf0, vuv, bap)
            coded_sp_full, lf0_full, bap_full = self._full_streams(
                coded_sp, lf0, bap)
            norm_sp.add_sample(coded_sp_full)
            norm_lf0.add_sample(lf0_full)
            norm_bap.add_sample(bap_full)
            if dir_out is not None:
                self.save_output(file_name, dir_out, coded_sp_full,
                                 lf0_full, vuv, bap_full)

        if dir_out is not None:
            self._save_norm_params(dir_out, file_id_list_name, norm_sp,
                                   norm_lf0, norm_bap)
        norm_first = norm_sp.get_params()
        if return_dict:
            return label_dict, norm_first
        return norm_first

    def import_corpus(self, features_by_id, dir_out,
                      file_id_list_name=None):
        """Write precomputed WORLD statics ``{id: (coded_sp, lf0, vuv,
        bap)}`` as a training-ready corpus: per-stream npz files and the
        statistics ``gen_data`` would write."""
        norm_sp, norm_lf0, norm_bap = self._new_extractors()
        for file_name, (coded_sp, lf0, vuv, bap) in features_by_id.items():
            coded_sp = np.atleast_2d(np.asarray(coded_sp, np.float32))
            lf0 = np.asarray(lf0, np.float32).reshape(len(coded_sp), -1)
            vuv = np.asarray(vuv, np.float32).reshape(len(coded_sp), -1)
            bap = np.asarray(bap, np.float32).reshape(len(coded_sp), -1)
            coded_sp_full, lf0_full, bap_full = self._full_streams(
                coded_sp, lf0, bap)
            norm_sp.add_sample(coded_sp_full)
            norm_lf0.add_sample(lf0_full)
            norm_bap.add_sample(bap_full)
            self.save_output(file_name, dir_out, coded_sp_full, lf0_full,
                             vuv, bap_full)
        self._save_norm_params(dir_out, file_id_list_name, norm_sp,
                               norm_lf0, norm_bap)

    def _extract_corpus(self, dir_in, id_list, file_ext):
        """Yield ``(id, (coded_sp, lf0, vuv, bap), fs)`` per utterance.

        For mcep and mgc the analysis of utterance i+1 is enqueued on the
        device before utterance i's result is awaited and refined on the
        host."""
        if self.sp_type not in ("mcep", "mgc"):
            for file_name in id_list:
                feats, fs = self.extract_features(
                    dir_in, file_name, file_ext, self.num_coded_sps,
                    self.sp_type, self.preemphasis, self.frame_shift_ms,
                    mgc_alpha=self.mgc_alpha, device=self.device)
                yield file_name, feats, fs
            return

        from idiaptts_torch.ops.world.extract import (
            world_analysis_async, world_analysis_result)

        def dispatch(file_name):
            raw, fs = audio_io.get_raw(os.path.join(
                dir_in, "{}.{}".format(file_name, file_ext)),
                self.preemphasis)
            handle = world_analysis_async(raw, fs, self.num_coded_sps,
                                          self.frame_shift_ms,
                                          mgc_alpha=self.mgc_alpha,
                                          device=self.device)
            return file_name, handle, fs

        def finalise(pending):
            file_name, handle, fs = pending
            f0, coded_sp, bap = world_analysis_result(handle)
            lf0, vuv = WorldFeatLabelGen._lf0_vuv(f0)
            feats = WorldFeatLabelGen.trim_to_shortest(
                [coded_sp.astype(np.float32), lf0, vuv,
                 bap.astype(np.float32)])
            return file_name, feats, fs

        pending = None
        for file_name in id_list:
            current = dispatch(file_name)
            if pending is not None:
                yield finalise(pending)
            pending = current
        if pending is not None:
            yield finalise(pending)

    def save_output(self, file_name, dir_out, coded_sp_full, lf0_full, vuv,
                    bap_full):
        """Per-stream npz files; deltas under separate keys."""
        factor = 3 if self.add_deltas else 1

        def split(full, dim):
            full = full if full.ndim > 1 else full[:, None]
            return [full[:, i * dim:(i + 1) * dim] for i in range(factor)]

        streams = [
            (self.dir_coded_sps, self.sp_type,
             split(coded_sp_full, self.num_coded_sps)),
            (self.dir_lf0, self.ext_lf0, split(lf0_full, 1)),
            (self.dir_vuv, self.ext_vuv,
             [vuv if vuv.ndim > 1 else vuv[:, None]]),
            (self.dir_bap, self.ext_bap, split(bap_full, self.num_bap)),
        ]
        for subdir, ext, parts in streams:
            path = os.path.join(dir_out, subdir, file_name)
            self._save_to_npz(path, parts[0].astype(np.float32), ext)
            if self.add_deltas and ext != self.ext_vuv and len(parts) == 3:
                self._save_to_npz(path, parts[1].astype(np.float32),
                                  ext + "_deltas")
                self._save_to_npz(path, parts[2].astype(np.float32),
                                  ext + "_double_deltas")

    def _save_norm_params(self, dir_out, file_id_list_name, norm_sp,
                          norm_lf0, norm_bap):
        prefix = (file_id_list_name + "-") if file_id_list_name else ""
        streams = [(self.dir_coded_sps, norm_sp), (self.dir_lf0, norm_lf0),
                   (self.dir_bap, norm_bap)]
        if self.add_deltas:
            cmp_dir = os.path.join(dir_out, "{}_{}{}".format(
                self.dir_deltas, self.sp_type, self.num_coded_sps))
            os.makedirs(cmp_dir, exist_ok=True)
            for subdir, extractor in streams:
                extractor.save(os.path.join(cmp_dir, prefix + subdir))
        else:
            for subdir, extractor in streams:
                os.makedirs(os.path.join(dir_out, subdir), exist_ok=True)
                extractor.save(os.path.join(dir_out, subdir, prefix[:-1]
                                            if prefix else ""))


def main(argv=None):
    """Extract WORLD features of a corpus of wav files on the card (or
    ``--device cpu``): per-stream npz files and their statistics."""
    import argparse
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("-a", "--dir_audio", required=True)
    parser.add_argument("-o", "--dir_out", required=True)
    parser.add_argument("-i", "--file_id_list", default=None)
    parser.add_argument("--num_coded_sps", type=int, default=60)
    parser.add_argument("--sp_type", default="mcep")
    parser.add_argument("--add_deltas", action="store_true")
    parser.add_argument("--frame_shift_ms", type=float, default=5.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    id_list = None
    if args.file_id_list:
        with open(args.file_id_list) as f:
            id_list = [line.strip() for line in f if line.strip()]
    gen = WorldFeatLabelGen(dir_labels=args.dir_out,
                            add_deltas=args.add_deltas,
                            num_coded_sps=args.num_coded_sps,
                            sp_type=args.sp_type,
                            frame_shift_ms=args.frame_shift_ms,
                            device=args.device)
    gen.gen_data(args.dir_audio, dir_out=args.dir_out,
                 file_id_list=args.file_id_list or "", id_list=id_list)


if __name__ == "__main__":
    main()
