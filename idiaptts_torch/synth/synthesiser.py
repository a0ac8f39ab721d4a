"""Synthesiser: the port of ``idiaptts_tpu/synth/synthesiser.py``.

``run_world_synth`` takes post-processed WORLD statics per utterance
(``[coded_sp | lf0 | vuv | bap]``, cepstral ``sp_type`` mcep or mgc) and
vocodes them all in one padded batch through
:class:`~idiaptts_torch.synth.pipeline.BatchedWorldSynth` on
``hparams.device`` (one instance cached per configuration and device),
writing one wav file per utterance.  ``copy_synth`` does the same from
the original features (WORLD) or copies the original audio (raw and
WaveNet vocoders).

``run_r9y9wavenet_mulaw_world_feats_synth`` takes WORLD frame features
per utterance, applies the optional Merlin post-filter to the coded
spectrum, upsamples the features to the sample rate and vocodes every
utterance in one padded batch through :class:`WaveNetVocoder` (one
sampler launch on the card), writing one wav file per utterance cut to
its length.  Not ported yet (ROADMAP.md queue 1 item 10): Griffin-Lim
and the non-cepstral ``sp_type`` codings (mfbanks, amp_sp), which need
the STFT ops.
"""

import logging
import os

import numpy as np
import torch

from idiaptts_torch.data.world_feat import WorldFeatLabelGen
from idiaptts_torch.models.wavenet import WaveNetVocoder
from idiaptts_torch.ops import audio_io
from idiaptts_torch.ops import mcep as mcep_ops
from idiaptts_torch.ops.interpolation import sample_linearly
from idiaptts_torch.synth.pipeline import BatchedWorldSynth

logger = logging.getLogger(__name__)

_LATER_STFT = ("is not ported yet; ROADMAP.md queue 1 item 10 (STFT and "
               "feature extraction ops) ports it")


class Synthesiser:

    @staticmethod
    def _out_path(id_name, hparams, suffix=""):
        out_dir = hparams.get("synth_dir") or os.path.join(
            hparams.get("out_dir") or ".", "synth")
        os.makedirs(out_dir, exist_ok=True)
        ext = hparams.get("synth_ext", "wav")
        suffix += hparams.get("synth_file_suffix") or ""
        return os.path.join(out_dir, "{}{}.{}".format(id_name, suffix,
                                                      ext))

    @staticmethod
    def run_world_synth(synth_output, hparams, epoch=None,
                        use_model_name=True):
        """{id: [coded_sp, lf0, vuv, bap] statics} -> wav files, vocoded
        in one padded batch on ``hparams.device``."""
        fs = hparams.get("synth_fs", 16000)
        num_coded_sps = hparams.get("num_coded_sps", 60)
        num_bap = hparams.get("num_bap", 1)
        sp_type = hparams.get("sp_type", "mcep")
        if sp_type not in ("mcep", "mgc"):
            raise NotImplementedError(
                "WORLD synthesis of sp_type {} ".format(sp_type)
                + _LATER_STFT)
        synth = Synthesiser._batched_world_synth(
            num_coded_sps, fs, hparams.get("frame_size_ms", 5), num_bap,
            bool(hparams.get("do_post_filtering")), hparams.get("mgc_alpha"),
            hparams.get("device", "cuda"))
        ids = list(synth_output)
        samples = [np.asarray(synth_output[i], np.float32)[
            :, :num_coded_sps + 2 + num_bap] for i in ids]
        wavs = synth(samples)
        suffix = "_e{}".format(epoch) if epoch is not None else ""
        if use_model_name and hparams.get("model_name"):
            suffix += "_" + str(hparams.model_name)
        paths = {}
        for id_name, raw in zip(ids, wavs):
            path = Synthesiser._out_path(id_name, hparams, suffix)
            audio_io.raw_to_file(path, _norm_loudness(raw), fs)
            logger.info("Wrote %s", path)
            paths[id_name] = path
        return paths

    _world_synth_cache = {}

    @staticmethod
    def _batched_world_synth(num_coded_sps, fs, frame_size_ms, num_bap,
                             post_filter, mgc_alpha=None, device="cuda"):
        key = (num_coded_sps, fs, frame_size_ms, num_bap, post_filter,
               mgc_alpha, str(device))
        cache = Synthesiser._world_synth_cache
        if key not in cache:
            cache[key] = BatchedWorldSynth(
                num_coded_sps, fs, frame_size_ms, num_bap=num_bap,
                post_filter=post_filter, mgc_alpha=mgc_alpha, device=device)
        return cache[key]

    @staticmethod
    def run_raw_synth(synth_output, hparams, epoch=None):
        """{id: waveform} -> wav files."""
        fs = hparams.get("synth_fs", 16000)
        paths = {}
        for id_name, raw in synth_output.items():
            path = Synthesiser._out_path(id_name, hparams)
            audio_io.raw_to_file(path, _norm_loudness(np.squeeze(raw)),
                                 fs)
            paths[id_name] = path
        return paths

    @staticmethod
    def raw_to_file(id_name, raw, hparams):
        path = Synthesiser._out_path(id_name, hparams)
        return audio_io.raw_to_file(path, _norm_loudness(raw),
                                    hparams.get("synth_fs", 16000))

    @staticmethod
    def run_griffin_lim(synth_output, hparams, epoch=None, on_log=False):
        raise NotImplementedError("Griffin-Lim synthesis " + _LATER_STFT)

    @staticmethod
    def run_wavenet_vocoder(synth_output, hparams, epoch=None):
        """{id: sample-rate conditioning (T, C)} -> wav files through the
        WaveNet checkpoint at ``hparams.synth_vocoder_path`` (added with
        ``hparams.add_hparams``), on ``hparams.device``.  All utterances
        are padded into one batch; each output is cut to its length."""
        vocoder = WaveNetVocoder.load(hparams.synth_vocoder_path, hparams)
        fs = hparams.get("synth_fs", 16000)
        ids = list(synth_output.keys())
        conds = [np.asarray(synth_output[i], np.float32) for i in ids]
        lengths = [len(c) for c in conds]
        t_max = max(lengths)
        batch = np.stack([np.pad(c, ((0, t_max - len(c)), (0, 0)))
                          for c in conds])
        raws = vocoder.generate(torch.from_numpy(batch))
        paths = {}
        for id_name, raw, length in zip(ids, raws, lengths):
            path = Synthesiser._out_path(id_name, hparams)
            audio_io.raw_to_file(path, _norm_loudness(raw[:length]), fs)
            logger.info("Wrote %s", path)
            paths[id_name] = path
        return paths

    @staticmethod
    def run_r9y9wavenet_mulaw_world_feats_synth(synth_output, hparams,
                                                epoch=None):
        """WaveNet vocoder conditioned on WORLD frame features
        {id: (frames, num_coded_sps + 3)}: the optional Merlin post-filter
        on the coded spectrum, frame -> sample-rate linear upsampling,
        then :meth:`run_wavenet_vocoder`."""
        fs = hparams.get("synth_fs", 16000)
        num_coded_sps = hparams.get("num_coded_sps", 60)
        samples_per_frame = int(
            fs * hparams.get("frame_size_ms",
                             hparams.get("frame_shift_ms", 5.0))
            / 1000.0)
        out = {}
        for id_name, feats in synth_output.items():
            feats = np.asarray(feats)
            if hparams.get("do_post_filtering"):
                sp, lf0, vuv, bap = \
                    WorldFeatLabelGen.convert_to_world_features(
                        feats, contains_deltas=False,
                        num_coded_sps=num_coded_sps)
                sp = mcep_ops.merlin_post_filter(
                    torch.from_numpy(np.ascontiguousarray(
                        sp, dtype=np.float32)),
                    mcep_ops.fs_to_mgc_alpha(fs)).numpy()
                feats = WorldFeatLabelGen.convert_from_world_features(
                    sp, lf0, vuv, bap)
            out[id_name] = sample_linearly(feats, samples_per_frame)
        return Synthesiser.run_wavenet_vocoder(out, hparams, epoch=epoch)

    @staticmethod
    def copy_synth(hparams, file_id_list, epoch=None, feature_dir=None):
        """Audio with only the vocoder's degradation: synthesise the
        original WORLD features (plain, or statics of the with-deltas
        files), or, for the raw and WaveNet vocoders, write the original
        audio ``feature_dir/<id>.wav`` resampled to the output rate."""
        vocoder = hparams.get("synth_vocoder", "WORLD")
        num_coded_sps = hparams.get("num_coded_sps", 60)
        sp_type = hparams.get("sp_type", "mcep")
        synth_dict = {}
        if vocoder == "WORLD":
            for id_name in file_id_list:
                try:
                    output = WorldFeatLabelGen.load_sample(
                        id_name, feature_dir, num_coded_sps=num_coded_sps,
                        sp_type=sp_type)
                except FileNotFoundError:
                    with_deltas = WorldFeatLabelGen.load_sample(
                        id_name, feature_dir, add_deltas=True,
                        num_coded_sps=num_coded_sps, sp_type=sp_type)
                    output = WorldFeatLabelGen.convert_from_world_features(
                        *WorldFeatLabelGen.convert_to_world_features(
                            with_deltas, contains_deltas=True,
                            num_coded_sps=num_coded_sps))
                synth_dict[id_name] = output
            return Synthesiser.run_world_synth(
                synth_dict, hparams, epoch=epoch, use_model_name=False)
        if vocoder == "raw" or vocoder.startswith("r9y9wavenet") \
                or vocoder == "wavenet":
            fs_out = hparams.get("frame_rate_output_Hz",
                                 hparams.get("synth_fs", 16000))
            for id_name in file_id_list:
                raw, fs = audio_io.get_raw(os.path.join(
                    feature_dir, id_name + ".wav"))
                synth_dict[id_name] = audio_io.resample(raw, fs, fs_out)
            return Synthesiser.run_raw_synth(synth_dict, hparams,
                                             epoch=epoch)
        raise NotImplementedError("Unknown vocoder " + vocoder)


def _norm_loudness(raw, peak=0.85):
    raw = np.asarray(raw, np.float32)
    max_abs = np.abs(raw).max()
    if max_abs > peak:
        raw = raw / max_abs * peak
    return raw
