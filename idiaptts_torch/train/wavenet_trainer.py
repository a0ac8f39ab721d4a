"""WaveNet vocoder trainer: the port of
``idiaptts_tpu/train/wavenet_trainer.py``.

WORLD features (20 mel-cepstra, lf0, vuv and bap by default, no deltas)
are linearly upsampled to the sample rate as the conditioning
(``sample_linearly``); the targets are µ-law quantised waveforms.  Both
readers crop a random window of ``max_input_train_sec`` (0.5 s) and
match their lengths.  The loss is the masked cross-entropy of the
teacher-forced logits; the scheduler is Noam with 4000 warm-up steps.

Training runs the teacher-forced network
(:meth:`idiaptts_torch.models.wavenet.WaveNetWrapper.forward`) with
autograd, in plain PyTorch: the JAX package trains through XLA
convolutions, with no Pallas kernel.  ``gen_waveform`` draws
autoregressively through :func:`idiaptts_torch.models.wavenet.generate`:
the hand sampler kernel (K8) on the card.  ``save_for_vocoding`` writes
a checkpoint that :meth:`WaveNetVocoder.load` reads back.
"""

import logging
import os

import numpy as np

from idiaptts_torch.data.audio_gen import RawWaveformLabelGen
from idiaptts_torch.data.world_feat import WorldFeatLabelGen
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.models.wavenet import WaveNetWrapper, generate
from idiaptts_torch.ops.interpolation import sample_linearly
from idiaptts_torch.synth.synthesiser import Synthesiser
from idiaptts_torch.train.trainer import ModularTrainer

logger = logging.getLogger(__name__)


class WaveNetVocoderTrainer(ModularTrainer):

    def __init__(self, hparams, id_list, dir_world_features=None,
                 dir_audio=None):
        super().__init__(hparams, id_list)
        self.dir_world_features = dir_world_features
        self.dir_audio = dir_audio

    @staticmethod
    def create_hparams(hparams_string=None, verbose=False):
        hparams = ExtendedHParams.create_hparams(hparams_string, verbose)
        hparams.add_hparams(
            mu=255,
            frame_rate_output_hz=16000,
            max_input_train_sec=0.5,
            max_input_test_sec=1.0,
            num_coded_sps_cond=20,
            cond_upsampling="linear",
        )
        hparams.scheduler_type = "Noam"
        hparams.scheduler_args = {"warmup_steps": 4000}
        return hparams

    def default_data_reader_configs(self, hparams):
        fs = hparams.get("frame_rate_output_hz", 16000)
        samples_per_frame = int(fs * hparams.get("frame_size_ms", 5) / 1000)
        max_frames_audio = int(hparams.get("max_input_train_sec", 0.5) * fs)
        cond_config = WorldFeatLabelGen.Config(
            name="cond_features",
            output_names=("cond_features",),
            directory=self.dir_world_features,
            add_deltas=False,
            num_coded_sps=hparams.get("num_coded_sps_cond", 20),
            sp_type=hparams.get("sp_type", "mcep"),
            preprocessing_fn=lambda feats: sample_linearly(
                feats, samples_per_frame),
            preprocess_before_norm=False,
            max_frames=max_frames_audio,
            match_length=("target_quantised",),
            device=hparams.get("device", "cuda"))
        raw_config = RawWaveformLabelGen.Config(
            name="target_quantised", dir_audio=self.dir_audio,
            frame_rate_output_hz=fs, mu=hparams.get("mu", 255),
            match_length=("cond_features",),
            max_frames=max_frames_audio)
        return [cond_config, raw_config]

    def default_model_config(self, hparams, cond_dim):
        """``WaveNetWrapper.Config``'s defaults (20 layers, 64 residual
        channels, 256 classes) over ``cond_dim`` conditioning columns."""
        return WaveNetWrapper.Config(
            input_names=("cond_features",),
            output_names=("pred_logits",),
            target_name="target_quantised",
            out_channels=hparams.get("mu", 255) + 1,
            cond_channels=int(cond_dim))

    def init(self, hparams, model_config=None, loss_configs=None,
             data_reader_configs=None):
        if data_reader_configs is None:
            data_reader_configs = self.default_data_reader_configs(hparams)
        self.data_reader_configs = data_reader_configs
        self._setup_datareaders(hparams)
        self._setup_datasets(hparams)
        if model_config is None:
            example = self._example_batch(hparams)
            model_config = self.default_model_config(
                hparams, example["cond_features"].shape[-1])
        if loss_configs is None:
            loss_configs = [NamedLoss.Config(
                "ce", "CrossEntropyLoss",
                ("pred_logits", "target_quantised"),
                seq_mask="_seq_mask", reduction="mean")]
        return super().init(hparams, model_config, loss_configs,
                            data_reader_configs)

    def gen_waveform(self, hparams, results):
        """Autoregressive generation from each utterance's conditioning
        (the sampler kernel on the card), written as wav files."""
        config = self.model_handler.model_config
        synth_output = {
            id_name: generate(self.model_handler.model, config,
                              np.asarray(sample["cond_features"]))
            for id_name, sample in results.items()}
        return Synthesiser.run_raw_synth(synth_output, hparams)

    def save_for_vocoding(self, hparams, filename):
        """A standalone vocoder: the checkpoint (``config.json`` and
        ``params_last`` under ``<dir>/<name>/<networks_dir>``, what
        :meth:`WaveNetVocoder.load` reads) plus the conditioning reader's
        normalisation parameters as ``<filename>_norm_params.npy``."""
        directory = os.path.dirname(filename) or "."
        self.model_handler.save_checkpoint(
            directory, model_name=os.path.basename(filename), last=True,
            networks_dir=hparams.get("networks_dir", "nn"))
        norm = getattr(self.datareaders.get("cond_features"), "norm_params",
                       None)
        if norm is not None:
            np.save(filename + "_norm_params",
                    np.concatenate([np.asarray(p).reshape(1, -1)
                                    if np.ndim(p) == 1 else np.asarray(p)
                                    for p in norm], axis=0))
        return filename

    def compute_score(self, hparams, results):
        """Teacher-forced accuracy of the µ-law class prediction."""
        accs = []
        for sample in results.values():
            logits = np.asarray(sample["pred_logits"])
            target = np.asarray(sample["target_quantised"]).reshape(-1)
            n = min(len(logits), len(target))
            pred = np.argmax(logits[:n], axis=-1).reshape(-1)
            accs.append((pred[:n] == target[:n].astype(np.int64)).mean())
        acc = float(np.mean(accs))
        logger.info("Teacher-forced mu-law accuracy: %.4f", acc)
        return acc
