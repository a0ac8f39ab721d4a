"""Monophone encoder-decoder acoustic model trainer: the port of
``idiaptts_tpu/train/enc_dec_trainer.py``.

One-hot monophones in, the duration-derived fixed attention matrix
(``PhonemeDurationLabelGen(load_as_matrix=True)``), WORLD features as
the target, :class:`~idiaptts_torch.models.enc_dec.EncDecDyn` (encoder
256-256, two frames a decoder step) by default.  The datasets append an
end-of-utterance gate target (1 at the last frame) to every sample; the
loss is the masked MSE of the features plus the gate's ``BCELoss``.
"""

import numpy as np

from idiaptts_torch.data.phonemes import (PhonemeDurationLabelGen,
                                          PhonemeLabelGen)
from idiaptts_torch.data.world_feat import WorldFeatLabelGen
from idiaptts_torch.models.enc_dec import EncDecDyn
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.train.acoustic import AcousticModelTrainer
from idiaptts_torch.train.trainer import ModularTrainer


class EncDecMonophoneModelTrainer(AcousticModelTrainer):

    def __init__(self, hparams, id_list, dir_phoneme_labels=None,
                 dir_durations=None, dir_world_features=None,
                 file_symbol_dict=None):
        super().__init__(hparams, id_list,
                         dir_world_features=dir_world_features)
        self.dir_phoneme_labels = dir_phoneme_labels
        self.dir_durations = dir_durations
        self.file_symbol_dict = file_symbol_dict
        self.post_processing_mapping = {"pred_acoustic_features":
                                        "cmp_features"}

    @staticmethod
    def create_hparams(hparams_string=None, verbose=False):
        hparams = AcousticModelTrainer.create_hparams(hparams_string,
                                                      verbose)
        hparams.add_hparams(
            n_frames_per_step=2,
            label_type="mono_no_align",
        )
        return hparams

    def default_data_reader_configs(self, hparams):
        phoneme_config = PhonemeLabelGen.Config(
            name="phonemes", directory=self.dir_phoneme_labels,
            file_symbol_dict=self.file_symbol_dict,
            label_type=hparams.get("label_type", "mono_no_align"),
            one_hot=True)
        attention_config = PhonemeDurationLabelGen.Config(
            name="attention_matrix", directory=self.dir_durations,
            load_as_matrix=True, match_length=("acoustic_features",))
        output_config = WorldFeatLabelGen.Config(
            name="cmp_features", output_names=("acoustic_features",),
            directory=self.dir_world_features,
            add_deltas=hparams.get("add_deltas", True),
            num_coded_sps=hparams.get("num_coded_sps", 60),
            sp_type=hparams.get("sp_type", "mcep"),
            match_length=("attention_matrix",),
            device=hparams.get("device", "cuda"))
        return [phoneme_config, attention_config, output_config]

    def default_model_config(self, hparams, dim_in, dim_out):
        return EncDecDyn.Config(
            input_names=("phonemes",),
            output_names=("pred_acoustic_features", "pred_gate"),
            encoder_units=(256, 256), out_dim=dim_out,
            n_frames_per_step=hparams.get("n_frames_per_step", 2),
            attention_name="attention_matrix",
            target_name="acoustic_features", in_dim=dim_in)

    def default_loss_configs(self, hparams):
        return [
            NamedLoss.Config(
                "mse", "MSELoss",
                ("pred_acoustic_features", "acoustic_features"),
                seq_mask="_seq_mask:acoustic_features",
                reduction="mean_per_frame"),
            NamedLoss.Config(
                "gate", "BCELoss", ("pred_gate", "gate_target"),
                seq_mask="_seq_mask:gate_target", reduction="mean",
                loss_weight=hparams.get("gate_loss_weight", 1.0)
                if "gate_loss_weight" in hparams else 1.0),
        ]

    def init(self, hparams, model_config=None, loss_configs=None,
             data_reader_configs=None):
        if data_reader_configs is None:
            data_reader_configs = self.default_data_reader_configs(hparams)
        self.data_reader_configs = data_reader_configs
        self._setup_datareaders(hparams)
        self._setup_datasets(hparams)
        for dataset in (self.dataset_train, self.dataset_val,
                        self.dataset_test):
            if dataset is not None:
                _attach_gate_target(dataset)
        if model_config is None:
            example = self._example_batch(hparams)
            model_config = self.default_model_config(
                hparams, example["phonemes"].shape[-1],
                example["acoustic_features"].shape[-1])
        if loss_configs is None:
            loss_configs = self.default_loss_configs(hparams)
        # The datasets (with the gate target) are set up: the base init
        # must not build them again.
        return ModularTrainer.init(self, hparams, model_config,
                                   loss_configs, None)


def _attach_gate_target(dataset):
    """Wrap ``get_id_name`` to append the end-of-utterance gate target
    (1 at the last frame of the acoustic features)."""
    original = dataset.get_id_name

    def with_gate(id_name):
        output, ds = original(id_name)
        if "acoustic_features" in output:
            gate = np.zeros((len(output["acoustic_features"]), 1),
                            np.float32)
            gate[-1] = 1.0
            output["gate_target"] = gate
        return output, ds

    dataset.get_id_name = with_gate
