"""Acoustic model trainer: linguistic questions -> WORLD features.  The
training half of ``idiaptts_tpu/train/acoustic.py``.

Questions in, cmp features (coded sp, lf0, vuv and bap with deltas) as
the target, the Interspeech'18 model ``RNNDYN-2_RELU_1024-3_BiLSTM_512-
1_FC_<dim>`` by default, masked MSE per frame as the loss.  Scoring
(``compute_score``: MCD, F0-RMSE, VDE, BAP) and synthesis wait for the
metrics and synthesiser modules (ROADMAP.md queue 1 item 9).
"""

from idiaptts_torch.data.questions import QuestionLabelGen
from idiaptts_torch.data.world_feat import WorldFeatLabelGen
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.models.rnn_dyn import convert_legacy_string
from idiaptts_torch.train.trainer import ModularTrainer


class AcousticModelTrainer(ModularTrainer):

    def __init__(self, hparams, id_list, dir_question_labels=None,
                 dir_world_features=None):
        super().__init__(hparams, id_list)
        self.dir_question_labels = dir_question_labels \
            or hparams.get("dir_question_labels")
        self.dir_world_features = dir_world_features \
            or hparams.get("world_dir")
        self.post_processing_mapping = {"pred_acoustic_features":
                                        "cmp_features"}

    @staticmethod
    def create_hparams(hparams_string=None, verbose=False):
        hparams = ExtendedHParams.create_hparams(hparams_string, verbose)
        hparams.add_hparams(
            num_questions=409,
            question_file=None,
            num_coded_sps_acoustic=None,
            metrics=["MCD", "F0 RMSE", "VDE", "BAP distortion"],
            synth_load_org_sp=False,
            synth_load_org_lf0=False,
            synth_load_org_vuv=False,
            synth_load_org_bap=False,
            synth_feature_names=None,
        )
        hparams.setattr_no_type_check("add_deltas", True)
        return hparams

    def default_data_reader_configs(self, hparams):
        input_config = QuestionLabelGen.Config(
            name="questions",
            directory=self.dir_question_labels,
            num_questions=hparams.get("num_questions", 409),
            norm_params=None)
        output_config = WorldFeatLabelGen.Config(
            name="cmp_features",
            output_names=("acoustic_features",),
            directory=self.dir_world_features,
            add_deltas=hparams.get("add_deltas", True),
            num_coded_sps=hparams.get("num_coded_sps", 60),
            sp_type=hparams.get("sp_type", "mcep"),
            match_length="questions")
        input_config.match_length = ("acoustic_features",)
        return [input_config, output_config]

    def default_model_config(self, hparams, dim_in, dim_out):
        cfg = convert_legacy_string(
            "RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_{}".format(dim_out),
            dim_in, dropout=hparams.get("dropout", 0.0)
            if "dropout" in hparams else 0.0)
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred_acoustic_features",)
        return cfg

    def default_loss_configs(self, hparams):
        return [NamedLoss.Config(
            "mse", "MSELoss",
            ("pred_acoustic_features", "acoustic_features"),
            seq_mask="_seq_mask", reduction="mean_per_frame")]

    def init(self, hparams, model_config=None, loss_configs=None,
             data_reader_configs=None):
        if data_reader_configs is None:
            data_reader_configs = self.default_data_reader_configs(hparams)
        self.data_reader_configs = data_reader_configs
        self._setup_datareaders(hparams)
        self._setup_datasets(hparams)
        if model_config is None \
                and not hparams.get("load_from_checkpoint"):
            example = self._example_batch(hparams)
            dim_in = example["questions"].shape[-1]
            dim_out = example["acoustic_features"].shape[-1]
            model_config = self.default_model_config(hparams, dim_in,
                                                     dim_out)
        if loss_configs is None:
            loss_configs = self.default_loss_configs(hparams)
        return super().init(hparams, model_config, loss_configs,
                            data_reader_configs)
