"""Duration model trainer: linguistic features -> 5-state durations.  The
port of ``idiaptts_tpu/train/duration.py``.

Phone-level questions in, per-phone 5-state durations (frames,
normalised by their mean and standard deviation) as the target, the
model ``RNNDYN-3_RELU_512-1_FC_<n>`` by default, masked MSE per frame as
the loss.  ``benchmark`` scores the duration RMSE and Pearson
correlation; ``forward`` denormalises and rounds the predictions to
whole frames, floored at 0.

The model is Dense only: its products are bf16 GEMMs on the card, as
the port's other Dense layers are.  Everything runs on
``hparams.device`` (``"cuda"`` unless set to ``"cpu"``).
"""

import numpy as np

from idiaptts_torch.data.phonemes import PhonemeDurationLabelGen
from idiaptts_torch.data.questions import QuestionLabelGen
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.models.rnn_dyn import convert_legacy_string
from idiaptts_torch.synth.metrics import Metrics
from idiaptts_torch.train.trainer import ModularTrainer


class DurationModelTrainer(ModularTrainer):

    def __init__(self, hparams, id_list, dir_phoneme_labels=None,
                 dir_durations=None):
        super().__init__(hparams, id_list)
        self.dir_phoneme_labels = dir_phoneme_labels
        self.dir_durations = dir_durations
        self.post_processing_mapping = {"pred_durations": "durations"}

    @staticmethod
    def create_hparams(hparams_string=None, verbose=False):
        hparams = ExtendedHParams.create_hparams(hparams_string, verbose)
        hparams.add_hparams(
            num_questions=609,
            min_phoneme_length=50000,
            metrics=[Metrics.Dur_RMSE, Metrics.Dur_pearson],
        )
        return hparams

    def default_data_reader_configs(self, hparams):
        input_config = QuestionLabelGen.Config(
            name="questions", directory=self.dir_phoneme_labels,
            num_questions=hparams.get("num_questions"),
            match_length=("durations",))
        output_config = PhonemeDurationLabelGen.Config(
            name="durations", directory=self.dir_durations,
            match_length=("questions",))
        return [input_config, output_config]

    def default_model_config(self, hparams, dim_in, dim_out=5):
        cfg = convert_legacy_string(
            "RNNDYN-3_RELU_512-1_FC_{}".format(dim_out), dim_in)
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred_durations",)
        return cfg

    def init(self, hparams, model_config=None, loss_configs=None,
             data_reader_configs=None):
        if data_reader_configs is None:
            data_reader_configs = self.default_data_reader_configs(hparams)
        self.data_reader_configs = data_reader_configs
        self._setup_datareaders(hparams)
        self._setup_datasets(hparams)
        if model_config is None \
                and not hparams.get("load_from_checkpoint"):
            # A strict checkpoint load rebuilds the model from its saved
            # config.json and needs no example batch.
            example = self._example_batch(hparams)
            dim_in = example["questions"].shape[-1]
            dim_out = example["durations"].shape[-1]
            model_config = self.default_model_config(hparams, dim_in,
                                                     dim_out)
        if loss_configs is None:
            loss_configs = [NamedLoss.Config(
                "mse", "MSELoss", ("pred_durations", "durations"),
                seq_mask="_seq_mask", reduction="mean_per_frame")]
        return super().init(hparams, model_config, loss_configs,
                            data_reader_configs)

    def compute_score(self, hparams, results):
        metric_names = hparams.get("metrics",
                                   [Metrics.Dur_RMSE, Metrics.Dur_pearson])
        metrics = Metrics(metric_names)
        reader = self.datareaders["durations"]
        for id_name, sample in results.items():
            pred = np.asarray(sample["pred_durations"])
            org = reader.load(id_name)
            n = min(len(pred), len(org))
            metrics.accumulate(id_name, Metrics.get_metrics(
                metric_names, org_dur=org[:n], output_dur=pred[:n]))
        metrics.log()
        return tuple(metrics.get_cum_values())

    def forward(self, hparams, id_list):
        """Predicted durations per state in frames: denormalised, rounded
        and floored at 0 -> {id: (P, 5) int64}."""
        results = super().forward(hparams, id_list)
        out = {}
        for id_name, sample in results.items():
            dur = np.asarray(sample["pred_durations"])
            out[id_name] = np.maximum(np.round(dur), 0.0).astype(np.int64)
        return out

    def gen_waveform(self, hparams, results):
        raise NotImplementedError(
            "Duration models do not synthesise waveforms.")
