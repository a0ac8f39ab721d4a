"""GCR atom intonation trainers: the port of
``idiaptts_tpu/train/atom_trainers.py``.

- :class:`AtomModelTrainer`: questions -> atom amplitude spikes, one
  output per theta; ``compute_score`` rebuilds the LF0 from the
  predicted atoms (plus the phrase curve) and gives F0-RMSE and VDE.
- :class:`AtomVUVDistPosModelTrainer`: adds the VUV flag and the smeared
  position flag; its VDE reads the predicted VUV column.
- :class:`AtomNeuralFilterModelTrainer`: end-to-end LF0 through the
  trainable intonation filters over a pre-trained atom model
  (``init_atom``/``train_atom``, then the composed model).
- :class:`PhraseAtomNeuralFilterModelTrainer`: adds the phrase filter,
  seeded from the flat model (``init_flat``/``train_flat``), trained on
  the full LF0 track.

A sub-trainer's weights are adopted by a ``state_dict`` copy into the
composed model's submodule (``atom_model``, ``neural_filters``), every
tensor cloned, so the two trainers never share storage; the composed
trainer's optimiser state starts afresh.  The default atom model is
``RNNDYN-2_RELU_1024-1_BiLSTM_512-1_FC_<dim>``: its BiLSTM layer runs
the hand kernels on the card.  Figures go through
:class:`idiaptts_torch.utils.plotter.DataPlotter`.
"""

import logging

import numpy as np
import torch

from idiaptts_torch.data.atoms import AtomLabelGen, AtomVUVDistPosLabelGen
from idiaptts_torch.data.questions import QuestionLabelGen
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models.intonation import (NeuralFilters,
                                              PhraseNeuralFilters)
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.models.rnn_dyn import convert_legacy_string
from idiaptts_torch.synth.metrics import Metrics
from idiaptts_torch.train.trainer import ModularTrainer, _figure_path

logger = logging.getLogger(__name__)


class AtomModelTrainer(ModularTrainer):
    """Questions -> atom amplitude spikes (one output per theta)."""

    def __init__(self, hparams, id_list, dir_question_labels=None,
                 dir_atom_labels=None, dir_world_features=None):
        super().__init__(hparams, id_list)
        self.dir_question_labels = dir_question_labels
        self.dir_atom_labels = dir_atom_labels
        self.dir_world_features = dir_world_features
        # Postprocessing (denorm + peak identification) happens
        # explicitly in compute_score — the network emits plain
        # normalised amplitudes.
        self.post_processing_mapping = {}

    @staticmethod
    def create_hparams(hparams_string=None, verbose=False):
        hparams = ExtendedHParams.create_hparams(hparams_string, verbose)
        hparams.add_hparams(
            num_questions=409,
            thetas=[0.03, 0.06, 0.09, 0.12, 0.15],
            k=6,
            min_atom_amp=0.3,
            metrics=[Metrics.F0_RMSE, Metrics.VDE],
        )
        return hparams

    def default_data_reader_configs(self, hparams):
        input_config = QuestionLabelGen.Config(
            name="questions", directory=self.dir_question_labels,
            num_questions=hparams.get("num_questions"),
            match_length=("atoms",))
        atom_config = AtomLabelGen.Config(
            name="atoms", directory=self.dir_atom_labels,
            thetas=hparams.get("thetas"), k=hparams.get("k", 6),
            match_length=("questions",))
        return [input_config, atom_config]

    def default_model_config(self, hparams, dim_in, dim_out):
        cfg = convert_legacy_string(
            "RNNDYN-2_RELU_1024-1_BiLSTM_512-1_FC_{}".format(dim_out),
            dim_in)
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred_atoms",)
        return cfg

    def init(self, hparams, model_config=None, loss_configs=None,
             data_reader_configs=None):
        if data_reader_configs is None:
            data_reader_configs = self.default_data_reader_configs(
                hparams)
        self.data_reader_configs = data_reader_configs
        self._setup_datareaders(hparams)
        self._setup_datasets(hparams)
        if model_config is None:
            example = self._example_batch(hparams)
            dim_in = example["questions"].shape[-1]
            dim_out = example["atoms"].shape[-1]
            model_config = self.default_model_config(hparams, dim_in,
                                                     dim_out)
        if loss_configs is None:
            loss_configs = [NamedLoss.Config(
                "wmse_atoms", "WeightedNonzeroMSELoss",
                ("pred_atoms", "atoms"), seq_mask="_seq_mask",
                reduction="mean_per_frame", weight_zero=0.05,
                weight_non_zero=1.0)]
        return super().init(hparams, model_config, loss_configs,
                            data_reader_configs)

    def compute_score(self, hparams, results):
        """F0 reconstruction benchmark: the LF0 rebuilt from the
        predicted atoms (plus the phrase curve) against the original
        track."""
        metric_names = hparams.get("metrics",
                                   [Metrics.F0_RMSE, Metrics.VDE])
        metrics = Metrics(metric_names)
        reader = self.datareaders["atoms"]
        for id_name, sample in results.items():
            pred = np.asarray(sample["pred_atoms"])
            labels = reader.postprocess_sample(
                pred[:, :len(reader.theta_interval)],
                identify_peaks=True)
            recon = AtomLabelGen.labels_to_lf0(
                labels, k=hparams.get("k", 6),
                amp_threshold=hparams.get("min_atom_amp", 0.3))
            try:
                phrase = reader.load_phrase(id_name)[:, 0]
                recon = recon[:len(phrase)] + phrase[:len(recon)]
            except FileNotFoundError as e:
                logger.warning(
                    "Phrase curve missing (%s): scoring the atom "
                    "reconstruction WITHOUT the phrase component — "
                    "F0 metrics will be meaningless if phrases were "
                    "part of training.", e)
            lf0, vuv = self._load_org_lf0(id_name, len(recon))
            out_vuv = (np.abs(np.asarray(
                sample["pred_atoms"])).sum(-1) > 1e-3).astype(float)
            n = min(len(recon), len(lf0))
            metrics.accumulate(id_name, Metrics.get_metrics(
                metric_names, org_lf0=lf0[:n], org_vuv=vuv[:n],
                output_lf0=recon[:n], output_vuv=out_vuv[:n]))
        metrics.log()
        return tuple(metrics.get_cum_values())

    def _load_org_lf0(self, id_name, num_frames):
        from idiaptts_torch.data.world_feat import WorldFeatLabelGen
        sample = WorldFeatLabelGen.load_sample(
            id_name, self.dir_world_features, add_deltas=False,
            load_sp=False, load_bap=False)
        return sample[:, 0], sample[:, 1]

    def gen_figure_from_output(self, id_name, sample, hparams):
        """The atom figure: the reconstructed LF0 over the original
        (centred) track on one grid, the predicted atoms with their
        gamma curves below, unvoiced frames shaded."""
        from idiaptts_torch.utils.plotter import DataPlotter
        path = _figure_path(id_name, hparams)
        reader = self.datareaders["atoms"]
        pred = np.asarray(sample["pred_atoms"])
        num_thetas = len(reader.theta_interval)
        labels = reader.postprocess_sample(pred[:, :num_thetas],
                                           identify_peaks=True)
        atoms = AtomLabelGen.labels_to_atoms(
            labels, k=hparams.get("k", 6),
            amp_threshold=hparams.get("min_atom_amp", 0.3))
        recon = AtomLabelGen.atoms_to_lf0(atoms, len(labels))
        lf0, vuv = self._load_org_lf0(id_name, len(recon))
        n = min(len(recon), len(lf0))
        frame_rate = 1000.0 / hparams.get("frame_size_ms", 5)
        with DataPlotter(plot_per_sec=frame_rate) as plotter:
            plotter.set_data_list(0, [
                (lf0[:n] - np.mean(lf0[:n][vuv[:n] > 0])
                 if (vuv[:n] > 0).any() else lf0[:n], "org lf0 (centred)"),
                (recon[:n], "reconstruction")])
            plotter.set_area_list(0, [(vuv[:n] < 0.5, "0.8", 0.4,
                                       "unvoiced")])
            plotter.set_atom_list(1, atoms)
            plotter.set_label(0, ylabel="lf0 deviation")
            plotter.set_label(1, ylabel="atoms")
            plotter.gen_plot()
            plotter.save_to_file(path)
        return path

    def gen_waveform(self, hparams, results):
        raise NotImplementedError(
            "Atom models predict intonation, not waveforms.")


class AtomVUVDistPosModelTrainer(AtomModelTrainer):
    """Adds the VUV flag and the smeared position flag to the atom
    targets."""

    def default_data_reader_configs(self, hparams):
        input_config = QuestionLabelGen.Config(
            name="questions", directory=self.dir_question_labels,
            num_questions=hparams.get("num_questions"),
            match_length=("atoms",))
        atom_config = AtomVUVDistPosLabelGen.Config(
            name="atoms", directory=self.dir_atom_labels,
            thetas=hparams.get("thetas"), k=hparams.get("k", 6),
            dir_world=self.dir_world_features,
            match_length=("questions",))
        return [input_config, atom_config]

    def compute_score(self, hparams, results):
        """Uses the predicted VUV column (last) for the VDE metric."""
        metric_names = hparams.get("metrics",
                                   [Metrics.F0_RMSE, Metrics.VDE])
        metrics = Metrics(metric_names)
        reader = self.datareaders["atoms"]
        num_thetas = len(reader.theta_interval)
        for id_name, sample in results.items():
            pred = np.asarray(sample["pred_atoms"])
            amps = pred[:, :num_thetas]
            pred_vuv = (pred[:, -1] > 0.5).astype(float)
            labels = reader.postprocess_sample(amps,
                                               identify_peaks=True)
            recon = AtomLabelGen.labels_to_lf0(
                labels, k=hparams.get("k", 6),
                amp_threshold=hparams.get("min_atom_amp", 0.3))
            try:
                phrase = reader.load_phrase(id_name)[:, 0]
                recon = recon[:len(phrase)] + phrase[:len(recon)]
            except FileNotFoundError as e:
                logger.warning(
                    "Phrase curve missing (%s): scoring the atom "
                    "reconstruction WITHOUT the phrase component — "
                    "F0 metrics will be meaningless if phrases were "
                    "part of training.", e)
            lf0, vuv = self._load_org_lf0(id_name, len(recon))
            n = min(len(recon), len(lf0))
            metrics.accumulate(id_name, Metrics.get_metrics(
                metric_names, org_lf0=lf0[:n], org_vuv=vuv[:n],
                output_lf0=recon[:n], output_vuv=pred_vuv[:n]))
        metrics.log()
        return tuple(metrics.get_cum_values())


def _adopt_submodule_params(model, prefix, donor):
    """Copy the donor model's state dict into ``model`` under the
    submodule ``prefix`` (a tuple of attribute names), cloning every
    tensor so the two models never share storage."""
    target = model
    for name in prefix:
        target = getattr(target, name)
    state = {k: v.detach().clone() for k, v in donor.state_dict().items()}
    target.load_state_dict(state, strict=True)
    return model


class AtomNeuralFilterModelTrainer(AtomVUVDistPosModelTrainer):
    """End-to-end LF0 via trainable intonation filters on top of a
    pre-trained atom model.

    Two-phase training: ``init_atom``/``train_atom`` pre-train the atom
    sub-model (its weights are adopted into the composed model), then
    the full model trains end-to-end on (flat) LF0 targets."""

    #: The atom sub-model's attribute path inside NeuralFilters.
    ATOM_SCOPE = ("atom_model",)

    def __init__(self, *args, flat_lf0=True, **kwargs):
        super().__init__(*args, **kwargs)
        self.atom_trainer = None
        # Flat targets (the phrase curve removed) by default.
        self.flat_lf0 = flat_lf0

    # -- data/model/loss defaults -----------------------------------------
    def default_data_reader_configs(self, hparams):
        from idiaptts_torch.data.lf0 import FlatLF0LabelGen, LF0LabelGen
        from idiaptts_torch.data.reader import NpzDataReader
        configs = super().default_data_reader_configs(hparams)
        for config in configs:
            config.match_length = ("lf0_vuv_target",)
        no_norm = NpzDataReader.Config.NormType.NONE
        if self.flat_lf0:
            lf0_config = FlatLF0LabelGen.Config(
                name="lf0_vuv_target",
                directory=self.dir_world_features,
                dir_phrase=self.dir_atom_labels,
                norm_type=no_norm,
                match_length=("questions", "atoms"))
        else:
            lf0_config = LF0LabelGen.Config(
                name="lf0_vuv_target",
                directory=self.dir_world_features,
                norm_type=no_norm,
                match_length=("questions", "atoms"))
        configs.append(lf0_config)
        return configs

    def build_model_config(self, hparams, atom_model_config):
        return NeuralFilters.Config(
            atom_model_config=atom_model_config,
            thetas=hparams.get("thetas"),
            complex_poles=hparams.get("complex_poles", True),
            phase_init=hparams.get("phase_init", 0.0),
            input_names=atom_model_config.input_names,
            output_names=("pred_intonation",))

    def default_loss_configs(self, hparams):
        return [NamedLoss.Config(
            "lf0_vuv", "L1WeightedVUVMSELoss",
            ("pred_intonation", "lf0_vuv_target"),
            seq_mask="_seq_mask", reduction="mean_per_frame",
            weight_unvoiced=hparams.get("weight_unvoiced", 0.5))]

    def init(self, hparams, model_config=None, loss_configs=None,
             data_reader_configs=None, atom_model_config=None):
        if data_reader_configs is None:
            data_reader_configs = self.default_data_reader_configs(
                hparams)
        if model_config is None:
            if atom_model_config is None:
                donor = getattr(self.atom_trainer, "model_handler",
                                None)
                if donor is not None and donor.model_config is not None:
                    atom_model_config = donor.model_config
                else:
                    raise ValueError(
                        "Need atom_model_config (or init_atom with an "
                        "initialised atom trainer) to build the neural"
                        " filter model.")
            model_config = self.build_model_config(hparams,
                                                   atom_model_config)
        if loss_configs is None:
            loss_configs = self.default_loss_configs(hparams)
        return ModularTrainer.init(self, hparams, model_config,
                                   loss_configs, data_reader_configs)

    # -- two-phase training -------------------------------------------------
    def init_atom(self, hparams, atom_trainer):
        """Attach the (initialised) atom sub-trainer."""
        self.atom_trainer = atom_trainer

    def train_atom(self, hparams):
        """Phase 1: pre-train the atom sub-model, then adopt its
        weights into the composed model."""
        result = self.atom_trainer.train(hparams)
        self.adopt_atom_params()
        return result

    def adopt_atom_params(self):
        self._adopt_into(self.ATOM_SCOPE,
                         self.atom_trainer.model_handler.model)

    def _adopt_into(self, scope, donor):
        """Copy the donor's weights in; a fresh optimiser state, and the
        EMA restarted from the adopted weights."""
        handler = self.model_handler
        with torch.no_grad():
            _adopt_submodule_params(handler.model, scope, donor)
        if handler.optimiser is not None:
            handler.optimiser.state.clear()
        if handler.ema is not None:
            from idiaptts_torch.train.handler import ExponentialMovingAverage
            handler.ema = ExponentialMovingAverage(handler.model,
                                                   handler.ema.decay)

    # -- benchmark ----------------------------------------------------------
    def compute_score(self, hparams, results):
        """F0 benchmark on the end-to-end LF0 output: prediction is
        [lf0, vuv, amps...]; flat models get the stored phrase curve
        added back before comparison with the original track."""
        metric_names = hparams.get("metrics",
                                   [Metrics.F0_RMSE, Metrics.VDE])
        metrics = Metrics(metric_names)
        reader = self.datareaders["atoms"]
        output_name = \
            self.model_handler.model_config.output_names[0]
        for id_name, sample in results.items():
            pred = np.asarray(sample[output_name])
            lf0_pred = pred[:, 0]
            vuv_pred = (pred[:, 1] > 0.5).astype(float)
            if self.flat_lf0:
                try:
                    phrase = reader.load_phrase(id_name)[:, 0]
                    n = min(len(lf0_pred), len(phrase))
                    lf0_pred = lf0_pred[:n] + phrase[:n]
                except FileNotFoundError:
                    pass
            lf0, vuv = self._load_org_lf0(id_name, len(lf0_pred))
            n = min(len(lf0_pred), len(lf0))
            metrics.accumulate(id_name, Metrics.get_metrics(
                metric_names, org_lf0=lf0[:n], org_vuv=vuv[:n],
                output_lf0=lf0_pred[:n], output_vuv=vuv_pred[:n]))
        metrics.log()
        return tuple(metrics.get_cum_values())


class PhraseAtomNeuralFilterModelTrainer(AtomNeuralFilterModelTrainer):
    """Adds the phrase-bias filter; the flat model's weights seed the
    phrase model, which then trains end-to-end on the full LF0 track
    (two-phase ``init_flat``/``train_flat``)."""

    #: The flat NeuralFilters model's attribute path inside
    #: PhraseNeuralFilters.
    FLAT_SCOPE = ("neural_filters",)

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("flat_lf0", False)  # trains on full LF0
        super().__init__(*args, **kwargs)
        self.flat_trainer = None

    def init_flat(self, hparams, flat_trainer):
        """Attach the flat (phrase-less) sub-trainer."""
        self.flat_trainer = flat_trainer

    def train_flat(self, hparams):
        """Phase 2: train the flat model on flat-LF0 targets, then
        adopt its weights into the phrase model."""
        result = self.flat_trainer.train(hparams)
        self.adopt_flat_params()
        return result

    def train_atom(self, hparams):
        """Phase 1 delegates to the flat trainer's atom stage."""
        result = self.flat_trainer.train_atom(hparams)
        self.adopt_flat_params()
        return result

    def adopt_flat_params(self):
        self._adopt_into(self.FLAT_SCOPE,
                         self.flat_trainer.model_handler.model)

    def init(self, hparams, model_config=None, loss_configs=None,
             data_reader_configs=None, atom_model_config=None):
        if atom_model_config is None and model_config is None \
                and self.flat_trainer is not None \
                and self.flat_trainer.atom_trainer is not None:
            atom_model_config = self.flat_trainer.atom_trainer \
                .model_handler.model_config
        return super().init(hparams, model_config, loss_configs,
                            data_reader_configs, atom_model_config)

    def build_model_config(self, hparams, atom_model_config):
        nf_config = super().build_model_config(hparams,
                                               atom_model_config)
        return PhraseNeuralFilters.Config(
            neural_filters_config=nf_config,
            phrase_theta_init=hparams.get("phrase_theta_init", 0.05),
            phrase_bias_init=hparams.get("phrase_bias_init", 4.5),
            input_names=nf_config.input_names,
            output_names=("pred_intonation_phrase",))

    def default_loss_configs(self, hparams):
        return [NamedLoss.Config(
            "lf0_vuv_phrase", "L1WeightedVUVMSELoss",
            ("pred_intonation_phrase", "lf0_vuv_target"),
            seq_mask="_seq_mask", reduction="mean_per_frame",
            weight_unvoiced=hparams.get("weight_unvoiced", 0.5))]
