"""Acoustic model trainer: linguistic questions -> WORLD features.  The
port of ``idiaptts_tpu/train/acoustic.py``.

Questions in, cmp features (coded sp, lf0, vuv and bap with deltas) as
the target, the Interspeech'18 model ``RNNDYN-2_RELU_1024-3_BiLSTM_512-
1_FC_<dim>`` by default, masked MSE per frame as the loss.

- ``benchmark`` scores MCD, F0-RMSE, VDE and BAP distortion of the
  post-processed (MLPG-smoothed) predictions against the original WORLD
  features (``compute_score``).
- ``synth`` takes the fused path (:class:`FusedAcousticPipeline`: model,
  denormalisation, batch MLPG and vocoder on the device) when
  ``use_fused_synth`` is set, the vocoder is WORLD and no stream is
  overridden; otherwise the modular path (forward, per-utterance MLPG,
  ``Synthesiser``).  The choice is made from the hparams alone: a
  failure on either path raises.
- ``serve`` puts a ``SynthesisServer`` over the fused pipeline.

Everything runs on ``hparams.device`` (``"cuda"`` unless set to
``"cpu"``).  Griffin-Lim raises (ROADMAP.md queue 1 item 10).
"""

import numpy as np
import torch

from idiaptts_torch.data.questions import QuestionLabelGen
from idiaptts_torch.data.world_feat import WorldFeatLabelGen
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.models.rnn_dyn import convert_legacy_string
from idiaptts_torch.ops import audio_io
from idiaptts_torch.ops import mcep as mcep_ops
from idiaptts_torch.synth.metrics import Metrics
from idiaptts_torch.synth.pipeline import FusedAcousticPipeline
from idiaptts_torch.synth.server import SynthesisServer
from idiaptts_torch.synth.synthesiser import Synthesiser
from idiaptts_torch.train.trainer import ModularTrainer

_STREAMS = ("sp", "lf0", "vuv", "bap")


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
            metrics=[Metrics.MCD, Metrics.F0_RMSE, Metrics.VDE,
                     Metrics.BAP_distortion],
            # The fused path (one pipeline for model, MLPG and vocoder)
            # in synth.
            use_fused_synth=True,
            # Per-stream ground-truth overrides at synthesis time: the
            # predicted stream is replaced by the original from world_dir.
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
            device=hparams.get("device", "cuda"),
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

    # -- benchmark ------------------------------------------------------------
    def compute_score(self, hparams, results):
        """Mean MCD / F0-RMSE / VDE / BAP distortion of the post-processed
        predictions against the original WORLD features."""
        num_coded_sps = hparams.get("num_coded_sps", 60)
        metric_names = hparams.get(
            "metrics", [Metrics.MCD, Metrics.F0_RMSE, Metrics.VDE,
                        Metrics.BAP_distortion])
        metrics = Metrics(metric_names)
        for id_name, sample in results.items():
            out_sp, out_lf0, out_vuv, out_bap = \
                WorldFeatLabelGen.convert_to_world_features(
                    np.asarray(sample["pred_acoustic_features"]),
                    contains_deltas=False, num_coded_sps=num_coded_sps)
            org_sp, org_lf0, org_vuv, org_bap = \
                WorldFeatLabelGen.convert_to_world_features(
                    self._org_features(hparams, id_name),
                    contains_deltas=False, num_coded_sps=num_coded_sps)
            metrics.accumulate(id_name, Metrics.get_metrics(
                metric_names, org_coded_sp=org_sp, org_lf0=org_lf0,
                org_vuv=org_vuv, org_bap=org_bap, output_coded_sp=out_sp,
                output_lf0=out_lf0, output_vuv=out_vuv, output_bap=out_bap))
        metrics.log()
        return tuple(metrics.get_cum_values())

    def _org_features(self, hparams, id_name):
        return WorldFeatLabelGen.load_sample(
            id_name, self.dir_world_features, add_deltas=False,
            num_coded_sps=hparams.get("num_coded_sps", 60),
            sp_type=hparams.get("sp_type", "mcep"))

    # -- synthesis ------------------------------------------------------------
    def gen_waveform(self, hparams, results, use_org_features=False):
        """{id: post-processed sample} -> wav files through
        ``hparams.synth_vocoder`` (WORLD, raw or WaveNet).  With
        ``synth_load_org_<stream>`` the predicted stream is replaced by
        the original one; ``synth_feature_names`` picks (and
        concatenates) the outputs that feed the vocoder."""
        num_coded_sps = hparams.get("num_coded_sps", 60)
        num_bap = hparams.get("num_bap", 1)
        load_streams = [s for s in _STREAMS
                        if hparams.get("synth_load_org_" + s)]
        feature_names = hparams.get("synth_feature_names") \
            or ("pred_acoustic_features",)
        if not isinstance(feature_names, (list, tuple)):
            feature_names = (feature_names,)
        # Column ranges of each stream in [coded_sp | lf0 | vuv | bap].
        columns = {"sp": slice(0, num_coded_sps),
                   "lf0": slice(num_coded_sps, num_coded_sps + 1),
                   "vuv": slice(num_coded_sps + 1, num_coded_sps + 2),
                   "bap": slice(num_coded_sps + 2,
                                num_coded_sps + 2 + num_bap)}
        synth_output = {}
        for id_name, sample in results.items():
            if use_org_features:
                synth_output[id_name] = self._org_features(hparams, id_name)
                continue
            feats = np.concatenate(
                [np.atleast_2d(np.asarray(sample[n])) for n in feature_names],
                axis=1) if len(feature_names) > 1 \
                else np.asarray(sample[feature_names[0]])
            if load_streams:
                feats = np.array(feats, copy=True)
                org = self._org_features(hparams, id_name)
                n = min(len(org), len(feats))
                for stream in load_streams:
                    feats[:n, columns[stream]] = org[:n, columns[stream]]
            synth_output[id_name] = feats
        vocoder = hparams.get("synth_vocoder", "WORLD")
        if vocoder == "WORLD":
            return Synthesiser.run_world_synth(
                synth_output, hparams, epoch=self.total_epoch)
        if vocoder == "raw":
            return Synthesiser.run_raw_synth(synth_output, hparams)
        if vocoder == "GriffinLim":
            return Synthesiser.run_griffin_lim(synth_output, hparams)
        if vocoder in ("r9y9wavenet", "wavenet"):
            return Synthesiser.run_wavenet_vocoder(synth_output, hparams)
        raise NotImplementedError("Unknown vocoder " + vocoder)

    @staticmethod
    def uses_fused_synth(hparams):
        """True when ``synth`` takes the fused path: ``use_fused_synth``
        set, the WORLD vocoder, no stream override, and the default
        output feeding the vocoder."""
        feature_names = hparams.get("synth_feature_names")
        return bool(
            hparams.get("use_fused_synth", True)
            and hparams.get("synth_vocoder", "WORLD") == "WORLD"
            and not any(hparams.get("synth_load_org_" + s)
                        for s in _STREAMS)
            and (not feature_names or tuple(np.atleast_1d(feature_names))
                 == ("pred_acoustic_features",)))

    def synth(self, hparams, id_list, use_org_features=False):
        if use_org_features:
            return self.gen_waveform(hparams, {i: {} for i in id_list},
                                     use_org_features=True)
        if self.uses_fused_synth(hparams):
            return self._synth_fused(hparams,
                                     self._input_to_str_list(id_list))
        return super().synth(hparams, id_list)

    def build_serving(self, hparams):
        """The serving assets of the trained model: ``(pipeline, params,
        load_inputs)``.  ``pipeline`` is the :class:`FusedAcousticPipeline`
        on the handler's device (model forward, denormalisation, MLPG,
        vocoder; one per configuration, cached), ``params`` what it runs
        the model with (the EMA parameters when configured, else the
        model) and ``load_inputs(id_name)`` the question-matrix loader."""
        handler = self.model_handler
        reader_q = self.datareaders["questions"]
        reader_cmp = self.datareaders["cmp_features"]
        if reader_cmp.covs[0] is None or reader_cmp.norm_params is None:
            raise ValueError("cmp reader has no covariances/norm stats")
        input_names = tuple(getattr(handler.model_config, "input_names",
                                    None) or ("questions",))
        if input_names != ("questions",):
            raise NotImplementedError(
                "serving a model with inputs {} is not ported yet; "
                "ROADMAP.md queue 1 item 6 (EMB groups) ports it".format(
                    input_names))

        def load_inputs(id_name):
            return np.asarray(reader_q[id_name]["questions"], np.float32)

        fs = hparams.get("synth_fs", 16000)
        pipe_key = (hparams.get("num_coded_sps", 60), fs,
                    hparams.get("frame_size_ms", 5),
                    hparams.get("num_bap", 1),
                    bool(hparams.get("do_post_filtering")),
                    hparams.get("mgc_alpha"), str(handler.device))
        cache = self.__dict__.setdefault("_fused_pipelines", {})
        if pipe_key not in cache:
            variances = {name: np.ascontiguousarray(np.diagonal(
                reader_cmp.covs[idx])) for name, idx in (("sp", 0),
                                                         ("lf0", 1),
                                                         ("bap", 3))}
            mean, scale = reader_cmp.norm_params
            model = handler.model
            output_name = handler.model_config.output_names[0]

            def model_apply(params, questions_b, lengths_b):
                data = {"questions": questions_b}
                if isinstance(params, dict):     # EMA parameters
                    out = torch.func.functional_call(
                        model, params, (data,),
                        {"lengths": lengths_b, "training": False})
                else:
                    out = params(data, lengths=lengths_b, training=False)
                return out[output_name]

            cache[pipe_key] = FusedAcousticPipeline(
                model_apply, variances,
                num_coded_sps=hparams.get("num_coded_sps", 60), fs=fs,
                frame_shift_ms=hparams.get("frame_size_ms", 5),
                num_bap=hparams.get("num_bap", 1),
                num_bins=mcep_ops.fs_to_frame_length(fs) // 2 + 1,
                post_filter=bool(hparams.get("do_post_filtering")),
                mean=np.asarray(mean).reshape(-1),
                scale=np.asarray(scale).reshape(-1),
                mgc_alpha=hparams.get("mgc_alpha"), device=handler.device)
        params = handler.ema.shadow if handler.ema is not None \
            else handler.model
        return cache[pipe_key], params, load_inputs

    def serve(self, hparams, max_batch=32, max_wait_ms=5.0):
        """A :class:`SynthesisServer` over the trained model's fused
        pipeline: ``server.submit(question_matrix)`` returns a future of
        the waveform; concurrent requests batch per length bucket."""
        pipeline, params, _ = self.build_serving(hparams)
        return SynthesisServer(pipeline, params, max_batch=max_batch,
                               max_wait_ms=max_wait_ms)

    def _synth_fused(self, hparams, id_list):
        """label -> wav through :class:`FusedAcousticPipeline` for the
        whole batch, loudness-normalised and PCM16-encoded on the
        device."""
        pipeline, params, load_inputs = self.build_serving(hparams)
        wavs = pipeline(params, [load_inputs(i) for i in id_list],
                        pcm16=True)
        fs = hparams.get("synth_fs", 16000)
        suffix = "_e{}".format(self.total_epoch) \
            if self.total_epoch is not None else ""
        if hparams.get("model_name"):
            suffix += "_" + str(hparams.model_name)
        paths = {}
        for id_name, raw in zip(id_list, wavs):
            path = Synthesiser._out_path(id_name, hparams, suffix)
            audio_io.raw_to_file(path, raw, fs)
            paths[id_name] = path
        return paths

    def copy_synth(self, hparams, id_list):
        """Synthesise from the original extracted features."""
        return self.gen_waveform(hparams, {i: {} for i in id_list},
                                 use_org_features=True)
