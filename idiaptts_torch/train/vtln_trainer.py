"""VTLN speaker-adaptation trainers: the port of
``idiaptts_tpu/train/vtln_trainer.py``.

A pre-net acoustic model followed by an :class:`AllPassWarpLayer` whose
alphas come from the speaker input, composed as a
:class:`~idiaptts_torch.models.named.Sequential`.  ``compute_score``
gives the acoustic trainer's scores and logs an MCD sweep over the
cepstral sub-ranges (first quarter, half, all), kept on
``self.mcd_sweep``.  The pre-net is an rnn_dyn model (its BiLSTM layers
run the hand kernels on the card); ``benchmark`` and ``synth`` smooth
the output through MLPG as the acoustic trainer does (the one-shot MLPG
kernel on the card).

The alpha layers' input widths (inferred from the data by the JAX
package) are set from the trainer's example batch when the warp
config leaves them open.
"""

import logging

import numpy as np

from idiaptts_torch.data.world_feat import WorldFeatLabelGen
from idiaptts_torch.models.named import Sequential
from idiaptts_torch.models.vtln import AllPassWarpLayer
from idiaptts_torch.synth.metrics import Metrics
from idiaptts_torch.train.acoustic import AcousticModelTrainer

logger = logging.getLogger(__name__)


def _warp_configs(config):
    """The AllPassWarpLayer configs in a (nested) model config."""
    if isinstance(config, AllPassWarpLayer.Config):
        return [config]
    found = []
    for sub in getattr(config, "module_configs", None) or []:
        found.extend(_warp_configs(sub))
    return found


class VTLNSpeakerAdaptionModelTrainer(AcousticModelTrainer):

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.mcd_sweep = {}

    @staticmethod
    def create_hparams(hparams_string=None, verbose=False):
        hparams = AcousticModelTrainer.create_hparams(hparams_string,
                                                      verbose)
        hparams.add_hparams(
            pre_net_model_config=None,
            alpha_ranges=[0.2],
            warp_matrix_size=None,
            pass_embs_to_pre_net=True,
        )
        return hparams

    def build_model_config(self, hparams, pre_net_config, num_coded_sps,
                           mean=None, std_dev=None):
        """The pre-net and the warp layer as one dict-protocol model."""
        warp_config = AllPassWarpLayer.Config(
            input_names=pre_net_config.output_names,
            output_names=("pred_acoustic_features", "alphas"),
            alpha_input_names=("speaker_embedding",),
            warp_matrix_size=(hparams.get("warp_matrix_size")
                              or num_coded_sps),
            alpha_ranges=hparams.get("alpha_ranges", [0.2]),
            mean=mean, std_dev=std_dev)
        return Sequential.Config(
            module_configs=[pre_net_config, warp_config],
            input_names=pre_net_config.input_names,
            output_names=("pred_acoustic_features",))

    def init(self, hparams, model_config=None, loss_configs=None,
             data_reader_configs=None):
        open_warps = [c for c in _warp_configs(model_config)
                      if getattr(c, "alpha_layer_in_dims", None) is None]
        if open_warps:
            self.data_reader_configs = data_reader_configs \
                or self.default_data_reader_configs(hparams)
            self._setup_datareaders(hparams)
            self._setup_datasets(hparams)
            example = self._example_batch(hparams)
            for config in open_warps:
                config.alpha_layer_in_dims = tuple(
                    int(np.shape(example[n])[-1])
                    for n in config.alpha_input_names)
        return super().init(hparams, model_config, loss_configs,
                            data_reader_configs)

    def compute_score(self, hparams, results):
        """The acoustic scores; the MCD sweep over cepstral sub-ranges
        is logged and kept on ``self.mcd_sweep``."""
        base_scores = super().compute_score(hparams, results)
        num_coded_sps = hparams.get("num_coded_sps", 60)
        sweep = {}
        for hi in (num_coded_sps // 4, num_coded_sps // 2, num_coded_sps):
            name = "MCD_{}".format(hi)
            metrics = Metrics([name])
            for id_name, sample in results.items():
                pred = np.asarray(sample["pred_acoustic_features"])
                org = WorldFeatLabelGen.load_sample(
                    id_name, self.dir_world_features, add_deltas=False,
                    num_coded_sps=num_coded_sps,
                    sp_type=hparams.get("sp_type", "mcep"))
                n = min(len(pred), len(org))
                metrics.accumulate(id_name, Metrics.get_metrics(
                    [name], org_coded_sp=org[:n, :num_coded_sps],
                    output_coded_sp=pred[:n, :num_coded_sps]))
            sweep[name] = metrics.get_cum_values()[0]
        logger.info("MCD sweep: %s", sweep)
        self.mcd_sweep = sweep
        return base_scores


class VTLNMonophoneSpeakerAdaptionModelTrainer(
        VTLNSpeakerAdaptionModelTrainer):
    """VTLN on a monophone encoder-decoder pre-net: the same scoring,
    another default pre-net."""
