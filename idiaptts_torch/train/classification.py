"""Classification trainer: the port of
``idiaptts_tpu/train/classification.py``.

A generic classifier trained with the masked cross-entropy of its
logits; ``compute_score`` gives the confusion matrix and the
unweighted (class-balanced) accuracy.  The targets are class ids, for
example from :class:`idiaptts_torch.data.category.CategoryDataReader`.
"""

import logging

import numpy as np

from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.train.trainer import ModularTrainer

logger = logging.getLogger(__name__)


class ClassificationTrainer(ModularTrainer):

    def __init__(self, hparams, id_list, pred_name="pred_class",
                 target_name="class_target"):
        super().__init__(hparams, id_list)
        self.pred_name = pred_name
        self.target_name = target_name

    @staticmethod
    def create_hparams(hparams_string=None, verbose=False):
        hparams = ExtendedHParams.create_hparams(hparams_string, verbose)
        hparams.add_hparams(num_classes=None)
        return hparams

    def default_loss_configs(self, hparams):
        return [NamedLoss.Config(
            "ce", "CrossEntropyLoss", (self.pred_name, self.target_name),
            seq_mask="_seq_mask", reduction="mean")]

    def init(self, hparams, model_config=None, loss_configs=None,
             data_reader_configs=None):
        if loss_configs is None:
            loss_configs = self.default_loss_configs(hparams)
        return super().init(hparams, model_config, loss_configs,
                            data_reader_configs)

    def compute_score(self, hparams, results):
        """(unweighted accuracy, confusion matrix)."""
        num_classes = hparams.get("num_classes")
        reader = self.datareaders.get(self.target_name)
        confusion = None
        for id_name, sample in results.items():
            pred = np.asarray(sample[self.pred_name])
            pred_cls = np.argmax(pred, axis=-1).reshape(-1)
            target = np.asarray(sample.get(
                self.target_name, reader.load(id_name) if reader else None))
            target_cls = target.reshape(-1).astype(np.int64)
            n = min(len(pred_cls), len(target_cls))
            if confusion is None:
                C = num_classes or int(pred.shape[-1])
                confusion = np.zeros((C, C), np.int64)
            for t, p in zip(target_cls[:n], pred_cls[:n]):
                confusion[t, p] += 1
        per_class = confusion.diagonal() / np.maximum(
            confusion.sum(axis=1), 1)
        unweighted_accuracy = per_class.mean()
        logger.info("Confusion matrix:\n%s", confusion)
        logger.info("Unweighted accuracy: %.4f", unweighted_accuracy)
        return unweighted_accuracy, confusion

    def gen_waveform(self, hparams, results):
        raise NotImplementedError(
            "Classifiers do not synthesise waveforms.")
