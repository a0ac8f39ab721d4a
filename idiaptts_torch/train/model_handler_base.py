"""Abstract model handler interface: the port's copy of
``idiaptts_tpu/train/model_handler_base.py``, the contract that trainers
program against.  :class:`idiaptts_torch.train.handler.ModularModelHandler`
implements it in PyTorch.
"""

import abc


class ModelHandler(abc.ABC):
    """Backend contract: model lifecycle + train/eval/inference."""

    @abc.abstractmethod
    def create_model(self, model_config, hparams=None, dim_in=None,
                     dim_out=None, example_batch=None):
        ...

    @abc.abstractmethod
    def save_checkpoint(self, directory, model_name=None, epoch=None,
                        step=None, best=False, last=False,
                        best_loss=None, networks_dir="nn"):
        ...

    @abc.abstractmethod
    def load_checkpoint(self, directory, model_name=None, epoch=None,
                        step=None, best=False, last=False,
                        load_optimiser=True, load_scheduler=True,
                        ignore_layers=(), layer_map=(),
                        networks_dir="nn"):
        ...

    @abc.abstractmethod
    def set_optimiser(self, hparams):
        ...

    @abc.abstractmethod
    def set_scheduler(self, hparams):
        ...

    @abc.abstractmethod
    def set_losses(self, loss_configs):
        ...

    @abc.abstractmethod
    def process_batches(self, batches, training=True, step_offset=None,
                        current_epoch=None):
        ...

    @abc.abstractmethod
    def inference(self, batch):
        ...
