"""ModularTrainer, training half: the port of
``idiaptts_tpu/train/trainer.py``'s experiment lifecycle up to training
and testing.

Id-list splitting, datareader and dataset setup, the init/checkpoint
policy, the epoch loop with validation, schedulers, best-model
checkpointing and the final-model policy, ``test``, loss records and
checkpoint save/load.  Batches are collated with numpy on a background
thread while the card trains on the previous one; the model handler
moves each batch to its device.

Not ported yet: ``forward``, ``synth``, ``copy_synth``, ``gen_waveform``,
``benchmark``/``compute_score`` and the figure front doors (they wait for
the synthesiser and metrics modules, ROADMAP.md queue 1 item 9), the
windowing dataset, TensorBoard logging and the profiler hook.
"""

import logging
import math
import os
import queue
import random
import threading
import time

import numpy as np

from idiaptts_torch.data.dataset import DatareadersDataset, collate_batch
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.train.handler import ModularModelHandler

logger = logging.getLogger(__name__)

_LATER = ("is not ported yet; ROADMAP.md queue 1 item 9 (serving front "
          "door: synthesiser and metrics) ports it")


class ModularTrainer:
    """Generic trainer around one model handler.  The handler runs on
    ``hparams.device`` (the card by default)."""

    def __init__(self, hparams, id_list=None, data_reader_configs=None):
        self.hparams = hparams
        seed = hparams.get("seed")
        if seed is not None:
            random.seed(seed)
            np.random.seed(seed)
        self.model_handler = ModularModelHandler(
            device=hparams.get("device", "cuda"))
        self.data_reader_configs = data_reader_configs
        self.datareaders = {}
        self.dataset_train = None
        self.dataset_val = None
        self.dataset_test = None
        self.loss_configs = []
        self.total_epoch = 0
        self.best_loss = np.inf
        self.train_losses = []       # [(loss_dict, epoch)]
        self.validation_losses = []
        if id_list is not None:
            self._setup_id_lists(id_list, hparams)
        else:
            self.id_list_train = self.id_list_val = self.id_list_test = []

    # -- id lists ---------------------------------------------------------
    def _setup_id_lists(self, id_list, hparams):
        """Split into train/val/test by percentage, or take explicit
        dict splits."""
        if isinstance(id_list, dict):
            self.id_list_train = list(id_list.get("train", []))
            self.id_list_val = list(id_list.get("val", []))
            self.id_list_test = list(id_list.get("test", []))
            return
        id_list = [str(i).strip() for i in id_list if str(i).strip()]
        if hparams.get("seed") is not None:
            rng = random.Random(hparams.seed)
            id_list = sorted(id_list)
            rng.shuffle(id_list)
        num = len(id_list)
        num_test = int(num * hparams.get("test_set_perc", 0.05))
        num_val = int(num * hparams.get("val_set_perc", 0.05))
        self.id_list_test = id_list[:num_test]
        self.id_list_val = id_list[num_test:num_test + num_val]
        self.id_list_train = id_list[num_test + num_val:]

    # -- init -------------------------------------------------------------
    def init(self, hparams, model_config=None, loss_configs=None,
             data_reader_configs=None):
        if data_reader_configs is not None:
            self.data_reader_configs = data_reader_configs
            self._setup_datareaders(hparams)
            self._setup_datasets(hparams)
        elif not self.datareaders:
            self._setup_datareaders(hparams)
            self._setup_datasets(hparams)
        self.loss_configs = loss_configs or []
        handler = self.model_handler
        loaded = False
        if hparams.get("load_from_checkpoint") \
                or hparams.get("load_newest_checkpoint"):
            try:
                best_loss, epoch, _ = handler.load_checkpoint(
                    hparams.out_dir, hparams.model_name,
                    epoch=hparams.get("epoch_to_load"),
                    step=hparams.get("step_to_load"),
                    load_optimiser=False, load_scheduler=False,
                    ignore_layers=hparams.get("ignore_layers", []),
                    layer_map=hparams.get("layer_map", []),
                    networks_dir=hparams.get("networks_dir", "nn"))
                if best_loss is not None:
                    self.best_loss = best_loss
                if epoch is not None:
                    self.total_epoch = epoch
                loaded = True
            except FileNotFoundError:
                if hparams.get("load_from_checkpoint"):
                    raise
        if not loaded:
            if model_config is None:
                raise ValueError("model_config required for a new model")
            handler.create_model(model_config, hparams,
                                 example_batch=self._example_batch(hparams))
        handler.set_optimiser(hparams)
        handler.set_scheduler(hparams)
        handler.set_losses(self.loss_configs)
        names = hparams.get("backprop_loss_names")
        handler.backprop_loss_names = tuple(names) if names else None
        handler.set_ema(hparams)
        handler.residuals_bf16 = bool(hparams.get("bf16_residuals", False))
        if loaded and (hparams.get("load_optimiser")
                       or hparams.get("load_scheduler")):
            try:
                handler.load_checkpoint(
                    hparams.out_dir, hparams.model_name,
                    epoch=hparams.get("epoch_to_load"),
                    step=hparams.get("step_to_load"),
                    load_optimiser=hparams.get("load_optimiser", True),
                    load_scheduler=hparams.get("load_scheduler", True),
                    networks_dir=hparams.get("networks_dir", "nn"))
            except FileNotFoundError:
                pass
        return self

    def _setup_datareaders(self, hparams):
        self.datareaders = {}
        for config in (self.data_reader_configs or []):
            reader = config.create_reader()
            self.datareaders[reader.name] = reader

    def _setup_datasets(self, hparams):
        readers = list(self.datareaders.values())
        if not readers:
            raise ValueError("No datareaders configured: set up "
                             "DataReaderConfigs before _setup_datasets.")
        dataset_type = hparams.get("dataset_type", "DatareadersDataset")
        if dataset_type != "DatareadersDataset":
            raise NotImplementedError(
                "dataset_type {} is not ported yet; ROADMAP.md queue 1 "
                "item 11 ports the windowing dataset".format(dataset_type))
        self.dataset_train = DatareadersDataset(self.id_list_train, readers)
        self.dataset_val = DatareadersDataset(self.id_list_val, readers,
                                              random_select=False)
        self.dataset_test = DatareadersDataset(self.id_list_test, readers,
                                               random_select=False)

    def _example_batch(self, hparams, id_list=None):
        ids = id_list or (self.id_list_train or self.id_list_val
                          or self.id_list_test)
        if not ids:
            raise ValueError("No utterance ids available to build an "
                             "example batch: id lists are empty.")
        if self.dataset_train is None:
            raise ValueError("Datasets are not initialised: call "
                             "_setup_datasets before _example_batch.")
        sample, _ = self.dataset_train.get_id_name(ids[0])
        return collate_batch([sample])

    # -- batching ---------------------------------------------------------
    def _batches(self, dataset, id_list, batch_size, shuffle=False, seed=0,
                 prefetch=2):
        """Collated batches, produced on a background thread ``prefetch``
        batches ahead so host loading overlaps the device's work.  A
        producer error is re-raised to the consumer."""
        ids = list(id_list)
        if shuffle:
            random.Random(seed).shuffle(ids)

        def produce():
            for start in range(0, len(ids), batch_size):
                chunk = ids[start:start + batch_size]
                yield collate_batch([dataset.get_id_name(i)[0]
                                     for i in chunk])

        if not prefetch:
            yield from produce()
            return
        q = queue.Queue(maxsize=prefetch)
        stop = object()
        cancelled = threading.Event()
        error = []

        def put(item):
            # Bounded put: an abandoned consumer releases the thread.
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=1.0)
                    return
                except queue.Full:
                    continue

        def worker():
            try:
                for batch in produce():
                    put(batch)
                    if cancelled.is_set():
                        return
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                error.append(exc)
            finally:
                put(stop)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is stop:
                    break
                yield batch
            thread.join()
            if error:
                raise error[0]
        finally:
            cancelled.set()

    # -- training ---------------------------------------------------------
    def train(self, hparams):
        """Epoch loop with validation, best-model checkpointing and the
        final-model policy.  Returns (validation losses, train losses)."""
        hparams.verify()
        t_start = time.time()
        batch_size = hparams.get("batch_size_train", 1)
        epochs = hparams.get("epochs", 0)
        all_loss, all_loss_train = [], []
        handler = self.model_handler
        if hparams.get("start_with_test") or epochs == 0:
            loss, _ = handler.process_batches(
                self._batches(self.dataset_val or self.dataset_train,
                              self.id_list_val or self.id_list_train,
                              hparams.get("batch_size_val", batch_size)),
                training=False)
            logger.info("Pre-training validation loss: %f", loss)
            all_loss.append(loss)
            if loss < self.best_loss and not math.isnan(loss):
                self.best_loss = loss
                self._save(hparams, best=True)

        for _ in range(epochs):
            self.total_epoch += 1
            epoch_seed = (hparams.get("seed") or 0) + self.total_epoch
            try:
                train_loss, per_loss = handler.process_batches(
                    self._batches(self.dataset_train, self.id_list_train,
                                  batch_size,
                                  shuffle=hparams.get("shuffle_train_set",
                                                      True),
                                  seed=epoch_seed),
                    training=True, current_epoch=self.total_epoch)
            except ValueError as e:
                if "NaN" not in str(e):
                    raise
                # Stop on NaN; the best-model reload and final save run.
                logger.error("Train loss is NaN, stopping: %s", e)
                break
            all_loss_train.append(train_loss)
            self.record_train_loss(per_loss, self.total_epoch)
            logger.info("Epoch %d train loss: %f", self.total_epoch,
                        train_loss)
            if math.isnan(train_loss):
                logger.error("Train loss is NaN, stopping.")
                break
            if handler.scheduler is not None \
                    and not handler.iterations_per_scheduler_step:
                # The scheduler advances once every
                # epochs_per_scheduler_step epochs.
                eps = handler.epochs_per_scheduler_step or 1
                if self.total_epoch % eps == 0:
                    handler.scheduler.on_epoch(self.total_epoch // eps)

            ept = hparams.get("epochs_per_test", 1)
            if ept > 0 and self.total_epoch % ept == 0:
                val_loss, val_per_loss = handler.process_batches(
                    self._batches(self.dataset_val or self.dataset_train,
                                  self.id_list_val or self.id_list_train,
                                  hparams.get("batch_size_val", batch_size),
                                  shuffle=hparams.get("shuffle_val_set",
                                                      False),
                                  seed=epoch_seed),
                    training=False)
                all_loss.append(val_loss)
                self.record_validation_loss(val_per_loss, self.total_epoch)
                logger.info("Epoch %d validation loss: %f",
                            self.total_epoch, val_loss)
                if handler.scheduler is not None:
                    # The plateau metric may track a subset of the losses.
                    names = hparams.get("scheduler_loss_names")
                    metric = sum(val_per_loss[n] for n in names) \
                        if names else val_loss
                    handler.scheduler.on_metric(metric)
                if val_loss < self.best_loss and not math.isnan(val_loss):
                    self.best_loss = val_loss
                    self._save(hparams, best=True)
            if hparams.get("checkpoint_epoch_interval") \
                    and self.total_epoch \
                    % hparams.checkpoint_epoch_interval == 0 \
                    and hparams.get("out_dir"):
                self._save(hparams, epoch=self.total_epoch)

        if hparams.get("use_best_as_final_model") and epochs > 0 \
                and hparams.get("out_dir"):
            try:
                handler.load_checkpoint(
                    hparams.out_dir, hparams.model_name, best=True,
                    load_optimiser=False, load_scheduler=False,
                    networks_dir=hparams.get("networks_dir", "nn"))
                logger.info("Reloaded best model (loss %s)", self.best_loss)
            except FileNotFoundError:
                pass
        if hparams.get("save_final_model") and hparams.get("out_dir"):
            self._save(hparams, last=True)
        logger.info("Training took %.1f s", time.time() - t_start)
        return all_loss, all_loss_train

    def _save(self, hparams, epoch=None, best=False, last=False):
        if not hparams.get("out_dir"):
            return
        self.model_handler.save_checkpoint(
            hparams.out_dir, hparams.model_name, epoch=epoch, best=best,
            last=last, best_loss=self.best_loss,
            networks_dir=hparams.get("networks_dir", "nn"))

    def test(self, hparams, id_list=None):
        ids = id_list or self.id_list_test
        loss, _ = self.model_handler.process_batches(
            self._batches(self.dataset_test or self.dataset_train, ids,
                          hparams.get("batch_size_test", 48)),
            training=False)
        logger.info("Test loss: %f", loss)
        return loss

    @staticmethod
    def create_hparams(hparams_string=None, verbose=False):
        return ExtendedHParams.create_hparams(hparams_string, verbose)

    # -- fronts that wait for later slices ---------------------------------
    def forward(self, hparams, id_list, input_only=True):
        raise NotImplementedError("ModularTrainer.forward " + _LATER)

    def synth(self, hparams, id_list):
        raise NotImplementedError("ModularTrainer.synth " + _LATER)

    def benchmark(self, hparams, id_list=None):
        raise NotImplementedError("ModularTrainer.benchmark " + _LATER)

    # -- loss records and checkpoints ---------------------------------------
    def record_train_loss(self, loss_dict, epoch):
        self.train_losses.append((dict(loss_dict or {}), epoch))

    def record_validation_loss(self, loss_dict, epoch):
        self.validation_losses.append((dict(loss_dict or {}), epoch))

    def get_losses(self, start_epoch=-1):
        """({loss_name: array}, {loss_name: array}) for train and val."""
        names = next((list(store[0][0]) for store in
                      (self.train_losses, self.validation_losses) if store),
                     None)
        if names is None:
            return None, None
        train = {n: np.array([d[n] for d, e in self.train_losses
                              if e >= start_epoch and n in d])
                 for n in names}
        val = {n: np.array([d[n] for d, e in self.validation_losses
                            if e >= start_epoch and n in d])
               for n in names}
        return train, val

    def reset_best_loss(self):
        self.best_loss = np.inf

    def get_model_path(self, hparams):
        if hparams.get("out_dir") and hparams.get("model_name"):
            return os.path.join(hparams.out_dir, hparams.model_name,
                                hparams.get("networks_dir", "nn"))
        return None

    def save_checkpoint(self, hparams, epoch=None, best=False, last=False):
        return self.model_handler.save_checkpoint(
            hparams.out_dir, hparams.model_name, epoch=epoch, best=best,
            last=last, best_loss=self.best_loss,
            networks_dir=hparams.get("networks_dir", "nn"))

    def load_checkpoint(self, hparams, epoch=None, step=None, best=False,
                        last=False):
        return self.model_handler.load_checkpoint(
            hparams.out_dir, hparams.model_name, epoch=epoch, step=step,
            best=best, last=last,
            networks_dir=hparams.get("networks_dir", "nn"))

    def load_best_model(self, hparams):
        best_loss, epoch, _ = self.load_checkpoint(hparams, best=True)
        if best_loss is not None:
            self.best_loss = best_loss
        return best_loss, epoch

    def get_dataset(self, split="train"):
        return {"train": self.dataset_train, "val": self.dataset_val,
                "test": self.dataset_test}[split]
