"""ModularTrainer: the port of ``idiaptts_tpu/train/trainer.py``'s
experiment lifecycle.

Id-list splitting, datareader and dataset setup, the init/checkpoint
policy, the epoch loop with validation, schedulers, best-model
checkpointing and the final-model policy, ``test``, loss records and
checkpoint save/load.  Batches are collated with numpy on a background
thread while the card trains on the previous one; the model handler
moves each batch to its device.

Evaluation and synthesis: ``forward``, ``benchmark`` and ``synth`` run
batched inference on the handler's device (``_forward_batched``), cut
each output to its utterance's length and post-process it through its
reader (``post_processing_mapping``; for WORLD features that is MLPG on
the reader's device), then hand the results to the task trainer's
``compute_score`` or ``gen_waveform``.  ``copy_synth`` synthesises from
the readers' original features.

Not ported yet: the figure front doors (``gen_figure``, which needs the
plotter, ROADMAP.md queue 1 item 12), the windowing dataset (item 11),
TensorBoard logging and the profiler hook.
"""

import copy
import logging
import math
import os
import queue
import random
import threading
import time

import numpy as np

from idiaptts_torch.data.dataset import (DatareadersDataset,
                                         batch_decollate, collate_batch)
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.train.handler import ModularModelHandler

logger = logging.getLogger(__name__)

_LATER_FIGURE = ("gen_figure is not ported yet; ROADMAP.md queue 1 item 12 "
                 "(utils/plotter.py) ports it")


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

    # -- evaluation and synthesis front doors --------------------------------
    def forward(self, hparams, id_list, input_only=True):
        """Batched inference -> {id: post-processed output dict}.  With
        ``input_only`` the dataset is built from the model-input readers
        alone, so utterances without target features can be synthesised.
        ``id_list`` accepts a list/tuple of ids, a single id, or a
        file-id-list path."""
        return self._forward_batched(
            hparams, self._input_to_str_list(id_list),
            hparams.get("batch_size_val", 48), input_only=input_only)

    def _model_input_names(self):
        names = set()

        def collect(cfg):
            if cfg is None:
                return
            # all_input_names covers side inputs too.
            getter = getattr(cfg, "all_input_names", None)
            for name in (getter() if callable(getter)
                         else (getattr(cfg, "input_names", None) or ())):
                names.add(name)
            for sub in getattr(cfg, "module_configs", None) or []:
                collect(sub)

        collect(self.model_handler.model_config)
        return names

    def _forward_batched(self, hparams, id_list, batch_size,
                         post_process=True, input_only=False):
        readers = list(self.datareaders.values())
        if input_only:
            wanted = self._model_input_names()
            filtered = [r for r in readers
                        if r.name in wanted
                        or any(n in wanted for n in r.output_names)]
            if filtered:
                readers = [_inference_clone(r) for r in filtered]
            dataset = DatareadersDataset(id_list, readers,
                                         random_select=False)
        else:
            # Full-length samples: benchmark compares frame by frame
            # against the full-length originals, so no training crops.
            dataset = DatareadersDataset(
                id_list,
                [_inference_clone(r) if getattr(r, "max_frames", None)
                 else r for r in readers],
                random_select=False)
        results = {}
        for start in range(0, len(id_list), batch_size):
            chunk = list(id_list)[start:start + batch_size]
            batch = collate_batch([dataset.get_id_name(i)[0] for i in chunk])
            out = self.model_handler.inference(batch)
            merged = dict(batch)
            merged.update({k: v for k, v in out.items()
                           if isinstance(v, np.ndarray)})
            # Model outputs take the lengths of the batch feature with the
            # same padded time axis, so multi-rate batches trim right.
            first_len_key = next(iter(batch["_lengths"]))
            lengths = {}
            for k, v in merged.items():
                if k.startswith("_"):
                    continue
                if k in batch["_lengths"]:
                    lengths[k] = batch["_lengths"][k]
                    continue
                time_dim = v.shape[1] if getattr(v, "ndim", 0) > 1 else None
                match = next(
                    (lk for lk in batch["_lengths"]
                     if lk in batch and getattr(batch[lk], "ndim", 0) > 1
                     and batch[lk].shape[1] == time_dim), None)
                lengths[k] = batch["_lengths"][match or first_len_key]
            for id_name, sample in zip(chunk, batch_decollate(
                    merged, lengths=lengths)):
                if post_process:
                    sample = self._postprocess_sample(sample)
                results[id_name] = sample
        return results

    def _postprocess_sample(self, sample):
        """Map output names through their readers' post-processing
        (``post_processing_mapping``: output name -> reader name)."""
        mapping = getattr(self, "post_processing_mapping", None)
        if not mapping:
            return sample
        out = dict(sample)
        for output_name, reader_name in mapping.items():
            if output_name in out and reader_name in self.datareaders:
                out[output_name] = self.datareaders[
                    reader_name].postprocess_sample(out[output_name])
        return out

    def synth(self, hparams, id_list):
        """Predict features and synthesise waveforms."""
        results = self._forward_batched(
            hparams, self._input_to_str_list(id_list),
            hparams.get("batch_size_synth", 12), input_only=True)
        return self.gen_waveform(hparams, results)

    def copy_synth(self, hparams, id_list):
        """Synthesise from the original features: each reader's sample is
        post-processed by its reader and exposed under the prediction
        keys of ``post_processing_mapping``, so ``gen_waveform`` sees the
        sample a forward pass would give."""
        mapping = getattr(self, "post_processing_mapping", {}) or {}
        dataset = DatareadersDataset(
            id_list, [_inference_clone(r)
                      for r in self.datareaders.values()],
            random_select=False)
        results = {}
        for id_name in id_list:
            sample, _ = dataset.get_id_name(id_name)
            out = dict(sample)
            for pred_key, reader_name in mapping.items():
                reader = self.datareaders.get(reader_name)
                if reader is None:
                    continue
                source = next((n for n in reader.output_names
                               if n in sample), None)
                if source is not None:
                    out[pred_key] = reader.postprocess_sample(sample[source])
            results[id_name] = out
        return self.gen_waveform(hparams, results)

    def gen_waveform(self, hparams, results):
        """Vocoder dispatch: implemented by the task trainer."""
        raise NotImplementedError(
            "gen_waveform must be implemented by the task trainer.")

    def benchmark(self, hparams, id_list=None):
        """Scores of the post-processed predictions (the task trainer's
        ``compute_score``); no ids: the test split."""
        ids = self._input_to_str_list(id_list) if id_list \
            else self.id_list_test
        results = self._forward_batched(
            hparams, ids, hparams.get("batch_size_benchmark", 48))
        return self.compute_score(hparams, results)

    def compute_score(self, hparams, results):
        raise NotImplementedError(
            "compute_score must be implemented by the task trainer.")

    def gen_figure(self, hparams, id_list):
        raise NotImplementedError(_LATER_FIGURE)

    @staticmethod
    def id_list_to_str(id_list):
        return " ".join(
            os.path.join(os.path.split(os.path.dirname(i))[-1],
                         os.path.splitext(os.path.basename(i))[0])
            for i in id_list)

    @staticmethod
    def _input_to_str_list(input):
        """A file-id-list path, a single id string, or a list/tuple of
        ids -> list of id strings."""
        if isinstance(input, str):
            try:
                with open(input) as f:
                    return [s.strip(" \t\n\r") for s in f.readlines()
                            if s.strip(" \t\n\r")]
            except IOError:
                return [input]
        if isinstance(input, (list, tuple)):
            return [str(s) for s in input]
        raise ValueError("Unknown input {} of type {}.".format(
            input, type(input)))

    @staticmethod
    def split_batch(data, seq_lengths, batch_first=True):
        """Split every batched array in ``data`` into per-utterance arrays
        cut to their lengths."""
        return {k: ModularTrainer._split_return_values(
                    v, seq_lengths[k], batch_first=batch_first)
                for k, v in data.items()}

    @classmethod
    def _split_return_values(cls, input_values, seq_length_output,
                             permutation=None, batch_first=False):
        """Batched ndarray (or nested tuple of them) -> per-utterance
        list, cut to ``seq_length_output`` and optionally unsorted by
        ``permutation``.  collate_batch pads even a batch of one to its
        bucket, so every batch size is cut."""
        if input_values is None:
            return None
        if isinstance(input_values, tuple):
            if all(v is None for v in input_values):
                return input_values
            parts = tuple(
                cls._split_return_values(x, seq_length_output,
                                         permutation, batch_first)
                for x in input_values)
            batch_size = len([p for p in parts if isinstance(p, list)][0])
            out = []
            for index in range(batch_size):
                entry = []
                for element in parts:
                    if element is None or (
                            isinstance(element, tuple)
                            and all(v is None for v in element)):
                        entry.append(element)
                    else:
                        entry.append(element[index])
                out.append(tuple(entry))
            return tuple(out)
        if not isinstance(input_values, np.ndarray):
            raise TypeError(
                "Expected numpy tensor but input is of type {}.".format(
                    type(input_values)))
        axis = 0 if batch_first else 1
        values = [np.squeeze(v, axis=axis) for v in np.split(
            input_values, input_values.shape[axis], axis=axis)]
        if seq_length_output is not None \
                and np.ndim(seq_length_output) > 0 \
                and len(seq_length_output) >= 1:
            values = [v[:int(n)] for v, n in zip(values, seq_length_output)]
        if permutation is not None:
            unsorted = list(values)
            for org_index, current_index in enumerate(permutation):
                unsorted[current_index] = values[org_index]
            values = unsorted
        return values

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


def _inference_clone(reader):
    """Shallow copy of a reader for inference datasets: ``match_length``
    cleared (partners may be absent) and ``max_frames`` cleared (training
    crops must not cut synthesis or benchmark inputs)."""
    clone = copy.copy(reader)
    clone.match_length = None
    clone.max_frames = None
    return clone
