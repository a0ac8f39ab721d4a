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

``hparams.dataset_type`` picks ``DatareadersDataset`` (the default) or
``WindowingDatareadersDataset``, whose windows the batcher takes as its
work items.

Data parallelism: with ``hparams.num_devices > 1`` or
``distributed_run``, the trainer joins the ``torch.distributed`` group
(launched by ``torchrun``, one process a rank; ranks that share a card
use gloo) and checks that ``num_devices`` is its size.  Every rank
builds the same batches (the same shuffle, and crops drawn from the
seed) and trains its rows of each through the handler's data-parallel
step.  Only rank 0 writes checkpoints, TensorBoard, figures and the
epoch logs; every rank loads checkpoints, and saves are fenced by
barriers.

Tensor parallelism: with ``hparams.model_parallel = M > 1`` the trainer
joins the group the same way (it raises ``ValueError`` when no group of
a multiple of M ranks was launched) and the handler trains over a
``(data, model)`` grid of ranks.  Validation, ``test``, ``forward``,
``benchmark``, ``synth`` and checkpoint saves run on every rank in the
same order, as the sharded model needs its whole model group; rank 0
writes.  Serving runs a one-device copy of the gathered weights.

Figures: ``gen_figure`` draws each utterance's post-processed outputs
through :class:`idiaptts_torch.utils.plotter.DataPlotter` (matplotlib,
imported only there).  Logging: with ``out_dir`` and ``model_name`` set,
a ``tensorboardX`` writer under ``<out_dir>/<model_name>/tensorboard``
gets the hparams text, the parameter count and the epoch losses (a
warning if it cannot be created).  Profiling: ``hparams.profiler_dir``
wraps ``train`` in ``torch.profiler`` and writes its Chrome trace there.
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
import torch

from idiaptts_torch.data.dataset import (DatareadersDataset,
                                         WindowingDatareadersDataset,
                                         batch_decollate, batch_shape,
                                         collate_batch)
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.parallel import mesh as mesh_lib
from idiaptts_torch.train.handler import ModularModelHandler
from idiaptts_torch.utils import tracing
from idiaptts_torch.utils.misc import (get_device_memory_stats,
                                       get_memory_usage_mb, log_git_hash)

logger = logging.getLogger(__name__)


class ModularTrainer:
    """Generic trainer around one model handler.  The handler runs on
    ``hparams.device`` (the card by default)."""

    def __init__(self, hparams, id_list=None, data_reader_configs=None):
        self.hparams = hparams
        log_git_hash()
        seed = hparams.get("seed")
        if seed is not None:
            random.seed(seed)
            np.random.seed(seed)
        device = hparams.get("device", "cuda")
        self.data_parallel = _data_parallel(hparams)
        self.rank = 0
        if self.data_parallel:
            mesh = mesh_lib.initialise_multihost(device=device)
            device, self.rank = mesh.device, mesh.rank
        self.model_handler = ModularModelHandler(device=device)
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
        self.summary_writer = None
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
        self._setup_summary_writer(hparams)
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
        if self.data_parallel:
            handler.setup_mesh(hparams.get("num_devices"),
                               hparams.get("data_axis", "data"),
                               hparams.get("model_parallel", 1),
                               hparams.get("use_shard_map", "auto"))
        handler.set_optimiser(hparams)
        handler.set_scheduler(hparams)
        handler.set_losses(self.loss_configs)
        names = hparams.get("backprop_loss_names")
        handler.backprop_loss_names = tuple(names) if names else None
        handler.set_ema(hparams)
        handler.residuals_bf16 = hparams.get("bf16_residuals")
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
        self._log_model_summary()
        return self

    # -- TensorBoard ------------------------------------------------------
    def _setup_summary_writer(self, hparams):
        """A tensorboardX writer with the hparams text, when ``out_dir``
        and ``model_name`` are set; a warning if it cannot be created."""
        self.summary_writer = None
        if not hparams.get("out_dir") or not hparams.get("model_name") \
                or not self.is_writer:
            return
        try:
            from tensorboardX import SummaryWriter
            self.summary_writer = SummaryWriter(log_dir=os.path.join(
                hparams.out_dir, hparams.model_name, "tensorboard"))
            self.summary_writer.add_text("hparams",
                                         hparams.get_debug_string())
        except (ImportError, OSError) as e:
            logger.warning("TensorBoard writer unavailable: %s", e)

    def _log_model_summary(self):
        """Parameter shapes and count as TensorBoard text."""
        model = self.model_handler.model
        if model is None or self.summary_writer is None:
            return
        lines, total = [], 0
        for name, p in model.named_parameters():
            lines.append("{}: {} = {}".format(name, tuple(p.shape),
                                              p.numel()))
            total += p.numel()
        lines.append("TOTAL: {} parameters".format(total))
        self.summary_writer.add_text("model_summary", "\n".join(lines))
        logger.info("Model has %d parameters.", total)

    def _log_scalar(self, tag, value, step):
        if self.summary_writer is not None:
            self.summary_writer.add_scalar(tag, value, step)

    @property
    def is_writer(self):
        """True on the process that writes files and logs results: rank 0
        of a data-parallel group, or the only one."""
        return self.rank == 0

    def _log(self, message, *args):
        """Log a result, on the writing rank only."""
        if self.is_writer:
            logger.info(message, *args)

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
        if dataset_type in ("WindowingDatareadersDataset",
                            "PyTorchWindowingDatareadersDataset"):
            cls = WindowingDatareadersDataset
        else:
            cls = DatareadersDataset
        # Data-parallel ranks must build the same batches, crops included.
        rng = random.Random(hparams.get("seed")) if self.data_parallel \
            else None
        self.dataset_train = cls(self.id_list_train, readers, rng=rng)
        self.dataset_val = cls(self.id_list_val, readers,
                               random_select=False)
        self.dataset_test = cls(self.id_list_test, readers,
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
        producer error is re-raised to the consumer.  A dataset with
        ``work_items`` (the windowing dataset: one item per window) is
        batched over its items.  Traced: ``loader.collate`` a batch (on
        the producing thread) and ``loader.wait`` a hand-over (on the
        consumer's)."""
        if hasattr(dataset, "work_items"):
            ids = list(dataset.work_items(id_list))
            fetch = dataset.get_work_item
        else:
            ids = list(id_list)
            fetch = dataset.get_id_name
        if shuffle:
            random.Random(seed).shuffle(ids)

        def produce():
            for start in range(0, len(ids), batch_size):
                chunk = ids[start:start + batch_size]
                with tracing.span("loader.collate") as span:
                    batch = collate_batch([fetch(i)[0] for i in chunk])
                    if tracing.enabled():
                        span.set(**batch_shape(batch))
                yield batch

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

        thread = threading.Thread(target=worker, daemon=True,
                                  name="loader")
        thread.start()
        try:
            while True:
                with tracing.span("loader.wait"):
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
        final-model policy.  Returns (validation losses, train losses).
        With ``hparams.profiler_dir`` the whole run is traced by
        ``torch.profiler`` (host, and the card where there is one) and
        the Chrome trace written into that directory."""
        hparams.verify()
        profiler_dir = hparams.get("profiler_dir")
        if not profiler_dir:
            return self._train_epochs(hparams)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.model_handler.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(profiler_dir, exist_ok=True)
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    profiler_dir)):
            return self._train_epochs(hparams)

    def _train_epochs(self, hparams):
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
            self._log("Pre-training validation loss: %f", loss)
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
            self._log("Epoch %d train loss: %f", self.total_epoch,
                      train_loss)
            self._log_scalar("loss/train", train_loss, self.total_epoch)
            for name, value in per_loss.items():
                self._log_scalar("loss/train_" + name, value,
                                 self.total_epoch)
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
                self._log("Epoch %d validation loss: %f",
                          self.total_epoch, val_loss)
                self._log_scalar("loss/val", val_loss, self.total_epoch)
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
                self._log("Reloaded best model (loss %s)", self.best_loss)
            except FileNotFoundError:
                pass
        if hparams.get("save_final_model") and hparams.get("out_dir"):
            self._save(hparams, last=True)
        self._log("Training took %.1f s", time.time() - t_start)
        return all_loss, all_loss_train

    def _save(self, hparams, epoch=None, best=False, last=False):
        if not hparams.get("out_dir"):
            return
        self.save_checkpoint(hparams, epoch=epoch, best=best, last=last)

    def test(self, hparams, id_list=None):
        ids = id_list or self.id_list_test
        loss, _ = self.model_handler.process_batches(
            self._batches(self.dataset_test or self.dataset_train, ids,
                          hparams.get("batch_size_test", 48)),
            training=False)
        self._log("Test loss: %f", loss)
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
        """A figure of each utterance's post-processed outputs (the task
        trainer's ``gen_figure_from_output``); returns the file paths."""
        results = self._forward_batched(
            hparams, self._input_to_str_list(id_list),
            hparams.get("batch_size_gen_figure", 48))
        if not self.is_writer:
            return []
        return [self.gen_figure_from_output(id_name, sample, hparams)
                for id_name, sample in results.items()]

    def gen_figure_from_output(self, id_name, sample, hparams):
        """The default figure, one grid per feature: wide 2-D features
        as spectrogram-style images, narrow ones as one curve a column,
        1-D ones as one curve; binary-looking columns as shaded areas.
        Written to ``<synth_dir or out_dir>/<id><gen_figure_ext>``."""
        from idiaptts_torch.utils.plotter import DataPlotter
        path = _figure_path(id_name, hparams)
        grid = 0
        with DataPlotter() as plotter:
            plotter.set_title("{} - {}".format(
                id_name, os.path.basename(hparams.get("model_name") or "")))
            for key, value in sorted(sample.items()):
                if not isinstance(value, np.ndarray) or value.size == 0 \
                        or np.iscomplexobj(value):
                    continue
                if value.ndim == 1:
                    value = value[:, None]
                if value.ndim != 2:
                    continue
                if value.shape[1] > 4:
                    # Wide feature: image view of (T, bins), transposed
                    # only when the array looks bins-major.
                    plotter.set_spec_data(grid, value
                                          if value.shape[0] > value.shape[1]
                                          else value.T, label=key)
                    grid += 1
                    continue
                curves, areas = [], []
                for col in range(value.shape[1]):
                    column = value[:, col]
                    name = key if value.shape[1] == 1 \
                        else "{}[{}]".format(key, col)
                    if np.isin(np.round(column), (0.0, 1.0)).all():
                        areas.append((np.round(column), "gray", 0.2, name))
                    else:
                        curves.append((column, name))
                if areas:
                    plotter.set_area_list(grid, areas)
                if curves:
                    plotter.set_data_list(grid, curves)
                if curves or areas:
                    plotter.set_label(grid, xlabel="frames", ylabel=key)
                    grid += 1
            if grid:
                plotter.gen_plot()
                plotter.save_to_file(path)
        return path

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

    def _get_loss_names(self):
        return next((list(store[0][0]) for store in
                     (self.train_losses, self.validation_losses) if store),
                    None)

    def get_losses(self, start_epoch=-1):
        """({loss_name: array}, {loss_name: array}) for train and val."""
        names = self._get_loss_names()
        if names is None:
            return None, None
        train = {n: np.array([d[n] for d, e in self.train_losses
                              if e >= start_epoch and n in d])
                 for n in names}
        val = {n: np.array([d[n] for d, e in self.validation_losses
                            if e >= start_epoch and n in d])
               for n in names}
        return train, val

    def log_losses(self, start_epoch=-1):
        train, val = self.get_losses(start_epoch)
        if train is None:
            return
        for name in train:
            self._log("Loss %s validation progress: %s", name,
                      ", ".join("{:.4f}".format(v)
                                for v in val.get(name, [])))
            self._log("Loss %s train progress: %s", name,
                      ", ".join("{:.4f}".format(v) for v in train[name]))

    def reset_best_loss(self):
        self.best_loss = np.inf

    def get_model_path(self, hparams):
        if hparams.get("out_dir") and hparams.get("model_name"):
            return os.path.join(hparams.out_dir, hparams.model_name,
                                hparams.get("networks_dir", "nn"))
        return None

    def save_checkpoint(self, hparams, epoch=None, best=False, last=False):
        """Write a checkpoint (rank 0 of a data-parallel group, between
        two barriers, so no rank reads it half written; under tensor
        parallelism every rank gathers and rank 0 writes); returns its
        directory."""
        self._barrier()
        path = self.get_model_path(hparams)
        if self.is_writer or getattr(self.model_handler,
                                         "tensor_parallel", False):
            path = self.model_handler.save_checkpoint(
                hparams.out_dir, hparams.model_name, epoch=epoch, best=best,
                last=last, best_loss=self.best_loss,
                networks_dir=hparams.get("networks_dir", "nn"))
        self._barrier()
        return path

    def _barrier(self):
        mesh = self.model_handler.mesh
        if mesh is not None and mesh.distributed:
            torch.distributed.barrier()

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

    # -- reference-surface helpers ------------------------------------------
    def sanity_check_train(self, hparams):
        """Pre-training checks: the hparams verify, and a warning where
        validation and the scheduler's epochs disagree."""
        assert self.model_handler is not None, \
            "The init function has not been called before training."
        hparams.verify()
        eps = hparams.get("epochs_per_scheduler_step")
        ept = hparams.get("epochs_per_test", 1)
        if eps:
            if ept > eps:
                logger.warning("Model is validated only every %d epochs but "
                               "scheduler runs every %d.", ept, eps)
            if ept % eps != 0:
                logger.warning("epochs_per_test %% "
                               "epochs_per_scheduler_step != 0.")

    def log_validation_set(self):
        if self.id_list_val:
            logger.info("Validation set (%d): %s", len(self.id_list_val),
                        self.id_list_to_str(sorted(self.id_list_val)))

    def log_test_set(self):
        if self.id_list_test:
            logger.info("Test set (%d): %s", len(self.id_list_test),
                        self.id_list_to_str(sorted(self.id_list_test)))

    def log_memory(self):
        logger.info("CPU RSS: %.0f MB", get_memory_usage_mb())
        stats = get_device_memory_stats()
        if stats:
            logger.info("Device memory: %s", stats)

    def get_labels(self, reader_name, id_name):
        return self.datareaders[reader_name].load(id_name)

    def gen_output(self, hparams, id_list, post_processing_mapping=None):
        """Forward and save each utterance's post-processed outputs as
        ``<save_output_dir or out_dir/output>/<id>.npz``, one member per
        output name (the names of ``post_processing_mapping``, or every
        output without one); returns the forward's results."""
        mapping = post_processing_mapping \
            or getattr(self, "post_processing_mapping", {}) or {}
        results = self.forward(hparams, list(id_list))
        out_dir = hparams.get("save_output_dir") \
            or os.path.join(hparams.get("out_dir") or ".", "output")
        os.makedirs(out_dir, exist_ok=True)
        for id_name, sample in results.items():
            if isinstance(sample, np.ndarray):
                # A task trainer's forward may return bare arrays.
                np.savez(os.path.join(out_dir, id_name + ".npz"),
                         **{next(iter(mapping), "output"): sample})
                continue
            arrays = {name: np.asarray(sample[name])
                      for name in (mapping or sample) if name in sample}
            if arrays:
                np.savez(os.path.join(out_dir, id_name + ".npz"), **arrays)
        return results

    @staticmethod
    def plot1d(data, path, title=""):
        """A one-curve figure of ``data`` (flattened) at ``path``."""
        from idiaptts_torch.utils.plotter import DataPlotter
        with DataPlotter() as plotter:
            plotter.set_data_list(0, [(np.asarray(data).reshape(-1),
                                       title or "data")])
            plotter.gen_plot()
            plotter.save_to_file(path)
        return path

    @staticmethod
    def plot_specshow(spec, path, title=""):
        """An image figure of a (T, bins) spectrogram at ``path``."""
        from idiaptts_torch.utils.plotter import DataPlotter
        with DataPlotter() as plotter:
            plotter.set_spec_data(0, np.asarray(spec), label=title or "spec")
            plotter.gen_plot()
            plotter.save_to_file(path)
        return path


def _data_parallel(hparams):
    """Whether ``hparams`` ask for training over a process group (data or
    tensor parallel).  Tensor parallelism without a launched group (no
    torchrun environment) raises ``ValueError``, as a mesh that
    ``model_parallel`` does not divide does."""
    model_parallel = hparams.get("model_parallel", 1) or 1
    if model_parallel > 1 and not torch.distributed.is_initialized() \
            and "WORLD_SIZE" not in os.environ:
        raise ValueError(
            "model_parallel={} needs a group of a multiple of {} ranks: "
            "launch with torchrun --nproc_per_node=N and "
            "hparams.num_devices=N".format(model_parallel, model_parallel))
    return (hparams.get("num_devices", 1) or 1) > 1 \
        or model_parallel > 1 or bool(hparams.get("distributed_run"))


def _figure_path(id_name, hparams):
    """``<synth_dir or out_dir or .>/<id_name><gen_figure_ext>``, its
    directory created."""
    out_dir = hparams.get("synth_dir") or hparams.get("out_dir") or "."
    path = os.path.join(out_dir, "{}{}".format(
        id_name, hparams.get("gen_figure_ext", ".pdf")))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return path


def _inference_clone(reader):
    """Shallow copy of a reader for inference datasets: ``match_length``
    cleared (partners may be absent) and ``max_frames`` cleared (training
    crops must not cut synthesis or benchmark inputs)."""
    clone = copy.copy(reader)
    clone.match_length = None
    clone.max_frames = None
    return clone
