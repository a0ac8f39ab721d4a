"""Typed hyper-parameter container: the port's copy of
``idiaptts_tpu/hparams.py``.

A flat typed key/value store where

* adding a key twice raises, setting an undeclared key raises,
* values are type-checked against the type used at declaration,
* ``parse("key=value,list=[1,2]")`` overrides from a CLI-style string,
* ``override_from_hparam`` merges another instance,
* ``verify()`` sanity-checks interdependent keys,
* per-trainer ``create_hparams`` classmethods extend the default set.

The default set is the JAX package's plus ``device`` (``"cuda"``; raises
without CUDA unless set to ``"cpu"``) and ``bf16_residuals`` (the BiLSTM
training residuals' type: by default bf16 above 32 rows a rank, as the
JAX handler chooses, and float32 otherwise; True or False overrides).
Its mesh keys load with the JAX defaults: ``num_devices`` > 1 (or
``distributed_run``) trains data-parallel over ``torch.distributed``,
``data_axis`` names the data axis, ``model_parallel`` > 1 (tensor
parallelism) raises ``NotImplementedError``, and ``use_shard_map`` and
``mesh_shape`` are accepted and have no effect in the port.
"""

import ast
import copy
import json
import logging

logger = logging.getLogger(__name__)

_SENTINEL = object()


class ExtendedHParams:
    """Flat typed hyper-parameter store."""

    def __init__(self, **kwargs):
        # Bypass __setattr__ guard for internal dicts.
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_types", {})
        for name, value in kwargs.items():
            self.add_hparam(name, value)

    # -- declaration ----------------------------------------------------
    def add_hparam(self, name, value):
        if name in self._values:
            raise ValueError("Hyper-parameter name is reserved: %s" % name)
        self._set(name, value, declare=True)

    def add_hparams(self, **kwargs):
        for name, value in kwargs.items():
            self.add_hparam(name, value)

    def del_hparam(self, name):
        self._values.pop(name, None)
        self._types.pop(name, None)

    def has_value(self, name):
        return name in self._values and self._values[name] is not None

    # Tri-state switches: declared as the string "auto" but legitimately
    # set to True/False.
    _TRISTATE = frozenset({"use_shard_map"})

    def _set(self, name, value, declare=False):
        if not declare:
            expected = self._types.get(name)
            if (expected is not None and value is not None
                    and not isinstance(value, expected)):
                # ints are acceptable where floats are declared.
                if expected is float and isinstance(value, int):
                    value = float(value)
                elif expected is list and isinstance(value, tuple):
                    value = list(value)
                elif name in self._TRISTATE and isinstance(value, bool):
                    pass
                else:
                    raise ValueError(
                        "Must pass %s for hparam '%s', got %s"
                        % (expected.__name__, name, type(value).__name__))
        self._values[name] = value
        if value is not None:
            self._types[name] = type(value)

    # -- attribute access ----------------------------------------------
    def __getattr__(self, name):
        # Only called when normal lookup fails.
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError("Unknown hyper-parameter: %s" % name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        if name not in self._values:
            raise ValueError(
                "Hyper-parameter %s does not exist; use add_hparam/setattr_"
                % name)
        self._set(name, value)

    def setattr_no_type_check(self, name, value):
        self._values[name] = value
        if value is not None:
            self._types[name] = type(value)

    def get(self, name, default=None):
        return self._values.get(name, default)

    def set_hparam(self, name, value):
        """Typed overwrite of an existing key
        (ExtendedHParams.py:29-43 role)."""
        if name not in self._values:
            raise ValueError("Unknown hyper-parameter: %s" % name)
        self._set(name, value)

    def get_value(self, attribute, default):
        """``get`` under the reference's name: ``default`` also where the
        key holds None."""
        return self._values[attribute] \
            if self.has_value(attribute) else default

    def enable_backwards_compatibility(self):
        """Fold legacy key spellings into their current homes:
        ``learning_rate`` seeds ``optimiser_args['lr']``; with
        ``load_from_checkpoint`` the first of ``checkpoint_epoch``,
        ``checkpoint_step``, ``load_checkpoint_epoch`` and
        ``load_checkpoint_step`` becomes ``epoch_to_load`` or
        ``step_to_load``; ``epochs_per_checkpoint`` becomes
        ``checkpoint_epoch_interval``."""
        opt_args = self.get("optimiser_args")
        if isinstance(opt_args, dict) and "lr" not in opt_args \
                and self.has_value("learning_rate"):
            opt_args["lr"] = self.get("learning_rate")
        if self.get("load_from_checkpoint"):
            for old, new in (("checkpoint_epoch", "epoch_to_load"),
                             ("checkpoint_step", "step_to_load"),
                             ("load_checkpoint_epoch", "epoch_to_load"),
                             ("load_checkpoint_step", "step_to_load")):
                if self.has_value(old):
                    logger.warning("hparams.%s is deprecated; use %s.",
                                   old, new)
                    self.setattr_no_type_check(new, self.get(old))
                    self.del_hparam(old)
                    break
        if self.has_value("epochs_per_checkpoint"):
            logger.warning("hparams.epochs_per_checkpoint is the reference "
                           "spelling; mapped to checkpoint_epoch_interval.")
            self.set_hparam("checkpoint_epoch_interval",
                            self.get("epochs_per_checkpoint"))
            self.del_hparam("epochs_per_checkpoint")

    def values(self):
        return dict(self._values)

    def __contains__(self, name):
        return name in self._values

    def __repr__(self):
        return "ExtendedHParams(%s)" % json.dumps(
            {k: repr(v) for k, v in sorted(self._values.items())}, indent=2)

    def get_debug_string(self):
        return "\n".join("%s: %r" % (k, v)
                         for k, v in sorted(self._values.items()))

    # -- overriding -----------------------------------------------------
    def parse(self, values_string):
        """Parse ``name=value,name2=[1,2]`` overrides (TF HParams style)."""
        if not values_string:
            return self
        entries = self._split_top_level(values_string)
        for entry in entries:
            if not entry.strip():
                continue
            name, _, raw = entry.partition("=")
            name = name.strip()
            raw = raw.strip()
            if name not in self._values:
                raise ValueError("Unknown hyper-parameter: %s" % name)
            expected = self._types.get(name)
            self._set(name, self._parse_value(raw, expected))
        return self

    @staticmethod
    def _split_top_level(string):
        parts, depth, current = [], 0, []
        for ch in string:
            if ch in "[({":
                depth += 1
            elif ch in "])}":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append("".join(current))
                current = []
            else:
                current.append(ch)
        parts.append("".join(current))
        return parts

    @staticmethod
    def _parse_value(raw, expected):
        if raw in ("None", "null"):
            return None
        if expected is bool or raw in ("True", "False", "true", "false"):
            return raw in ("True", "true", "1")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        if expected is not None and not isinstance(value, expected):
            try:
                value = expected(value)
            except (TypeError, ValueError):
                pass
        return value

    def override_from_dict(self, dictionary):
        for name, value in dictionary.items():
            if name in self._values:
                self._set(name, value)
            else:
                self.add_hparam(name, value)
        return self

    def override_from_hparam(self, other):
        return self.override_from_dict(other._values)

    def copy(self):
        new = ExtendedHParams()
        object.__setattr__(new, "_values", copy.deepcopy(self._values))
        object.__setattr__(new, "_types", dict(self._types))
        return new

    # -- verification ---------------------------------------------------
    def verify(self):
        known = set(self._values)
        for name in ("batch_size_train", "batch_size_val", "batch_size_test"):
            if name in known and self._values[name] is not None \
                    and self._values[name] <= 0:
                raise ValueError("%s must be positive." % name)
        if self.get("epochs") is not None and self.get("epochs") < 0:
            raise ValueError("epochs must be >= 0.")
        if self.get("use_best_as_final_model") \
                and self.get("epochs_per_test", 1) > self.get("epochs", 1) \
                and self.get("epochs", 0) > 0:
            logger.warning("epochs_per_test > epochs: best model will be the "
                           "initial/last test, not a mid-training optimum.")
        return True

    # -- defaults --------------------------------------------------------
    @staticmethod
    def create_hparams(hparams_string=None, verbose=False):
        """Default hyper-parameter set.

        The JAX package's keys plus ``device`` and ``bf16_residuals``.
        """
        hparams = ExtendedHParams()
        hparams.add_hparams(
            # -- general --------------------------------------------------
            voice=None,
            work_dir=None,
            data_dir=None,
            logging_batch_index_perc=10,
            start_with_test=True,
            log_memory_consumption=True,
            epochs_per_test=1,
            networks_dir="nn",
            checkpoints_dir=None,
            synth_dir=None,
            out_dir=None,
            model_name=None,
            model_type=None,
            model_config=None,
            # -- device --------------------------------------------------
            use_gpu=False,           # kept for API compat
            num_devices=1,           # > 1: data-parallel ranks
            model_parallel=1,        # > 1: tensor-parallel model groups
            use_shard_map="auto",    # accepted; no effect in the port
            mesh_shape=None,         # accepted; no effect in the port
            data_axis="data",
            device="cuda",           # where the model trains and infers
            # BiLSTM training residuals in bf16: None follows the JAX
            # handler (bf16 above 32 batch rows), True/False override it.
            bf16_residuals=None,
            dtype="float32",         # parameter dtype
            compute_dtype="bfloat16",
            num_coded_sps=60,
            mgc_alpha=None,          # warping override (Merlin 0.58@16k)
            seed=1234,
            fp16_run=False,
            distributed_run=False,
            # -- data -----------------------------------------------------
            dataset_type="DatareadersDataset",
            dataset_num_workers_gpu=4,
            dataset_num_workers_cpu=0,
            dataset_pin_memory=True,
            dataset_load_async=True,
            teacher_forcing_in_test=False,
            input_norm_params_file_prefix=None,
            output_norm_params_file_prefix=None,
            len_in_out_multiplier=1,
            max_frames_per_batch=None,
            bucket_boundaries=None,  # padded-length buckets of collate
            # -- training -------------------------------------------------
            batch_size_train=1,
            batch_size_benchmark=48,
            batch_size_val=48,
            batch_size_test=48,
            batch_size_gen_figure=48,
            batch_size_synth=12,
            use_saved_learning_rate=True,
            learning_rate=None,
            optimiser_type="Adam",
            optimiser_args={},
            optimiser=None,
            frozen_layers=[],
            replace_inf_grads_by_zero=False,
            ema_decay=None,
            exponential_moving_average=False,
            exponential_moving_average_decay=0.9999,
            start_epoch=None,
            epochs=0,
            iterations=None,
            grad_clip_norm_type=None,
            grad_clip_max_norm=None,
            grad_clip_thresh=None,
            backward_retain_graph=False,
            scheduler_type="default",
            scheduler_args={},
            scheduler=None,
            iterations_per_scheduler_step=None,
            epochs_per_scheduler_step=None,
            use_best_as_final_model=True,
            load_newest_checkpoint=False,
            load_from_checkpoint=False,
            load_optimiser=True,
            load_scheduler=True,
            ignore_layers=[],
            layer_map=[],
            test_set_perc=0.05,
            val_set_perc=0.05,
            loss_per_sample=False,
            # -- synthesis ------------------------------------------------
            synth_vocoder="WORLD",
            synth_ext="wav",
            synth_fs=16000,
            frame_size_ms=5,
            sp_type="mcep",
            preemphasis=0.0,
            do_post_filtering=False,
            synth_gen_figure=False,
            synth_acoustic_model_path=None,
            epoch_to_load=None,
            step_to_load=None,
            gen_figure_ext=".pdf",
            num_speakers=1,
            speaker_id=None,
            has_deltas=True,
            world_dir=None,
            save_final_model=True,
            checkpoint_epoch_interval=1,
            use_saved_mean_std=True,
            profiler_dir=None,
            # -- loss routing / shuffling (reference parity) --------------
            backprop_loss_names=None,   # subset of losses to optimise
            scheduler_loss_names=None,  # subset driving Plateau metric
            shuffle_train_set=True,
            shuffle_val_set=False,
            synth_file_suffix="",
        )
        if hparams_string:
            hparams.parse(hparams_string)
        if verbose:
            logging.getLogger(__name__).info(
                "Final parsed hparams: %s", hparams.get_debug_string())
        return hparams
