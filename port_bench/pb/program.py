"""The system under test, built from a configuration file through the
port's own front doors: ``convert_legacy_string`` (the model string),
``FusedAcousticPipeline`` (as ``AcousticModelTrainer.build_serving``
builds it: the model forward, denormalisation, MLPG, the WORLD
vocoder), ``SynthesisServer`` and ``ModularModelHandler`` (masked
per-frame MSE, Adam).  The benchmark's seeded weights are loaded into
the program's modules by name."""

import numpy as np

# The program's modules wrap the model in a NamedForwardWrapper, whose
# state-dict keys carry this prefix.
_WRAPPED = "wrapped."


def model_config(config):
    from idiaptts_torch.models.rnn_dyn import convert_legacy_string
    cfg = convert_legacy_string(config["model"], int(config["d_in"]))
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred",)
    return cfg


def load_weights(torch, module, weights):
    """Copy the benchmark's weights into ``module``; every parameter and
    buffer must be named and shaped as the configuration's layout."""
    state = module.state_dict()
    names = {k[len(_WRAPPED):] if k.startswith(_WRAPPED) else k: k
             for k in state}
    if set(names) != set(weights):
        raise ValueError("the program's parameters {} differ from the "
                         "configuration's layout {}".format(
                             sorted(set(names) ^ set(weights))[:8],
                             len(weights)))
    for name, key in names.items():
        if tuple(state[key].shape) != tuple(weights[name].shape):
            raise ValueError("{}: program shape {} != layout {}".format(
                name, tuple(state[key].shape), tuple(weights[name].shape)))
    with torch.no_grad():
        module.load_state_dict({names[k]: v for k, v in weights.items()})


def build_model(torch, config, weights, device):
    model = model_config(config).create_model(
        torch.Generator().manual_seed(0)).to(device)
    load_weights(torch, model, weights)
    return model.eval()


def build_pipeline(config, device):
    """The serving pipeline of the configuration's deployment."""
    from idiaptts_torch.synth.pipeline import FusedAcousticPipeline
    norm = config["normalisation"]
    variances = {k: np.asarray(v, np.float32)
                 for k, v in config["mlpg_variances"].items()}

    def model_apply(params, questions_b, lengths_b):
        return params({"questions": questions_b}, lengths=lengths_b,
                      training=False)["pred"]

    return FusedAcousticPipeline(
        model_apply, variances, num_coded_sps=int(config["num_coded_sps"]),
        fs=int(config["fs"]), frame_shift_ms=float(config["frame_shift_ms"]),
        num_bap=int(config["num_bap"]), num_bins=int(config["num_bins"]),
        bucket=int(config["bucket"]),
        max_harmonics=int(config["max_harmonics"]),
        mgc_alpha=float(config["mgc_alpha"]),
        mean=np.asarray(norm["mean"], np.float32),
        scale=np.asarray(norm["scale"], np.float32), device=device)


def build_server(pipeline, model):
    """``SynthesisServer`` at its class defaults."""
    from idiaptts_torch.synth.server import SynthesisServer
    return SynthesisServer(pipeline, model)


def build_handler(torch, config, weights, device, learning_rate,
                  phase=lambda name: None):
    """A ``ModularModelHandler`` with the configuration's model, the
    benchmark's weights, Adam and the masked per-frame MSE; ``phase``
    is called with a name at the end of each step.  (The first optimiser
    a process builds imports ``torch._dynamo``.)"""
    from idiaptts_torch.hparams import ExtendedHParams
    from idiaptts_torch.models.losses import NamedLoss
    from idiaptts_torch.train.handler import ModularModelHandler
    handler = ModularModelHandler(device=device)
    handler.create_model(model_config(config))
    load_weights(torch, handler.model, weights)
    phase("model")
    hp = ExtendedHParams.create_hparams()
    hp.learning_rate = float(learning_rate)
    handler.set_optimiser(hp)
    phase("optimiser")
    handler.set_losses([NamedLoss.Config(
        "mse", "MSELoss", ("pred", "target"), seq_mask="_seq_mask",
        reduction="mean_per_frame")])
    return handler


def trainer_batches(dataset, ids, batch_size, seed):
    """The trainer's feed for one epoch: ``ModularTrainer._batches`` (its
    prefetch thread and ``collate_batch``), shuffled with ``seed``.  The
    method reads nothing of the trainer itself."""
    from idiaptts_torch.train.trainer import ModularTrainer
    return ModularTrainer._batches(None, dataset, ids, batch_size,
                                 shuffle=True, seed=seed)


def kernel_library():
    """Build (first run in a checkout) or load the hand kernels."""
    from idiaptts_torch.ops import dispatch
    dispatch.library()
    return dispatch.build_info


def join_group(torch, url, world, rank, device):
    """Join the data-parallel group the program's way (NCCL one card a
    rank, gloo on the CPU); returns the program's mesh."""
    from idiaptts_torch.parallel import mesh as mesh_lib
    backend = "nccl" if device.type == "cuda" else "gloo"
    return mesh_lib.initialise_multihost(url, world, rank, backend=backend,
                                         device=device)
